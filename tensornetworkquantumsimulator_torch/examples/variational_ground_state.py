"""Gradient-based variational ground-state search for the 2D TFIM.

The port of ``examples/variational_ground_state.py``.  Direct energy
minimization: Adam steps on the PEPS vertex tensors against the BP energy
functional, with reverse-mode autodiff flowing through the flooding-BP
environment iterations (``parallel/variational.py``).  Compare with
``tfim_ground_state``, which reaches the same state by imaginary-time
TEBD.
"""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    batched_product_state,
    ground_state,
    tfim_hamiltonian,
)
from tensornetworkquantumsimulator_torch.utils import named_grid


def main(nx=3, ny=3, chi=4, hx=3.0, J=1.0, steps=600, lr=3e-2, seed=0,
         device=None):
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        spec, state = batched_product_state(g, chi=chi, dtype=torch.float32,
                                            device=dev)

        # symmetry-breaking noise on the valid block (dummy slots keep bond
        # dimension 1 so the state stays a pure wavefunction)
        rng = np.random.default_rng(seed)
        t = state.tensors.cpu().numpy()
        noise = rng.normal(size=t.shape).astype(t.dtype)
        mask = np.asarray(spec.mask_array())
        for k in range(spec.degree):
            idx = [slice(None)] * t.ndim
            idx[1 + k] = slice(1, None)
            noise[tuple(idx)] *= mask[:, k][(slice(None),)
                                            + (None,) * (t.ndim - 1)]
        state = state._replace(
            tensors=torch.from_numpy(t + 0.1 * noise).to(dev))

        ham = tfim_hamiltonian(J=J, hx=hx)
        state, energies = ground_state(
            spec, state, ham, steps=steps, learning_rate=lr,
            bp_sweeps_per_eval=12, damping=0.1,
        )
        energies = energies.cpu().numpy()
        for s in range(0, steps, max(1, steps // 10)):
            print(f"step {s:5d}: E = {energies[s]:.6f}")
        print(f"final:      E = {energies[-1]:.6f}")
        return float(energies[-1])


def read(text) -> dict:
    """The printed energies: every tenth of the steps (``energy``), then
    the last (``final``)."""
    return dict(energy=numbers(r"step\s+\d+: E = (\S+)", text),
                final=numbers(r"final:\s+E = (\S+)", text))


if __name__ == "__main__":
    cli(main)
