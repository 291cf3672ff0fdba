"""Imaginary-time TEBD ground-state search for the 2D transverse-field Ising
model on the batched engine.

The port of ``examples/tfim_ground_state.py``.  Non-unitary gates flow
through the same simple-update machinery (the BP environments absorb the
normalization); the energy is measured from the BP environments with
``local_expectations`` + ``bond_expectations``.
"""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import op_matrix
from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_product_state,
    bond_expectations,
    bp_update,
    local_expectations,
    make_layer_fn,
)
from tensornetworkquantumsimulator_torch.utils import edge_color, named_grid


def main(nx=3, ny=3, chi=4, hx=3.0, J=1.0, tau=0.05, nsteps=200, device=None):
    """H = -J Σ Z_i Z_j − hx Σ X_i ; imaginary-time Trotter steps
    exp(τ J ZZ) ⊗ exp(τ hx X)."""
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        layer = []
        # Rx(θ=2iτhx) = exp(-i θ/2 X) = exp(τ hx X)  (imaginary time)
        layer += [("Rx", [v], 2j * tau * hx) for v in g.vertices()]
        for group in edge_color(g, 4):
            # Rzz(param=2iτJ): ϕ = param/2, gate = exp(-iϕ ZZ) = exp(τJ ZZ)
            layer += [("Rzz", pair, 2j * tau * J) for pair in group]

        spec, state = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=dev)
        circuit = BatchedCircuit(layer, g, spec=spec)
        layer_fn = make_layer_fn(circuit, chi=chi, cutoff=1e-10, bp_maxiter=30,
                                 device=dev)

        x_op = np.asarray(op_matrix("X", 2))
        z_op = np.asarray(op_matrix("Z", 2))

        def energy(st):
            st = bp_update(spec, st, maxiter=50, tolerance=1e-7)
            ex = local_expectations(spec, st, x_op)
            ezz = bond_expectations(spec, st, z_op, z_op)
            return torch.real(-hx * torch.sum(ex) - J * torch.sum(ezz))

        for step in range(1, nsteps + 1):
            state, _ = layer_fn(state)
            if step % 25 == 0:
                e = float(energy(state))
                print(f"step {step}: E = {e:.6f}")
        return float(energy(state))


def read(text) -> dict:
    """The printed energies, one per 25 steps."""
    return dict(energy=numbers(r"E = (\S+)", text))


if __name__ == "__main__":
    cli(main)
