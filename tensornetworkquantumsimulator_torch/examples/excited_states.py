"""Variational ground AND first-excited states of the TFIM by gradient
descent with an overlap penalty (``parallel/variational.py::excited_state``).

The port of ``examples/excited_states.py``.  On a tree the BP energies are
exact, so both optimized levels can be checked against dense
diagonalization: at the default size the optimizer lands E0 and E1 while
the penalty (the normalized overlap with the ground state) converges to
zero."""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    batched_product_state,
    excited_state,
    ground_state,
    tfim_hamiltonian,
)
from tensornetworkquantumsimulator_torch.utils.lattices import named_comb_tree


def _noised(spec, state, eps, seed):
    rng = np.random.default_rng(seed)
    t = state.tensors.cpu().numpy()
    noise = rng.normal(size=t.shape) + 1j * rng.normal(size=t.shape)
    mask = np.asarray(spec.mask_array())
    for k in range(spec.degree):
        idx = [slice(None)] * t.ndim
        idx[1 + k] = slice(1, None)
        noise[tuple(idx)] *= mask[:, k][
            (slice(None),) + (None,) * (t.ndim - 1)
        ]
    return state._replace(tensors=torch.from_numpy(
        (t + eps * noise).astype(t.dtype)).to(state.tensors.device))


def _exact_levels(spec, J, hx, n_levels=3):
    n = spec.num_vertices
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.array([[1.0, 0.0], [0.0, -1.0]])

    def op1(M, i):
        out = np.ones((1, 1))
        for k in range(n):
            out = np.kron(out, M if k == i else np.eye(2))
        return out

    H = np.zeros((2**n, 2**n))
    for i in range(n):
        H -= hx * op1(X, i)
    for (iu, iv, _, _) in spec.edges:
        H -= J * op1(Z, iu) @ op1(Z, iv)
    return np.linalg.eigvalsh(H)[:n_levels]


def main(steps=500, chi=4, device=None):
    with on_device(device) as dev:
        g = named_comb_tree((2, 3))  # 6-site comb tree: BP exact
        J, hx = 1.0, 2.0
        ham = tfim_hamiltonian(J=J, hx=hx)
        spec, s0 = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                         device=dev)

        gs, e_traj = ground_state(
            spec, _noised(spec, s0, 0.3, seed=1), ham, steps=steps,
            learning_rate=3e-2, bp_sweeps_per_eval=12,
        )
        ex, e1_traj, pen_traj = excited_state(
            spec, _noised(spec, s0, 0.3, seed=7), ham, below=[gs],
            weight=20.0, steps=2 * steps, learning_rate=2e-2,
            bp_sweeps_per_eval=12,
        )
        levels = _exact_levels(spec, J, hx)
        print(f"exact:      E0={levels[0]:+.5f}  E1={levels[1]:+.5f}")
        print(f"variational: E0={float(e_traj[-1]):+.5f}  "
              f"E1={float(e1_traj[-1]):+.5f}  "
              f"final penalty={float(pen_traj[-1]):.2e}")
        return (float(e_traj[-1]), float(e1_traj[-1]), float(pen_traj[-1]),
                torch.as_tensor(levels, device=dev))


def read(text) -> dict:
    """The printed numbers: the exact E0, E1, the variational E0, E1 and
    the final penalty."""
    return dict(
        exact=numbers(r"exact:\s+E0=(\S+)", text).tolist()
        + numbers(r"exact:\s+E0=\S+\s+E1=(\S+)", text).tolist(),
        variational=numbers(r"variational: E0=(\S+)", text).tolist()
        + numbers(r"variational: E0=\S+\s+E1=(\S+)", text).tolist(),
        penalty=numbers(r"final penalty=(\S+)", text))


if __name__ == "__main__":
    cli(main)
