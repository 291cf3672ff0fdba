"""Disorder-averaged TFIM dynamics: an ensemble of random-field
realizations evolving in one folded program.

The port of ``examples/disorder_ensemble.py``.  Each realization of the
2D transverse-field Ising model gets its own random longitudinal fields
(per-site Rx angles) and random couplings (per-edge Rzz angles), drawn
with numpy from ``seed``; ``ensemble_fn`` over the parametric field layer
advances all of them per call, and the disorder-averaged magnetization
⟨Z⟩(t) comes off the device as one [layers, E, V] array.

    python -m tensornetworkquantumsimulator_torch.examples.disorder_ensemble
"""

import re

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import named_grid, op_matrix
from tensornetworkquantumsimulator_torch.examples import cli, on_device
from tensornetworkquantumsimulator_torch.parallel import (
    batched_product_state,
    ensemble_fn,
    make_ensemble_expectation_fn,
    make_field_layer_fn,
    stack_states,
)


def main(nx=4, ny=4, chi=4, n_layers=8, n_ensemble=8, dt=0.1, seed=0,
         device=None):
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        spec, s0 = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                         device=dev)
        _, layer = make_field_layer_fn(g, chi=chi, spec=spec, bp_maxiter=20,
                                       device=dev)
        elayer = ensemble_fn(layer)
        expect_z = make_ensemble_expectation_fn(spec, op_matrix("Z", 2),
                                                real_output=True)

        V, E = spec.num_vertices, len(spec.edges)
        rng = np.random.default_rng(seed)
        # random fields h_i ~ U(0.5, 1.5), random couplings J_e ~ U(0.8, 1.2)
        site = torch.as_tensor(2 * dt * rng.uniform(0.5, 1.5, (n_ensemble, V)),
                               dtype=torch.float32, device=dev)
        bond = torch.as_tensor(2 * dt * rng.uniform(0.8, 1.2, (n_ensemble, E)),
                               dtype=torch.float32, device=dev)

        estate = stack_states([s0] * n_ensemble)
        traj = []
        for t in range(n_layers):
            estate, _ = elayer(estate, site, bond)
            traj.append(expect_z(estate))
        traj = torch.stack(traj)  # [layers, E, V]

        zbar = traj.mean(dim=(1, 2))  # disorder+site average per layer
        # realization spread
        zstd = traj.mean(dim=2).std(dim=1, unbiased=False)
        for t, (m, s) in enumerate(zip(zbar.tolist(), zstd.tolist())):
            print(f"layer {t + 1:2d}: <Z> = {m:+.6f}  ± {s:.6f} (over "
                  f"{n_ensemble} realizations)")
        return zbar


def read(text) -> dict:
    """The printed numbers, per layer: the disorder-averaged ⟨Z⟩ ``zbar``
    and its spread over realizations ``zstd``."""
    rows = re.findall(r"layer\s+\d+: <Z> = (\S+)\s+± (\S+)", text)
    zbar, zstd = np.array(rows, dtype=float).reshape(-1, 2).T
    return dict(zbar=zbar, zstd=zstd)


if __name__ == "__main__":
    cli(main)
