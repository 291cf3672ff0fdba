"""Ising dynamics on a 3x3x3 periodic cube.

The port of ``examples/ising_3d_dynamics.py``: 7-way edge coloring, Rz +
Rxx Trotter layers, BP ⟨Z⟩ at the center."""

import time

import torch

from tensornetworkquantumsimulator_torch import (
    edge_color,
    named_grid,
    op_matrix,
)
from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_product_state,
    make_expectation_fn,
    make_layer_fn,
)


def main(no_trotter_steps=10, chi=4, device=None):
    with on_device(device) as dev:
        g = named_grid((3, 3, 3), periodic=True)

        h, J, dt = -1.0, -1.0, 0.04
        layer = []
        layer += [("Rz", [v], h * dt) for v in g.vertices()]
        for colored_edges in edge_color(g, 7):
            layer += [("Rxx", pair, 2 * J * dt) for pair in colored_edges]
        layer += [("Rz", [v], h * dt) for v in g.vertices()]

        spec, state = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=dev)
        circuit = BatchedCircuit(layer, g, spec=spec)
        layer_fn = make_layer_fn(circuit, chi=chi, cutoff=1e-10, device=dev)
        z_fn = make_expectation_fn(spec, op_matrix("Z", 2), real_output=True)
        vc = g.center()[0]
        pos = spec.vertex_position(vc)

        print(f"Initial Sigma Z on centre site: "
              f"{z_fn(state).cpu().numpy()[pos]:.6f}")
        for l in range(1, no_trotter_steps + 1):
            t0 = time.perf_counter()
            state, errors = layer_fn(state)
            z = z_fn(state).cpu().numpy()[pos]
            errs_host = errors.cpu().numpy()
            print(f"Layer {l}: took {time.perf_counter() - t0:.4f}s, "
                  f"max gate error {errs_host.max():.3e}, "
                  f"Sigma z = {z:.6f}")


def read(text) -> dict:
    """The printed numbers: the centre's initial ⟨Z⟩ ``z0``, then per layer
    the largest gate error ``err`` and ⟨Z⟩ ``z``."""
    return dict(z0=numbers(r"Initial Sigma Z on centre site: (\S+)", text),
                err=numbers(r"max gate error (\S+),", text),
                z=numbers(r"Sigma z = (\S+)", text))


if __name__ == "__main__":
    cli(main)
