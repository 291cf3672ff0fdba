"""2D transverse-field Ising dynamics on a 5x5 grid.

The port of ``examples/ising_2d_dynamics.py``: Trotterized TFIM layer (Rx,
Rz, edge-colored Rzz), simple-update evolution with BP environments,
per-layer truncation errors, BP and boundary-MPS ⟨Z⟩ at the center site.
Runs on the batched engine with the generic engine as the measurement
backend.
"""

import time

import torch

from tensornetworkquantumsimulator_torch import (
    edge_color,
    expect,
    named_grid,
    op_matrix,
    siteinds,
)
from tensornetworkquantumsimulator_torch.examples import (
    NUMBER,
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_product_state,
    batched_to_tns,
    make_expectation_fn,
    make_layer_fn,
)


def tfim_layer(g, dt=0.25, hx=1.0, hz=0.8, J=0.5):
    """One Trotter layer: Rx and Rz on every site, then Rzz by colour."""
    layer = []
    layer += [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for colored_edges in edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in colored_edges]
    return layer


def main(nl=20, nx=5, ny=5, chi=5, mps_bond_dimension=4, device=None):
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        layer = tfim_layer(g)

        spec, state = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=dev)
        circuit = BatchedCircuit(layer, g, spec=spec)
        layer_fn = make_layer_fn(circuit, chi=chi, cutoff=1e-10, device=dev)
        z_fn = make_expectation_fn(spec, op_matrix("Z", 2), real_output=True)
        obs_pos = spec.vertex_position((3, 3))

        for l in range(1, nl + 1):
            t0 = time.perf_counter()
            state, errors = layer_fn(state)
            z_host = z_fn(state).cpu().numpy()
            errs_host = errors.cpu().numpy()
            t1 = time.perf_counter() - t0
            print(f"Layer {l}")
            print(f"    Took time: {t1:.4f} [s]")
            print(f"    Maximum Gate error for layer was "
                  f"{errs_host.max():.3e}")
            print(f"    BP Measured Sigmaz is {z_host[obs_pos]:.6f}")

        # boundary-MPS measurement through the generic engine
        psi = batched_to_tns(spec, state, g, siteinds("S=1/2", g))
        sz_bmps = expect(psi, ("Z", [(3, 3)]), alg="boundarymps",
                         mps_bond_dimension=mps_bond_dimension)
        print(f"Boundary MPS Measured Sigmaz is {complex(sz_bmps):.6f}")


def read(text) -> dict:
    """The printed numbers: per layer the largest gate error ``err`` and BP
    ⟨Z⟩ ``z``, then the boundary-MPS ⟨Z⟩ ``bmps`` (one value)."""
    return dict(
        err=numbers(r"Maximum Gate error for layer was (\S+)", text),
        z=numbers(r"BP Measured Sigmaz is (\S+)", text),
        bmps=numbers(r"Boundary MPS Measured Sigmaz is " + NUMBER, text))


if __name__ == "__main__":
    cli(main)
