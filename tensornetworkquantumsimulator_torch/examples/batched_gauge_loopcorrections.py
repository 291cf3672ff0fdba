"""Batched-engine gauge + loop corrections: evolve a TFIM state on the
batched engine, then (a) loop-correct its BP partition function with
batched plaquette transfer chains and (b) Vidal-gauge the whole lattice in
one batched eigh+SVD, reading off every bond's entanglement spectrum.

The port of ``examples/batched_gauge_loopcorrections.py``.  The JAX
example guards two host reads against a runtime that cannot download; the
port reads them directly, and a failure raises.
"""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_loopcorrected_partitionfunction,
    batched_partitionfunction,
    batched_product_state,
    batched_symmetric_gauge,
    bp_update,
    find_plaquettes,
    make_layer_fn,
)
from tensornetworkquantumsimulator_torch.utils import edge_color, named_grid


def main(nl=5, nx=4, ny=4, chi=4, device=None):
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        dt, hx, hz, J = 0.25, 1.0, 0.8, 0.5
        layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
        layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
        for group in edge_color(g, 4):
            layer += [("Rzz", pair, 2 * J * dt) for pair in group]

        spec, state = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=dev)
        circuit = BatchedCircuit(layer, g, spec=spec)
        layer_fn = make_layer_fn(circuit, chi=chi, cutoff=1e-10, jit=True,
                                 device=dev)
        for _ in range(nl):
            state, _errs = layer_fn(state)
        state = bp_update(spec, state, maxiter=50)

        plaquettes = find_plaquettes(spec, g)
        n_plaq = sum(b[1].shape[0] for b in plaquettes)

        zbp = batched_partitionfunction(spec, state)
        zlc = batched_loopcorrected_partitionfunction(spec, state, g,
                                                      plaquettes)
        rel = torch.abs(zlc / zbp - 1.0)
        print(f"{nx}x{ny} TFIM after {nl} layers, chi={chi}: {n_plaq} "
              f"plaquettes")
        print(f"  relative loop correction to Z_BP: {float(rel):.3e}")

        gauged, spectra = batched_symmetric_gauge(spec, state)
        s = spectra.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = -np.sum(
                np.where(s > 1e-12, s**2 * np.log(s**2), 0.0), axis=-1
            ) / np.maximum(np.sum(s**2, axis=-1), 1e-30)
        print(f"  entanglement entropy across bonds: min {ent.min():.4f}, "
              f"max {ent.max():.4f}")


def read(text) -> dict:
    """The printed numbers: the plaquette count, the relative loop
    correction to Z_BP and the least and largest bond entropy."""
    return dict(
        plaquettes=numbers(r"chi=\d+: (\d+) plaquettes", text),
        rel=numbers(r"to Z_BP: (\S+)", text),
        ent=numbers(r"bonds: min (\S+),", text).tolist()
        + numbers(r"bonds: min \S+, max (\S+)", text).tolist())


if __name__ == "__main__":
    cli(main)
