"""Connected correlation functions C(r) = ⟨Z_0 Z_r⟩ − ⟨Z_0⟩⟨Z_r⟩ during
TFIM quench dynamics, measured on the batched engine at every graph
distance in one call per layer.

The port of ``examples/correlation_functions.py``.  The final layer is
re-measured through the loop-aware boundary-MPS correlator
(``make_grid_bmps_correlations``, same-row and cross-row pairs via
op-inserted strand chains) to show the short-loop contributions BP's tree
approximation misses."""

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
    make_grid_bmps_correlations,
    make_layer_fn,
    make_path_correlation_fn,
)
from tensornetworkquantumsimulator_torch.utils import edge_color, named_grid


def main(steps=6, chi=6, device=None):
    with on_device(device) as dev:
        nx_, ny_ = 5, 5
        g = named_grid((nx_, ny_))
        dt, hx, J = 0.2, 1.0, 0.5
        layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
        for group in edge_color(g, 4):
            layer += [("Rzz", pair, 2 * J * dt) for pair in group]

        spec, state = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=dev)
        circuit = BatchedCircuit(layer, g, spec=spec)
        layer_fn = make_layer_fn(circuit, chi=chi, cutoff=1e-10, device=dev)

        # correlators from the row's first site out to every distance
        # along row 3
        row = [(3, c) for c in range(1, ny_ + 1)]
        origin = row[0]
        pairs = [(origin, v) for v in row[1:]]
        z = np.asarray(op_matrix("Z", 2))
        corr_fn = make_path_correlation_fn(spec, pairs, z, connected=True,
                                           real_output=True)

        for t in range(1, steps + 1):
            state, errs = layer_fn(state)
            c = corr_fn(state).cpu().numpy()
            pretty = "  ".join(f"C({r + 1})={v:+.5f}" for r, v in enumerate(c))
            print(f"layer {t}: max gate err {float(errs.max()):.2e}  {pretty}")

        # loop-aware re-measurement of the final state: the same row pairs
        # plus a cross-row diagonal, through the fitted boundary-MPS strands
        bmps_pairs = pairs + [(origin, (r, 3)) for r in (4, 5)]
        bmps_corr = make_grid_bmps_correlations(
            spec, nx_, ny_, kmps=2 * chi, pairs=bmps_pairs, real_output=True)
        zt = torch.as_tensor(z, device=dev)
        raw = bmps_corr(state.tensors, zt, zt).cpu().numpy()
        labels = [f"{a}-{b}" for a, b in bmps_pairs]
        print("boundary-MPS ⟨ZZ⟩ (loop-aware, incl. cross-row):")
        print("  " + "  ".join(f"{l}={v:+.5f}" for l, v in zip(labels, raw)))


def read(text) -> dict:
    """The printed numbers: per layer the largest gate error ``err`` and
    the connected correlators C(1..4) (``corr``, one row per layer), then
    the boundary-MPS ⟨ZZ⟩ of the six pairs (``bmps``)."""
    layers, _, bmps = text.partition("boundary-MPS")
    return dict(err=numbers(r"max gate err (\S+)", layers),
                corr=numbers(r"C\(\d\)=(\S+)", layers).reshape(-1, 4),
                bmps=numbers(r"\)=([-+][0-9.]+)", bmps))


if __name__ == "__main__":
    cli(main)
