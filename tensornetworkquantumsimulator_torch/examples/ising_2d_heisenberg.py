"""Heisenberg-picture Ising dynamics in the Pauli basis.

The port of ``examples/ising_2d_heisenberg.py``: evolve an observable
through the reversed circuit with Pauli-transfer-matrix gates, track its
Frobenius norm and traces."""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    BeliefPropagationCache,
    apply_gates,
    edge_color,
    identitytensornetworkstate,
    inner,
    named_grid,
    paulitensornetworkstate,
)
from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)


def main(no_trotter_steps=5, chi=4, device=None):
    with on_device(device) as dev:
        nx, ny = 4, 4
        g = named_grid((nx, ny))
        vz = g.center()[0]
        # physical indices represent [I, X, Y, Z]
        psi0 = paulitensornetworkstate(
            torch.complex64, lambda v: "Z" if v == vz else "I", g, device=dev)
        psi = psi0.copy()

        h, J, dt = -1.0, -1.0, 0.04
        layer = []
        layer += [("Rz", [v], h * dt) for v in g.vertices()]
        for colored_edges in edge_color(g, 4):
            layer += [("Rxx", pair, 2 * J * dt) for pair in colored_edges]
        layer += [("Rz", [v], h * dt) for v in g.vertices()]
        # Heisenberg picture: the circuit is applied reversed
        layer = list(reversed(layer))

        psi_bpc = BeliefPropagationCache(psi).update()
        for l in range(1, no_trotter_steps + 1):
            psi_bpc, errors = apply_gates(
                layer, psi_bpc,
                apply_kwargs=dict(maxdim=chi, cutoff=1e-12,
                                  normalize_tensors=False),
            )
            psi_bpc = psi_bpc.rescale()
            print(f"Layer {l}")
            norm = psi_bpc.partitionfunction()
            print(f"  Frobenius norm of O(t): {norm:.6f}")
            psi = psi_bpc.network()
            tr_t = inner(psi, identitytensornetworkstate(
                g, psi.siteinds(), device=dev), alg="bp")
            tr_t0 = inner(psi, psi0, alg="bp")
            print(f"  Trace(O(t)):      {tr_t}")
            print(f"  Trace(O(t)O(0)):  {tr_t0}")
            print(f"  Max gate error:   {np.max(errors):.3e}")


def read(text) -> dict:
    """The printed numbers, per step: the Frobenius norm, Tr O(t),
    Tr O(t)O(0) and the largest gate error."""
    return dict(
        norm=numbers(r"Frobenius norm of O\(t\): (\S+)", text),
        trace=numbers(r"Trace\(O\(t\)\):\s+(\S+)", text),
        trace0=numbers(r"Trace\(O\(t\)O\(0\)\):\s+(\S+)", text),
        err=numbers(r"Max gate error:\s+(\S+)", text))


if __name__ == "__main__":
    cli(main)
