"""Loschmidt echo L(t) = |⟨ψ₀|ψ(t)⟩|² / (⟨ψ₀|ψ₀⟩⟨ψ(t)|ψ(t)⟩) under a TFIM
quench, on the batched engine: evolution and the sandwich-BP overlap.

The port of ``examples/loschmidt_echo.py``."""

import torch

from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_inner,
    batched_loschmidt_echo,
    batched_product_state,
    make_layer_fn,
)
from tensornetworkquantumsimulator_torch.utils import edge_color, named_grid


def main(steps=8, chi=6, device=None):
    with on_device(device) as dev:
        g = named_grid((4, 4))
        dt, hx, J = 0.15, 1.0, 0.6
        layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
        for group in edge_color(g, 4):
            layer += [("Rzz", pair, 2 * J * dt) for pair in group]

        spec, s0 = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                         device=dev)
        layer_fn = make_layer_fn(BatchedCircuit(layer, g, spec=spec), chi=chi,
                                 device=dev)

        # constant on the trajectory
        log_norm0, _ = batched_inner(spec, s0, s0, maxiter=60)
        st = s0
        for t in range(1, steps + 1):
            st, _ = layer_fn(st)
            log_abs, _phase = batched_loschmidt_echo(
                spec, s0, st, log_norm0=log_norm0, maxiter=60)
            # rate function: -log L / N  (the dynamical free energy density)
            n = spec.num_vertices
            rate = -2.0 * float(log_abs) / n
            print(f"t={t * dt:.2f}  log|echo|={float(log_abs):+.4f}  "
                  f"rate={rate:.5f}")


def read(text) -> dict:
    """The printed numbers, per step: log|echo| and the rate function."""
    return dict(log_echo=numbers(r"log\|echo\|=(\S+)", text),
                rate=numbers(r"rate=(\S+)", text))


if __name__ == "__main__":
    cli(main)
