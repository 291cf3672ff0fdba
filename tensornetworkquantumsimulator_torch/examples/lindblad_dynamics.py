"""Continuous-time open-system (Lindblad) dynamics by Trotterized channels.

The port of ``examples/lindblad_dynamics.py``.  dρ/dt = −i[H, ρ] + Σ_v γ
D[σ⁻_v](ρ) + Σ_v κ D[σ_z_v](ρ) integrates as a first-order product
formula: one unitary TFIM Trotter layer (angle ∝ dt) followed by per-site
amplitude damping (γ·dt) and dephasing (2κ·dt), in the density-matrix
picture.

    python -m tensornetworkquantumsimulator_torch.examples.lindblad_dynamics
"""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    apply_circuit,
    density_matrix_tensornetworkstate,
    edge_color,
    named_grid,
    pauli_expectation,
    purity,
)
from tensornetworkquantumsimulator_torch.examples import cli, on_device, table


def lindblad_layer(g, dt, h=1.0, J=1.0, gamma=0.15, kappa=0.05):
    """One first-order Trotter step of the dissipative TFIM."""
    layer = [("Rx", [v], 2 * h * dt) for v in g.vertices()]
    for group in edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    layer += [("amplitude_damping", [v], 1 - np.exp(-gamma * dt))
              for v in g.vertices()]
    # dephasing channel (1−2p) = e^{−2κ dt} ⇒ p = (1−e^{−2κ dt})/2
    layer += [("dephasing", [v], (1 - np.exp(-2 * kappa * dt)) / 2)
              for v in g.vertices()]
    return layer


def main(nx=4, ny=4, t_final=1.0, dt=0.05, chi=8, device=None):
    """Truncating a density-matrix network is not positivity-preserving:
    once the operator-space entanglement exceeds χ the evolution breaks
    down abruptly rather than degrading gracefully.  The per-layer max
    truncation error (printed below) is the early-warning signal; raise χ
    (or shorten t) when it grows."""
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        layer = lindblad_layer(g, dt)
        rho = density_matrix_tensornetworkstate(torch.float64, lambda v: "0",
                                                g, device=dev)
        obs = [("Z", [v]) for v in g.vertices()]
        steps = int(round(t_final / dt))
        print("t      <Z>_mean    purity      max_trunc_err")
        max_err = 0.0
        for s in range(steps):
            rho, errs = apply_circuit(
                layer, rho,
                apply_kwargs=dict(maxdim=chi, cutoff=1e-12,
                                  normalize_tensors=False),
            )
            max_err = max(max_err, max((float(e) for e in errs), default=0.0))
            if (s + 1) % max(1, steps // 5) == 0:
                z = np.real(pauli_expectation(rho, obs, alg="bp"))
                print(f"{(s + 1) * dt:5.2f}  {np.mean(z):+.6f}  "
                      f"{purity(rho, alg='bp'):.6f}  {max_err:.3e}")
                max_err = 0.0
        return rho


def read(text) -> dict:
    """The printed table: per row t, ⟨Z⟩ mean, purity and the largest
    truncation error since the row before."""
    return dict(table=table(text, 4))


if __name__ == "__main__":
    cli(main)
