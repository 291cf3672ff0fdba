"""Finite-temperature (thermal) states by imaginary-time evolution in the
density-matrix picture.

The port of ``examples/thermal_states.py``.  ρ(β) ∝ e^{−βH} is reached
from the infinite-temperature state ρ₀ ∝ I by Trotterized imaginary time:
each Hamiltonian term h contributes a non-trace-preserving map ρ → GρG†
with G = e^{−dτ·h} (``("map", verts, imaginary_time_kraus(h, dτ))``), so
one Strang layer advances β by 2dτ.  Measurements are trace ratios
(``pauli_expectation``, ``purity``), so the decaying norm never needs
renormalizing by hand.

    python -m tensornetworkquantumsimulator_torch.examples.thermal_states
"""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    apply_circuit,
    density_matrix_tensornetworkstate,
    edge_color,
    imaginary_time_kraus,
    named_grid,
    pauli_expectation,
    purity,
)
from tensornetworkquantumsimulator_torch.examples import cli, on_device, table

X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])


def thermal_layer(g, dtau, h=1.0, J=1.0):
    """One Strang step of imaginary-time TFIM: X(dτ/2)·ZZ(dτ)·X(dτ/2)."""
    half = [("map", [v], imaginary_time_kraus(-h * X, dtau / 2))
            for v in g.vertices()]
    layer = list(half)
    for group in edge_color(g, 4):
        layer += [("map", pair, imaginary_time_kraus(-J * np.kron(Z, Z), dtau))
                  for pair in group]
    return layer + half


def main(nx=4, ny=4, beta_max=1.6, dtau=0.05, chi=8, h=1.0, J=1.0,
         device=None):
    """Cool a nx×ny TFIM from β=0, printing the energy density, ⟨X⟩, and
    the second Rényi entropy density along the way.  Like any
    density-matrix truncation, large β at small χ loses positivity
    abruptly; watch the truncation errors."""
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        verts = list(g.vertices())
        layer = thermal_layer(g, dtau, h=h, J=J)
        rho = density_matrix_tensornetworkstate(torch.float64,
                                                lambda v: "mixed", g,
                                                device=dev)

        obs_x = [("X", [v]) for v in verts]
        obs_zz = [("ZZ", [e.src, e.dst]) for e in g.edges()]
        nsteps = int(round(beta_max / (2 * dtau)))
        print("beta    E/site      <X>_mean    S2/site     max_trunc_err")
        for s in range(nsteps):
            rho, errs = apply_circuit(
                layer, rho,
                apply_kwargs=dict(maxdim=chi, cutoff=1e-12,
                                  normalize_tensors=True),
            )
            if (s + 1) % max(1, nsteps // 8) == 0:
                beta = 2 * dtau * (s + 1)
                xs = np.real(pauli_expectation(rho, obs_x, alg="bp"))
                zzs = np.real(pauli_expectation(rho, obs_zz, alg="bp"))
                energy = (-J * np.sum(zzs) - h * np.sum(xs)) / len(verts)
                s2 = -np.log2(purity(rho, alg="bp")) / len(verts)
                err = max((float(e) for e in errs), default=0.0)
                print(f"{beta:5.2f}  {energy:+.6f}  {np.mean(xs):+.6f}  "
                      f"{s2:.6f}  {err:.3e}")
        return rho


def read(text) -> dict:
    """The printed table: per row β, E/site, ⟨X⟩, S2/site and the largest
    truncation error."""
    return dict(table=table(text, 5))


if __name__ == "__main__":
    cli(main)
