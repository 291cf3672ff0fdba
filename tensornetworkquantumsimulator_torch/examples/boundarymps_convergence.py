"""Boundary-MPS convergence sweep.

The port of ``examples/boundarymps_convergence.py``: ⟨Z⟩ / ⟨ZZ⟩ at
increasing MPS rank against the exact value, on random states drawn from
the package's generator after ``seed(1634)`` (the port's generator, so
the states differ from the JAX example's)."""

import re

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    expect,
    named_grid,
    named_hexagonal_lattice_graph,
    random_tensornetworkstate,
    seed,
)
from tensornetworkquantumsimulator_torch.examples import (
    NUMBER,
    cli,
    numbers,
    on_device,
)


def main(device=None):
    with on_device(device) as dev:
        nx, ny, chi = 5, 5, 2
        seed(1634)
        graphs = [
            (named_grid((nx, 1)), "line"),
            (named_hexagonal_lattice_graph(nx - 2, ny - 2), "hexagonal"),
            (named_grid((nx, ny)), "square"),
        ]
        for g, name in graphs:
            print(f"Testing {name} lattice with {g.nv()} vertices")
            psi = random_tensornetworkstate(torch.complex64, g, "S=1/2",
                                            bond_dimension=chi, device=dev)
            v_centre = g.center()[0]

            sz_bp = expect(psi, ("Z", v_centre), alg="bp")
            print(f"  BP value for Z: {sz_bp}")
            for rank in [1, 2, 4, 8, 16]:
                sz = expect(psi, ("Z", v_centre), alg="boundarymps",
                            mps_bond_dimension=rank)
                print(f"  Boundary MPS Z at rank {rank}: {sz}")
            sz_exact = expect(psi, ("Z", v_centre), alg="exact")
            print(f"  Exact value for Z: {sz_exact}")

            if not g.is_tree():
                v_n = g.neighbors(v_centre)[0]
                zz_exact = expect(psi, ("ZZ", [v_centre, v_n]), alg="exact")
                zz_bmps = expect(psi, ("ZZ", [v_centre, v_n]),
                                 alg="boundarymps", mps_bond_dimension=16)
                print(f"  Exact ZZ: {zz_exact}  BMPS ZZ: {zz_bmps}")


def read(text) -> dict:
    """The printed numbers per lattice: its header line, ⟨Z⟩ by BP, at
    ranks 1-16 and exactly (``z``, one row per lattice), and on a lattice
    with loops the exact and rank-16 ⟨ZZ⟩ (``zz``)."""
    blocks = text.split("Testing ")[1:]
    pair = r"Exact ZZ: " + NUMBER + r"\s+BMPS ZZ: " + NUMBER
    return dict(
        lattice=[b.splitlines()[0] for b in blocks],
        z=[numbers(r"(?:value for Z|rank \d+): " + NUMBER, b)
           for b in blocks],
        zz=[np.array([complex(x) for m in re.findall(pair, b) for x in m])
            for b in blocks])


if __name__ == "__main__":
    cli(main)
