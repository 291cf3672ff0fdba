"""Loop-corrected norms against BP and exact.

The port of ``examples/loopcorrections.py``, on random states drawn from
the package's generator after ``seed(1634)`` (the port's generator, so the
states differ from the JAX example's)."""

import re

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    BeliefPropagationCache,
    expect,
    named_grid,
    named_hexagonal_lattice_graph,
    norm,
    normalize,
    random_tensornetworkstate,
    seed,
)
from tensornetworkquantumsimulator_torch.examples import (
    NUMBER,
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    batched_from_tns,
    make_loopcorrected_expectations,
)


def main(device=None):
    with on_device(device) as dev:
        chi = 3
        seed(1634)
        graphs = [
            (named_grid((4, 1)), "line", 0),
            (named_hexagonal_lattice_graph(2, 2), "hexagonal", 6),
            (named_grid((4, 4)), "square", 4),
        ]
        for g, name, girth in graphs:
            print(f"Testing {name} lattice with {g.nv()} vertices")
            psi = random_tensornetworkstate(torch.complex64, g, "S=1/2",
                                            bond_dimension=chi, device=dev)
            psi = normalize(psi, alg="bp")
            n_bp = norm(psi, alg="bp")
            n_lc = norm(psi, alg="loopcorrections",
                        max_configuration_size=max(2 * girth - 1, 0))
            n_exact = norm(psi, alg="exact")
            print(f"  BP norm:             {n_bp}")
            print(f"  Loop-corrected norm: {n_lc}")
            print(f"  Exact norm:          {n_exact}")

        # loop-corrected OBSERVABLES, generic and batched: both engines
        # evaluate numerator and denominator series at the single norm BP
        # fixed point (op-anchored excitation configurations in the
        # numerator): BP-error-controlled <Z> without a per-observable BP
        g = named_grid((3, 3))
        psi = random_tensornetworkstate(torch.complex64, g, "S=1/2",
                                        bond_dimension=2, device=dev)
        psi = normalize(psi, alg="bp")
        v = list(g.vertices())[4]
        obs = ("Z", [v])
        z_exact = complex(expect(psi, obs, alg="exact"))
        z_bp = complex(expect(psi, obs, alg="bp"))
        z_lc = complex(expect(psi, obs, alg="loopcorrections",
                              max_configuration_size=6))
        cache = BeliefPropagationCache(psi).update(maxiter=100, tolerance=1e-7)
        spec, state = batched_from_tns(psi, chi=2, messages=cache.messages(),
                                       device=dev)
        fn = make_loopcorrected_expectations(spec, g, [obs],
                                             max_configuration_size=6)
        z_b = complex(fn(state)[0])
        print(f"center <Z> on 3x3: exact {z_exact.real:+.6f}  bp "
              f"{z_bp.real:+.6f}  loop-corrected {z_lc.real:+.6f}  batched "
              f"{z_b.real:+.6f}")


def read(text) -> dict:
    """The printed numbers: per lattice the BP, loop-corrected and exact
    norms (``norm``), then the 3x3 centre ⟨Z⟩ exact, by BP, loop-corrected
    and batched (``centre``)."""
    m = re.search(r"exact (\S+)\s+bp (\S+)\s+loop-corrected (\S+)\s+"
                  r"batched (\S+)", text)
    return dict(norm=numbers(r"norm:\s+" + NUMBER, text),
                centre=np.array([float(x) for x in m.groups()]) if m
                else np.zeros(0))


if __name__ == "__main__":
    cli(main)
