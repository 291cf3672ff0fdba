"""Measurement layer of the port: for now the observable parser.

The counterpart of ``tensornetworkquantumsimulator_tpu.measure``
(`src/expect.jl`); this module holds only :func:`collectobservable`, which
the loop-corrected expectations parse their observables with.  The rest of
the reference module (``expect``, ``norm_sqr``, ``inner``, the reduced
density matrix) goes through the generic engine, which the port does not
have yet.
"""

from __future__ import annotations

from .utils.checks import collect_vertices
from .utils.graphs import NamedGraph


def collectobservable(obs: tuple, g: NamedGraph):
    """Parse ``(ops, vertices[, coeff])`` (`expect.jl:160-176`)."""
    coeff = 1 if len(obs) == 2 else obs[-1]
    verts = collect_vertices(obs[1], g)
    op = obs[0]
    if isinstance(op, str):
        op_strings = list(op)
    elif isinstance(op, (list, tuple)) and all(isinstance(o, str) for o in op):
        op_strings = list(op)
    else:
        raise ValueError(
            "Invalid observable: expected a string (one pauli character per "
            "vertex) or a list of strings (one per vertex)."
        )
    if len(op_strings) != len(verts):
        raise ValueError("Invalid observable: need as many operators as vertices.")
    return op_strings, verts, coeff
