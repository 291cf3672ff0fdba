"""Argument normalization and algorithm capability checks
(`src/utils.jl:38-67, 93-124`).

A jax-free copy of ``tensornetworkquantumsimulator_tpu.utils.checks``.  The
generic engine's boundary-MPS cache is not ported yet, so
:func:`default_alg` names "bp" for a BP cache and None otherwise."""

from __future__ import annotations

from .graphs import NamedEdge, NamedGraph


def collect_vertices(verts, g: NamedGraph) -> list:
    """Normalize a vertex / edge / collection argument to a vertex list
    (`utils.jl:93-124`)."""
    if isinstance(verts, NamedEdge):
        return [verts.src, verts.dst]
    if isinstance(verts, list) and all(isinstance(e, NamedEdge) for e in verts) and verts:
        out = []
        for e in verts:
            out.extend([e.src, e.dst])
        return out
    if g.has_vertex(verts):
        return [verts]
    if isinstance(verts, (list, tuple)):
        out = list(verts)
        if not all(g.has_vertex(v) for v in out):
            bad = [v for v in out if not g.has_vertex(v)]
            raise ValueError(f"vertices {bad} not in graph")
        if len(set(map(repr, out))) != len(out):
            raise ValueError("repeated vertex in collection")
        return out
    raise ValueError(f"cannot interpret {verts!r} as vertices of the graph")


_CAPABILITIES = {
    # functionality -> allowed algorithms (`utils.jl:38-67`)
    # the reference exports `expect_loopcorrect` but never defines it
    # (`TensorNetworkQuantumSimulator.jl:48` is a dangling export); here
    # loop-corrected expectations are actually implemented
    "expect": {"exact", "bp", "boundarymps", "loopcorrections"},
    "norm_sqr": {"exact", "bp", "boundarymps", "loopcorrections"},
    "inner": {"exact", "bp", "boundarymps", "loopcorrections"},
    "rdm": {"exact", "bp", "boundarymps"},
    "sample": {"bp", "boundarymps"},
    "truncate": {"bp", "boundarymps"},
    "normalize": {"bp"},
    "entanglement": {"bp"},
}


def algorithm_check(tns, f: str, alg) -> None:
    if alg is None:
        raise ValueError(
            "You must specify a contraction algorithm. "
            "Currently supported: exact, bp, loopcorrections and boundarymps."
        )
    if alg not in ("exact", "bp", "loopcorrections", "boundarymps"):
        raise ValueError(
            f"Unrecognized algorithm {alg!r}. Must be one of "
            "'exact', 'bp', 'loopcorrections', or 'boundarymps'"
        )
    allowed = _CAPABILITIES.get(f)
    if allowed is not None and alg not in allowed:
        raise ValueError(f"{alg!r} contraction not supported for {f!r} yet")


def default_alg(x):
    from ..engines.beliefpropagation import BeliefPropagationCache

    if isinstance(x, BeliefPropagationCache):
        return "bp"
    return None
