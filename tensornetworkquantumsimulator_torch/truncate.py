"""Bond truncation as identity-gate application (`src/truncate.jl`).

The counterpart of ``tensornetworkquantumsimulator_tpu.truncate``.

BP flavor: apply an identity two-site gate per truncatable edge, grouped by
edge color, with a BP refresh between groups (`truncate.jl:12-38`).
Boundary-MPS flavor: per-partition sweeps using `full_update` with
boundary-MPS environments, row then column passes (`truncate.jl:40-96`).
"""

from __future__ import annotations

from .apply import apply_gate_inplace
from .engines.beliefpropagation import (
    BeliefPropagationCache,
    default_bp_update_kwargs,
)
from .models import sites as _sites
from .ops.tensor import contract_pair
from .utils.checks import algorithm_check
from .utils.graphs import edge_color


def _truncatable_edge(cache, e) -> bool:
    vinds = cache.virtualinds(e)
    if not vinds:
        return False
    return any(i.dim != 1 for i in vinds)


def _identity_gate(s, v1, v2, dtype, device=None):
    t = None
    for sv in list(s[v1]) + list(s[v2]):
        o = _sites.op_tensor("I", sv, dtype=dtype, device=device)
        t = o if t is None else contract_pair(t, o)
    return t


def truncate_bp_cache(
    bpc: BeliefPropagationCache,
    maxdim: int,
    cutoff=None,
    bp_update_kwargs=None,
    use_edge_color: bool = True,
    normalize_tensors: bool = True,
):
    bpc = bpc.copy()
    bp_kw = bp_update_kwargs or default_bp_update_kwargs(bpc.network())
    s = bpc.network().siteinds()
    apply_kwargs = dict(maxdim=maxdim, cutoff=cutoff, normalize_tensors=normalize_tensors)
    dtype, dev = bpc.scalartype(), bpc.network().device()
    if use_edge_color:
        groups = edge_color(bpc.network().graph())
        for eg in groups:
            for e in eg:
                if _truncatable_edge(bpc, e):
                    gate = _identity_gate(s, e.src, e.dst, dtype, dev)
                    apply_gate_inplace(
                        gate, bpc, verts=[e.src, e.dst], apply_kwargs=apply_kwargs
                    )
            bpc = bpc.update(**bp_kw)
    else:
        for e in bpc.edges():
            gate = _identity_gate(s, e.src, e.dst, dtype, dev)
            apply_gate_inplace(gate, bpc, verts=[e.src, e.dst], apply_kwargs=apply_kwargs)
            bpc = bpc.update(**bp_kw)
    return bpc


def truncate(psi, alg: str = None, **kwargs):
    """Truncate the virtual bonds of a state (`truncate.jl:99-117`)."""
    if isinstance(psi, BeliefPropagationCache):
        return truncate_bp_cache(psi, **kwargs)
    algorithm_check(psi, "truncate", alg)
    if alg == "bp":
        bpc = BeliefPropagationCache(psi).update()
        return truncate_bp_cache(bpc, **kwargs).network()
    if alg == "boundarymps":
        from .engines.boundarymps import truncate_boundarymps

        return truncate_boundarymps(psi, **kwargs)
    raise ValueError(f"unknown truncate alg {alg!r}")
