"""BP-quality diagnostics: loop correlations.

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.
diagnostics`` (`loop_correlation(s)`, `beliefpropagationcache.jl:145-197`):
the eigen-spectrum of the transfer operator around a primitive cycle
measures how much correlation flows around the loop — a cheap error
estimate for BP.  The transfer operator is contracted on the device and
copied to the host for its general (non-hermitian) eigenvalues, as the JAX
package computes them with numpy; no hermitian eigh is taken here.
"""

from __future__ import annotations

import numpy as np

from ..ops.paths import contraction_sequence
from ..ops.tensor import contract
from ..utils.graphs import (
    NamedEdge,
    cycle_to_path,
    unique_simplecycles_limited_length,
)
from .beliefpropagation import BeliefPropagationCache, default_bp_update_kwargs


def loop_correlation(
    bpc: BeliefPropagationCache, loop: list, target_e: NamedEdge
) -> float:
    """1 − |λ₁|/Σ|λᵢ| of the loop transfer operator
    (`beliefpropagationcache.jl:145-189`)."""
    if bpc.graph().is_tree():
        return 0.0

    es = list(loop) + [target_e]
    vs = []
    for e in loop:
        for v in (e.src, e.dst):
            if v not in vs:
                vs.append(v)
    es_set = set(es) | {e.reverse() for e in es}
    incoming_es = []
    for v in vs:
        for e in bpc.graph().boundary_edges([v], dir="in"):
            if e not in es_set and e not in incoming_es:
                incoming_es.append(e)
    incoming = [bpc.message(e) for e in incoming_es]

    src_vertex = target_e.src
    m = bpc.message(target_e)
    e_virtualinds = list(m.inds)
    sims = [i.sim() for i in e_virtualinds]

    local_tensors = []
    for t in bpc.bp_factors(src_vertex):
        t_common = [i for i in t.inds if i in e_virtualinds]
        if t_common:
            i = t_common[0]
            t = t.replaceind(i, sims[e_virtualinds.index(i)])
        local_tensors.append(t)

    others = []
    for v in vs:
        if v != src_vertex:
            others.extend(bpc.bp_factors(v))
    tensors = local_tensors + others + incoming
    seq = contraction_sequence(tensors, alg="einexpr")
    t = contract(tensors, seq)

    # matricize (row = e_virtualinds, col = sims) and take the spectrum
    arr = t.numpy(tuple(e_virtualinds) + tuple(sims))
    dim = int(np.prod([i.dim for i in e_virtualinds]))
    lam = np.linalg.eigvals(arr.reshape(dim, dim).astype(np.complex128))
    lam = sorted(np.abs(lam), reverse=True)
    total = sum(lam)
    if total == 0:
        return 0.0
    return float(1 - lam[0] / total)


def loop_correlations(x, smallest_loop_size: int, bp_update_kwargs=None) -> list:
    """Correlations around each primitive loop
    (`beliefpropagationcache.jl:192-197`)."""
    if isinstance(x, BeliefPropagationCache):
        bpc = x
    else:
        bpc = BeliefPropagationCache(x).update(
            **(bp_update_kwargs or default_bp_update_kwargs(x))
        )
    cycles = unique_simplecycles_limited_length(bpc.graph(), smallest_loop_size)
    out = []
    for cycle in cycles:
        path = cycle_to_path(cycle)
        out.append(loop_correlation(bpc, path[:-1], path[-1].reverse()))
    return out
