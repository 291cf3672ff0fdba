"""Loop corrections to belief propagation (`src/MessagePassing/loopcorrection.jl`).

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.
loopcorrection``.  Each configuration's weight is contracted on the
network's device and read back once.

Z ≈ Z_BP · (1 + Σ_configs weight) where configs are edge-induced leaf-free
subgraphs (generalized loops) up to a size cutoff, and each loop edge carries
the antiprojector δ − m_e m_ē at the BP fixed point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.tensornetwork import TensorNetworkState
from ..ops.paths import contraction_sequence
from ..ops.tensor import Tensor, contract
from ..utils.graphs import edgeinduced_subgraphs_no_leaves
from .beliefpropagation import BeliefPropagationCache


def loopcorrected_partitionfunction(
    bp_cache: BeliefPropagationCache, max_configuration_size: int
):
    """`loopcorrection.jl:3-16`."""
    zbp = bp_cache.partitionfunction()
    bp_cache = bp_cache.rescale()
    egs = edgeinduced_subgraphs_no_leaves(bp_cache.graph(), max_configuration_size)
    if not egs:
        return zbp
    ws = [_weight(bp_cache, eg) for eg in egs]
    return zbp * (1 + sum(ws))


def _boundary_edges_of_edgeset(bpc, es):
    """All edges incident to the loop region, excluding the loop's own edges
    (`loopcorrection.jl:66-78`)."""
    vs = []
    for e in es:
        for v in (e.src, e.dst):
            if v not in vs:
                vs.append(v)
    es_set = set(es) | {e.reverse() for e in es}
    out = []
    for v in vs:
        for e in bpc.graph().boundary_edges([v], dir="in"):
            if e not in es_set:
                out.append(e)
    return out


def _weight(bpc: BeliefPropagationCache, eg):
    """Contract one loop configuration with antiprojectors on its edges
    (`loopcorrection.jl:19-91`)."""
    bpc = bpc.copy()
    vs = eg.vertices()
    es = eg.edges()

    # boundary edges of each loop vertex (into the region)
    incident = []
    for v in vs:
        for e in bpc.graph().boundary_edges([v], dir="out"):
            incident.append(e)
    antiprojectors = []
    updated = set()
    eg_keys = {frozenset((e.src, e.dst)) for e in es}
    for e in incident:
        if e.reverse() in updated:
            continue
        mer = bpc.message(e.reverse())
        linds = [i for i in mer.inds if i.plev == 0]
        linds_sim = [i.sim() for i in linds]
        # primed partners of a DERIVED bra layer (states, QuadraticForm)
        # follow their base index onto the same sim'd id; independent
        # primed inds (BilinearForm's own bra ϕ') get their own sim
        derived = [i for i in mer.inds if i.plev > 0 and i.noprime() in linds]
        derived_sim = [
            linds_sim[linds.index(i.noprime())].setprime(i.plev)
            for i in derived
        ]
        indep = [
            i for i in mer.inds if i.plev > 0 and i.noprime() not in linds
        ]
        indep_sim = [i.sim() for i in indep]
        mer = mer.replaceinds(
            linds + derived + indep, linds_sim + derived_sim + indep_sim
        )
        bpc.setmessage(e.reverse(), mer)
        # rewire the source tensor onto the sim'd bond (a lazily derived
        # bra layer follows the rewired ket tensor automatically)
        t = bpc.network()[e.src]
        t_common = [i for i in t.inds if i in linds]
        if t_common:
            t_ind = t_common[0]
            pos = linds.index(t_ind)
            t = t.replaceind(t_ind, linds_sim[pos])
            bpc.setindex_preserve(t, e.src)
        # rewire an independent (stored) bra layer, if any
        bra = getattr(bpc.network(), "_bra", None)
        if bra is not None and indep:
            tb = bra[e.src]
            tb_common = [i for i in tb.inds if i in indep]
            for i in tb_common:
                tb = tb.replaceind(i, indep_sim[indep.index(i)])
            if tb_common:
                bra.setindex_preserve(tb, e.src)
        updated.add(e)

        if frozenset((e.src, e.dst)) in eg_keys:
            row_inds = list(linds) + list(derived) + list(indep)
            col_inds = list(linds_sim) + list(derived_sim) + list(indep_sim)
            # identity over the product space (row ⊗ col)
            dims = tuple(i.dim for i in row_inds)
            total = int(np.prod(dims))
            eye = torch.eye(total, dtype=bpc.scalartype(),
                            device=bpc.network().device()).reshape(dims + dims)
            identity = Tensor(eye, tuple(row_inds) + tuple(col_inds))
            me = bpc.message(e)
            ap = identity - _outer(me, mer, tuple(row_inds) + tuple(col_inds))
            antiprojectors.append(ap)

    incoming = [bpc.message(e) for e in _boundary_edges_of_edgeset(bpc, es)]
    local_tensors = []
    for v in vs:
        local_tensors.extend(bpc.bp_factors(v))
    ts = incoming + local_tensors + antiprojectors
    # exact order up to 40 tensors via the native connected-subset DP
    # (reference uses Greedy here, `loopcorrection.jl:89-90`; large loop
    # configurations are exactly the lists where greedy orders cost real
    # time — beyond the DP cap this still falls back to greedy)
    seq = contraction_sequence(ts, alg="optimal")
    return contract(ts, seq).scalar()


def _outer(a: Tensor, b: Tensor, out_inds):
    """Outer product m_e ⊗ m_ē aligned to out_inds."""
    from ..ops.tensor import contract_pair

    prod = contract_pair(a, b)
    return Tensor(prod.array(tuple(out_inds)), tuple(out_inds))
