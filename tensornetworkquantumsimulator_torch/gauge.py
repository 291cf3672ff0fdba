"""Gauge transformations, BP normalization and bond entanglement.

The counterpart of ``tensornetworkquantumsimulator_tpu.gauge``
(`src/symmetric_gauge.jl` and `src/normalize.jl`): Vidal/symmetric gauge
fixing from the BP fixed point (messages become diagonal singular-value
matrices), `gauge_and_scale` used before sampling/boundary-MPS, and the
entanglement spectrum across an edge.  The factorizations run on the
state's device; every eigh goes through ``cuda_linalg.eigh_plain`` (the
hermitized library eigh).
"""

from __future__ import annotations

import numpy as np
import torch

from .engines.beliefpropagation import (
    BeliefPropagationCache,
    default_bp_update_kwargs,
)
from .models.tensornetwork import TensorNetworkState
from .ops.index import Index, commoninds
from .ops.linalg import pseudo_sqrt_inv_sqrt, svd
from .ops.tensor import Tensor, contract_pair, real_of
from .parallel.cuda_linalg import eigh_plain
from .utils.checks import algorithm_check


def symmetric_gauge_inplace(bp_cache: BeliefPropagationCache, regularization=None):
    """Transform to the symmetric gauge (`symmetric_gauge.jl:1-56`): per edge
    eigendecompose both messages, form √X·√Y, SVD, absorb √S on both sides;
    messages become the diagonal spectrum S."""
    tn = bp_cache.network()
    if not isinstance(tn, TensorNetworkState):
        raise ValueError("can only gauge TensorNetworkStates")
    if regularization is None:
        regularization = 10 * float(torch.finfo(real_of(tn.scalartype())).eps)
    for e in tn.edges():
        vsrc, vdst = e.src, e.dst
        psis, psid = tn[vsrc], tn[vdst]
        edge_ind = commoninds(psis.inds, psid.inds)
        if len(edge_ind) != 1:
            raise ValueError("symmetric gauge needs one virtual index per edge")
        l = edge_ind[0]
        lp = l.prime()
        l_sim = l.sim()

        def eig_roots(m: Tensor):
            arr = m.array((l, lp))
            w_, u_ = eigh_plain(arr)
            sqrt_w = torch.sqrt(w_ + regularization).to(u_.dtype)
            uh = u_.conj().T
            root = (u_ * sqrt_w[None, :]) @ uh
            inv_root = (u_ * (1.0 / sqrt_w)[None, :]) @ uh
            return root, inv_root

        rootX, inv_rootX = eig_roots(bp_cache.message(e))
        rootY, inv_rootY = eig_roots(bp_cache.message(e.reverse()))

        # For complex hermitian messages the outgoing message transforms as
        # m' = Aᵀ m Ā under a bond transform A, so the root/inverse-root
        # factors must enter CONJUGATED for the new messages to land exactly
        # on diag(s): A_u = conj(X^{-1/2}) U √s, A_v = conj(Y^{-1/2}) Vᵀh √s
        # with U s Vh = svd(conj(√X)·√Y).  (Real messages reduce to the
        # textbook √X·√Yᵀ form; with the unconjugated form the post-gauge
        # messages are NOT the BP fixed point and ⟨O⟩ shifts — measured 0.24
        # on a complex 3×3 random state.)
        inv_rootX = inv_rootX.conj()
        inv_rootY = inv_rootY.conj()

        # absorb (conjugated) inverse roots into the site tensors
        psis = contract_pair(psis, Tensor(inv_rootX, (l, lp))).noprime()
        psid = contract_pair(psid, Tensor(inv_rootY, (l, lp))).noprime()

        # Ce = conj(√X) · √Y over the bond; Ce = U diag(s) Vh
        ce = rootX.conj() @ rootY
        uu, ss, vvh = svd(ce)
        k = ss.shape[0]
        new_l = Index(int(k), tags=l.tags)
        U = Tensor(uu, (l, new_l))
        V = Tensor(vvh.T, (l_sim, new_l))  # U·diag(s)·V^T over (new_l) == Ce

        psis = contract_pair(psis, U)
        psid = contract_pair(psid.replaceind(l, l_sim), V)

        S = Tensor(torch.diag(ss.to(psis.dtype)), (new_l, new_l.prime()))
        sqrtS = Tensor(torch.diag(torch.sqrt(ss).to(psis.dtype)),
                       (new_l, new_l.prime()))
        psis = contract_pair(psis, sqrtS).noprime()
        psid = contract_pair(psid, sqrtS).noprime()
        tn.setindex_preserve(psis, vsrc)
        tn.setindex_preserve(psid, vdst)
        bp_cache.setmessage(e, S)
        bp_cache.setmessage(e.reverse(), S.dag())
    return bp_cache


def symmetric_gauge(x, cache_update_kwargs=None, **kwargs):
    if isinstance(x, BeliefPropagationCache):
        return symmetric_gauge_inplace(x.copy(), **kwargs)
    bp_cache = BeliefPropagationCache(x).update(
        **(cache_update_kwargs or dict(maxiter=40))
    )
    return symmetric_gauge_inplace(bp_cache, **kwargs).network()


def symmetrize_and_normalize(bp_cache: BeliefPropagationCache, **kwargs):
    """Rescale to Z_BP = 1 then gauge (`symmetric_gauge.jl:70-74`)."""
    bp_cache = bp_cache.rescale()
    return symmetric_gauge_inplace(bp_cache, **kwargs)


def gauge_and_scale(tns: TensorNetworkState, cache_update_kwargs=None, **kwargs):
    """`symmetric_gauge.jl:76-83`: BP update + rescale + symmetric gauge."""
    bp_cache = BeliefPropagationCache(tns).update(
        **(cache_update_kwargs or dict(maxiter=40))
    )
    return symmetrize_and_normalize(bp_cache, **kwargs).network()


symmetrize_and_bpnormalize = gauge_and_scale


def normalize(tns, alg: str = None, cache_update_kwargs=None):
    """BP-normalize so Z_BP = 1 (`normalize.jl:1-24`)."""
    algorithm_check(tns, "normalize", alg)
    if isinstance(tns, BeliefPropagationCache):
        bpc = tns
    else:
        bpc = BeliefPropagationCache(tns).update(
            **(cache_update_kwargs or default_bp_update_kwargs(tns))
        )
    bpc = bpc.copy()
    bpc.rescale_inplace()
    return bpc.network()


def entanglement(psi, e, alg: str = None, cache_update_kwargs=None):
    """Bipartite entanglement across an edge from the BP message spectra
    (`symmetric_gauge.jl:85-114`)."""
    if isinstance(psi, BeliefPropagationCache):
        bp_cache = psi
    else:
        algorithm_check(psi, "entanglement", alg)
        bp_cache = BeliefPropagationCache(psi).update(
            **(cache_update_kwargs or dict(maxiter=40))
        )
    m1, m2 = bp_cache.message(e), bp_cache.message(e.reverse())
    l = bp_cache.network().virtualind(e)
    root_m1, _ = pseudo_sqrt_inv_sqrt(m1)
    root_m2, _ = pseudo_sqrt_inv_sqrt(m2)
    l_sim = l.sim()
    s = contract_pair(root_m1, root_m2.replaceind(l, l_sim))
    arr = s.array((l, l_sim))
    sv = torch.linalg.svdvals(arr).cpu().numpy()
    sv = sv / np.linalg.norm(sv)
    eps = float(np.finfo(sv.dtype).eps)
    ee = -sum(d * d * np.log(d * d) for d in sv if abs(d) >= eps)
    return abs(ee)
