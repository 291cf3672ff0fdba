"""Minimal named-index MPS/MPO machinery for the boundary-MPS engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.mps``: the
slice of ITensorMPS.jl the reference uses
(`boundarympscache.jl:391-496`): MPS truncation, the naive MPO×MPS apply and
the `generic_apply` that handles non-simple MPOs (internal tensors, loop
edges), plus `merge_internal_tensors`.

An "MPS" here is just a list of Tensors chained by shared indices; "site"
indices are whatever is not shared with the neighbors in the list.  The
tensors stay on their device; :func:`mps_norm` reads one scalar back, as
the JAX package does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.index import commoninds, uniqueinds
from ..ops.linalg import qr_factor, svd_truncated
from ..ops.tensor import Tensor, combiner, contract_pair, delta


def mps_link_inds(tensors: List[Tensor]) -> list:
    links = []
    for a, b in zip(tensors, tensors[1:]):
        links.append(commoninds(a.inds, b.inds))
    return links


def mps_site_inds(tensors: List[Tensor], i: int) -> list:
    other = set()
    for j, t in enumerate(tensors):
        if j != i:
            other.update(t.inds)
    return [k for k in tensors[i].inds if k not in other]


def mps_norm(tensors: List[Tensor]) -> float:
    """√⟨M|M⟩ by zipping the ladder left to right."""
    env = Tensor(torch.ones((), dtype=tensors[0].dtype,
                            device=tensors[0].device), ())
    for t in tensors:
        env = contract_pair(env, t)
        env = contract_pair(env, t.dag().prime(which=_link_only(tensors, t)))
    return float(np.sqrt(abs(env.scalar())))


def _link_only(tensors, t):
    other = set()
    for s in tensors:
        if s is not t:
            other.update(s.inds)
    return [i for i in t.inds if i in other]


def mps_normalize(tensors: List[Tensor]) -> List[Tensor]:
    n = mps_norm(tensors)
    if n == 0:
        return tensors
    scale = n ** (-1.0 / len(tensors))
    return [t * scale for t in tensors]


def mps_orthogonalize(tensors: List[Tensor]) -> List[Tensor]:
    """Left-orthogonalize up to the last site (QR sweep)."""
    out = list(tensors)
    for i in range(len(out) - 1):
        links = commoninds(out[i].inds, out[i + 1].inds)
        if not links:
            continue
        left = uniqueinds(out[i].inds, links)
        q, r = qr_factor(out[i], left)
        out[i] = q
        out[i + 1] = contract_pair(r, out[i + 1])
    return out


def mps_truncate(
    tensors: List[Tensor], maxdim=None, cutoff=None
) -> List[Tensor]:
    """Orthogonalize then right-to-left truncated-SVD sweep
    (ITensorMPS.truncate)."""
    if len(tensors) <= 1:
        return list(tensors)
    out = mps_orthogonalize(tensors)
    for i in range(len(out) - 1, 0, -1):
        links = commoninds(out[i - 1].inds, out[i].inds)
        if not links:
            continue
        right = uniqueinds(out[i].inds, links)
        x, y, _s, _err, _b = svd_truncated(
            out[i], links, maxdim=maxdim, cutoff=cutoff, ortho="right"
        )
        # out[i] = x·y with x carrying the old links: absorb x leftward
        out[i] = y
        out[i - 1] = contract_pair(out[i - 1], x)
    return out


def merge_internal_tensors(tensors: List[Tensor]) -> List[Tensor]:
    """Fold tensors with no site indices into a neighbor
    (`boundarympscache.jl:368-388`)."""
    out = list(tensors)
    while True:
        internal = [i for i in range(len(out)) if not mps_site_inds(out, i)]
        if not internal or len(out) == 1:
            return out
        site = internal[0]
        if site != len(out) - 1:
            merged = contract_pair(out[site], out[site + 1])
            out = out[:site] + [merged] + out[site + 2 :]
        else:
            merged = contract_pair(out[site - 1], out[site])
            out = out[: site - 1] + [merged]
    return out


def combine_consecutive_links(tensors: List[Tensor], dtype=None) -> List[Tensor]:
    out = list(tensors)
    for i in range(len(out) - 1):
        cinds = commoninds(out[i].inds, out[i + 1].inds)
        if len(cinds) > 1:
            c, _ = combiner(cinds, dtype=dtype if dtype is not None else out[i].dtype,
                            device=out[i].device)
            out[i] = contract_pair(out[i], c)
            out[i + 1] = contract_pair(out[i + 1], c)
    return out


def generic_apply(
    o_tensors: List[Tensor],
    m_tensors: List[Tensor] | None,
    normalize: bool = True,
    maxdim=None,
    cutoff=None,
) -> List[Tensor]:
    """MPO×MPS product densified and re-truncated, tolerating MPOs whose
    tensors connect non-consecutively (`boundarympscache.jl:420-473`)."""
    if m_tensors is None:
        out = merge_internal_tensors(list(o_tensors))
        out = combine_consecutive_links(out)
        if normalize:
            out = mps_normalize(out)
        return mps_truncate(out, maxdim=maxdim, cutoff=cutoff)

    out = []
    used = set()
    for i, ot in enumerate(o_tensors):
        match = None
        for j, mt in enumerate(m_tensors):
            if j not in used and commoninds(ot.inds, mt.inds):
                match = j
                break
        if match is None:
            out.append(ot)
        else:
            used.add(match)
            out.append(contract_pair(ot, m_tensors[match]))

    # split bonds that skip positions (loop edges) by threading deltas
    n = len(out)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    loop_edges = [
        (i, j)
        for (i, j) in pairs
        if commoninds(out[i].inds, out[j].inds) and abs(i - j) != 1
    ]
    for (i, j) in loop_edges:
        # thread the skipping bond through the in-between positions with
        # identity deltas so the chain becomes consecutive
        # (`boundarympscache.jl:437-448`)
        edge = (i, j)
        for k in range(i + 1, j):
            cinds = commoninds(out[edge[0]].inds, out[edge[1]].inds)
            if not cinds:
                break
            cind = cinds[0]
            fresh = cind.sim()
            d = delta((cind, fresh), dtype=out[k].dtype, device=out[k].device)
            out[j] = contract_pair(out[j], d)  # j: cind -> fresh
            out[k] = contract_pair(out[k], d)  # k gains the (cind, fresh) pair
            edge = (k, j)
    out = combine_consecutive_links(out)
    out = merge_internal_tensors(out)
    if normalize:
        out = mps_normalize(out)
    return mps_truncate(out, maxdim=maxdim, cutoff=cutoff)
