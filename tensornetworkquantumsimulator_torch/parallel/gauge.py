"""Symmetric (Vidal) gauge on the batched engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.gauge``
(`src/symmetric_gauge.jl:1-56`): at the BP fixed point, per edge

    X = m_e,  Y = m_ē          (messages as χ×χ bond matrices)
    C = conj(√X) · √Y = U s V†
    A_u = conj(X^{-1/2}) U √s,   A_v = conj(Y^{-1/2}) V̄ √s

absorb A_u / A_v into the two end tensors' bond legs and replace both
messages with diag(s): the messages are then the entanglement spectra and
the state is in the Vidal gauge.

All E edges go through ONE batched eigh + SVD ([E, χ, χ]); the leg
transforms are applied in per-slot groups: every (vertex, slot) pair
belongs to exactly one edge, so each group's scatter is conflict-free.

``a_u`` / ``a_v`` carry the SVD's phase freedom; only the spectra and the
gauged state's observables are comparable between libraries.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_linalg import eigh_plain
from .engine import BatchedState
from .structure import BatchedGraphSpec


def _eig_roots(m: torch.Tensor, rel_cutoff: float):
    """Batched hermitian pseudo √ and 1/√ (`symmetric_gauge.jl:12-24`).

    Eigendirections below ``rel_cutoff`` × the largest eigenvalue are ZEROED
    in both roots rather than regularized: a rank-deficient message (padded
    bond, corner vertex) otherwise amplifies the null-space junk of the
    SVD's arbitrary basis by 1/√ε.  The eigh is the port's library eigh
    (``cuda_linalg.eigh_plain``): cuSOLVER's complex64 solver refuses such
    rank-deficient batches."""
    w, u = eigh_plain(m)
    wmax = w.amax(dim=-1, keepdim=True)
    ok = w > wmax * rel_cutoff
    sqrt_w = torch.sqrt(torch.where(ok, w, torch.ones_like(w)))
    zero = torch.zeros_like(w)
    uh = u.mH
    root = (u * torch.where(ok, sqrt_w, zero)[..., None, :].to(u.dtype)) @ uh
    inv_root = (u * torch.where(ok, 1.0 / sqrt_w, zero)[..., None, :]
                .to(u.dtype)) @ uh
    return root, inv_root


def _edge_gauge_transforms(X: torch.Tensor, Y: torch.Tensor, dtype,
                           rel_cutoff: float):
    """Per-edge Vidal-gauge bond transforms from the two messages.

    X/Y are [B, χ, χ] batches (X = the u→v message stored at v, Y = the
    v→u message stored at u).  Returns (a_u, a_v, ss): absorb a_u into
    u's bond leg, a_v into v's, and replace both messages with diag(ss).

    The outgoing message transforms as m' = Aᵀ m Ā, so C = conj(√X)·√Y and
    the inverse roots enter conjugated; then m'_e = m'_ē = diag(s) and the
    state is preserved (A_u A_vᵀ = conj(X^{-1/2}) C Y^{-1/2} = 1)."""
    rootX, inv_rootX = _eig_roots(X, rel_cutoff)
    rootY, inv_rootY = _eig_roots(Y, rel_cutoff)
    ce = rootX.conj() @ rootY
    uu, ss, vvh = torch.linalg.svd(ce, full_matrices=False)
    sqrt_s = torch.sqrt(ss).to(dtype)
    a_u = (inv_rootX.conj() @ uu) * sqrt_s[:, None, :]
    v = vvh.transpose(-1, -2)  # V̄ = Vhᵀ in the (l, new) layout
    a_v = (inv_rootY.conj() @ v) * sqrt_s[:, None, :]
    return a_u, a_v, ss


def _absorb_on_slot(tensors: torch.Tensor, idx: torch.Tensor, slot: int,
                    transforms: torch.Tensor) -> None:
    """tensors[idx] ← Σ_l T[..., l(slot), ...] A[l, l'], in place (unique
    idx rows)."""
    t2 = torch.movedim(tensors[idx], 1 + slot, -1)
    t2 = torch.einsum("e...l,elm->e...m", t2, transforms)
    tensors.index_copy_(0, idx, torch.movedim(t2, -1, 1 + slot))


def batched_symmetric_gauge(
    spec: BatchedGraphSpec, state: BatchedState,
    rel_cutoff: float | None = None,
):
    """Vidal-gauge the whole state at once; returns (state, spectra[E, χ]).

    The input must be at (or near) the BP fixed point; afterwards the
    messages are diag(spectra) and ``spectra[e]`` is the entanglement
    spectrum across edge e (`symmetric_gauge.jl:85-114`), edges in
    ``spec.edges`` order."""
    if rel_cutoff is None:
        rel_cutoff = 1e3 * torch.finfo(state.tensors.real.dtype).eps
    dev = state.tensors.device
    edges = np.asarray(spec.edges, dtype=np.int64)  # [E, 4] (iu, iv, su, sv)
    iu, iv, su, sv = (torch.as_tensor(edges[:, k], device=dev)
                      for k in range(4))
    X = state.messages[iv, sv]  # sent by u, arriving at v
    Y = state.messages[iu, su]  # sent by v, arriving at u

    a_u, a_v, ss = _edge_gauge_transforms(X, Y, state.tensors.dtype,
                                          rel_cutoff)

    tensors = state.tensors.clone()
    for slot in range(spec.degree):
        for col_v, col_s, transforms in ((0, 2, a_u), (1, 3, a_v)):
            sel = np.flatnonzero(edges[:, col_s] == slot)
            if sel.size:
                _absorb_on_slot(
                    tensors, torch.as_tensor(edges[sel, col_v], device=dev),
                    slot, transforms[torch.as_tensor(sel, device=dev)])

    s_diag = torch.diag_embed(ss.to(state.messages.dtype))
    messages = state.messages.clone()
    messages[iv, sv] = s_diag
    messages[iu, su] = s_diag
    return BatchedState(tensors, messages), ss
