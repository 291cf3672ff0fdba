"""Matrix factorizations on named tensors.

The counterpart of ``tensornetworkquantumsimulator_tpu.ops.linalg``: the
LAPACK-backed factorizations the reference reaches through ITensors (`qr`,
`factorize_svd`, `eigen`, `svd`; `simple_update.jl:39-53`,
`utils.jl:18-33,77-91`).  SVDs and eigendecompositions run in 64 bits (the
reference's `safe_eigen`), and so do QRs; every eigh goes through
``cuda_linalg.eigh_plain`` on the tensor's device, which hermitizes its
input first.  The truncation rank is decided on the host.

SVDs and QRs run where the tensor lies, as the JAX package's `_xp` picks
``jnp.linalg`` for device arrays and ``np.linalg`` for host ones: a CUDA
matrix is factorized by ``torch.linalg`` (cuSOLVER) on the card, a CPU one
by numpy's LAPACK, the routine the JAX package's generic engine calls on
its host arrays.  A factorization of a rank-deficient matrix, or one with
degenerate singular values, is free to pick its basis, and libraries pick
differently: for the all-ones 4×2 strand a boundary MPS starts from,
MKL's QR (torch's on the CPU) returns another second column than
OpenBLAS's (numpy's), and cuSOLVER's another again, and a truncated
boundary-MPS fit then takes another path.  On the CPU the port so takes
the JAX package's path; on the card only gauge-free outputs (converged
fits, exact contractions, BP) agree with the CPU's to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from .index import Index, uniqueinds
from .tensor import Tensor, real_of


def _matricize(t: Tensor, left_inds):
    left = [i for i in t.inds if i in set(left_inds)]
    right = uniqueinds(t.inds, left)
    arr = t.array(tuple(left) + tuple(right))
    ldim = int(np.prod([i.dim for i in left], initial=1))
    rdim = int(np.prod([i.dim for i in right], initial=1))
    return arr.reshape(ldim, rdim), left, right


def _promote_f64(arr: torch.Tensor):
    """Reference `safe_eigen` (`utils.jl:77-91`): factorize in 64 bits."""
    if arr.dtype == torch.float32:
        return arr.to(torch.float64), arr.dtype
    if arr.dtype == torch.complex64:
        return arr.to(torch.complex128), arr.dtype
    return arr, arr.dtype


def svd(mat: torch.Tensor):
    """Reduced ``(U, S, Vh)`` on ``mat``'s device: numpy's LAPACK on the
    CPU, ``torch.linalg.svd`` on the card."""
    if mat.device.type != "cpu":
        return torch.linalg.svd(mat, full_matrices=False)
    u, s, vh = np.linalg.svd(mat.detach().resolve_conj().numpy(),
                             full_matrices=False)
    return torch.from_numpy(u), torch.from_numpy(s), torch.from_numpy(vh)


def qr(mat: torch.Tensor):
    """Reduced ``(Q, R)`` on ``mat``'s device: numpy's LAPACK on the CPU,
    ``torch.linalg.qr`` on the card."""
    if mat.device.type != "cpu":
        return torch.linalg.qr(mat, mode="reduced")
    q, r = np.linalg.qr(mat.detach().resolve_conj().numpy(), mode="reduced")
    return torch.from_numpy(q), torch.from_numpy(r)


def truncation_rank(s, maxdim=None, cutoff=None, mindim=1):
    """ITensors-style truncation: drop the smallest σ while the *relative*
    discarded weight Σ_cut σ²/Σ σ² stays ≤ cutoff, capped at maxdim.
    ``s`` is a host array."""
    s = np.asarray(s)
    n = len(s)
    k = n if maxdim is None else min(n, int(maxdim))
    if cutoff is not None:
        p = s.astype(np.float64) ** 2
        total = p.sum()
        if total > 0:
            tail = np.cumsum(p[::-1])[::-1] / total  # tail[i] = rel weight of s[i:]
            keep = int(np.searchsorted(-tail, -float(cutoff), side="left"))
            k = min(k, max(keep, 1))
    return max(k, min(mindim, n))


def svd_truncated(
    t: Tensor,
    left_inds,
    maxdim=None,
    cutoff=None,
    mindim=1,
    ortho: str = "none",
    tags=("bond",),
):
    """Truncated SVD split of ``t`` across (left_inds | rest).

    Returns ``(X, Y, s_tensor, truncerr, bond_index)`` where t ≈ X·Y with a
    fresh ``bond_index`` between them; ``s_tensor`` carries the kept singular
    values on ``(bond, bond')``; ``truncerr`` is the relative discarded
    Σσ² weight (the per-gate error in `simple_update.jl:46-53`).

    ortho="none"  -> X = U√S, Y = √S·Vh    (simple-update convention)
    ortho="left"  -> X = U,   Y = S·Vh
    ortho="right" -> X = U·S, Y = Vh
    """
    mat, left, right = _matricize(t, left_inds)
    work, orig_dtype = _promote_f64(mat)
    u, s, vh = svd(work)
    s_host = s.cpu().numpy()  # the one host read of the split
    k = truncation_rank(s_host, maxdim=maxdim, cutoff=cutoff, mindim=mindim)
    p = s_host.astype(np.float64) ** 2
    total = p.sum()
    truncerr = float(p[k:].sum() / total) if total > 0 else 0.0

    u, s, vh = u[:, :k], s[:k], vh[:k, :]
    if ortho == "none":
        rs = torch.sqrt(s)
        x, y = u * rs[None, :], rs[:, None] * vh
    elif ortho == "left":
        x, y = u, s[:, None] * vh
    elif ortho == "right":
        x, y = u * s[None, :], vh
    else:
        raise ValueError(f"unknown ortho {ortho}")
    x = x.to(orig_dtype)
    y = y.to(orig_dtype)
    s = s.to(real_of(orig_dtype))  # σ are real

    bond = Index(int(k), tags=tags)
    X = Tensor(x.reshape(tuple(i.dim for i in left) + (k,)), tuple(left) + (bond,))
    Y = Tensor(y.reshape((k,) + tuple(i.dim for i in right)), (bond,) + tuple(right))
    s_t = Tensor(torch.diag(s), (bond, bond.prime()))
    return X, Y, s_t, truncerr, bond


def qr_factor(t: Tensor, left_inds, tags=("qr",)):
    """QR split: t = Q·R with Q isometric on (left_inds | bond).  One matrix
    per call (cuSOLVER's geqrf on CUDA, not the batched cuBLAS QR), in 64
    bits like the other factorizations here: torch's complex64 QR on the
    CPU (MKL) returns NaN on matrices whose columns hold denormal entries,
    which the Heisenberg-picture example reaches (`tests/test_torch_ops.py`
    holds one)."""
    mat, left, right = _matricize(t, left_inds)
    work, orig_dtype = _promote_f64(mat)
    q, r = qr(work)
    q, r = q.to(orig_dtype), r.to(orig_dtype)
    k = q.shape[1]
    bond = Index(int(k), tags=tags)
    Q = Tensor(q.reshape(tuple(i.dim for i in left) + (k,)), tuple(left) + (bond,))
    R = Tensor(r.reshape((k,) + tuple(i.dim for i in right)), (bond,) + tuple(right))
    return Q, R


def factorize(t: Tensor, left_inds, ortho="left", maxdim=None, cutoff=None, tags=("bond",)):
    """Reference `factorize`: orthogonal split, optionally truncated.

    Returns (X, Y, bond).  With no truncation requested uses QR (exact,
    cheaper); otherwise a truncated SVD.
    """
    if maxdim is None and cutoff is None and ortho == "left":
        Q, R = qr_factor(t, left_inds, tags=tags)
        return Q, R, Q.inds[-1]
    X, Y, _s, _err, bond = svd_truncated(
        t, left_inds, maxdim=maxdim, cutoff=cutoff, ortho=ortho, tags=tags
    )
    return X, Y, bond


def eigh_tensor(t: Tensor):
    """Hermitian eigendecomposition of a (row, col) matrix tensor.

    Returns (eigenvalues [ascending, real 1-d tensor], U, original dtype)
    with the convention M = U diag(w) U†, in 64 bits (reference
    `safe_eigen`, `utils.jl:77-91`), of the hermitized matrix.
    """
    if t.ndim != 2:
        raise ValueError("eigh_tensor expects a matrix tensor")
    from ..parallel.cuda_linalg import eigh_plain

    work, orig_dtype = _promote_f64(t.data)
    w, u = eigh_plain(work)
    return w, u, orig_dtype


def eigendecomp_hermitian(m: Tensor, regularization=0.0):
    """Return ``(U, w, orig_dtype)`` with M = U diag(w) U†, as arrays in 64
    bits on ``m``'s device, and ``regularization`` added to the real
    eigenvalues ``w``.  Used by the symmetric gauge
    (`symmetric_gauge.jl:12-20`)."""
    w, u, orig_dtype = eigh_tensor(m)
    return u, w + regularization, orig_dtype


def pseudo_sqrt_inv_sqrt(m: Tensor, cutoff=None):
    """(√M, 1/√M) of a hermitian 2-index environment, zeroing tiny/negative
    eigenvalues (reference `pseudo_sqrt_inv_sqrt`, `utils.jl:18-26`).

    Both results carry the same (row, col) indices as ``m``.  Nothing is
    read back to the host.
    """
    if cutoff is None:
        cutoff = 10 * float(torch.finfo(real_of(m.dtype)).eps)
    w, u, orig_dtype = eigh_tensor(m)
    good = (w.abs() >= cutoff) & (w > 0)
    safe = torch.where(good, w, torch.ones_like(w))
    zero = torch.zeros_like(w)
    sqrt_w = torch.where(good, torch.sqrt(safe), zero).to(u.dtype)
    inv_sqrt_w = torch.where(good, 1.0 / torch.sqrt(safe), zero).to(u.dtype)
    uh = u.conj().T
    m_sqrt = (u * sqrt_w[None, :]) @ uh
    m_inv_sqrt = (u * inv_sqrt_w[None, :]) @ uh
    return (
        Tensor(m_sqrt.to(orig_dtype), m.inds),
        Tensor(m_inv_sqrt.to(orig_dtype), m.inds),
    )
