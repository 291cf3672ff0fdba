"""Batched engine on PyTorch: flooding BP + batched simple update.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.engine``
for the single-device Trotter-layer path.  It runs

- synchronous ("flooding") BP: every directed message updated in one shot
  per iteration, as one batched einsum chain over ``[V, D, χ, χ]`` tensors,
  iterated by a Python loop with the reference's tolerance semantics
  (`abstractbeliefpropagationcache.jl:198-222`);
- the simple update batched over an entire edge-colour group
  (`apply_gates.jl:95-122` + `simple_update.jl:17-68` semantics, with
  grow-then-truncate inside a static χ buffer).

Knobs, read at call time with the reference's defaults:
``TNQS_EIGH_ALG`` ∈ {default, auto, jacobi} routes batched eighs and the
environment roots to the Jacobi kernels (K1/K2, ``cuda_linalg``);
``TNQS_ROOTS_FUSED`` (1) keeps the roots stage in one K1 launch;
``TNQS_SVD_ALG`` ∈ {default, gram, jacobi, qr, polar} picks the truncated
split; ``TNQS_QR_ALG`` ∈ {default, cholqr1, cholqr2, polar, defer} the
QR-reduce; ``TNQS_BP_KERNEL`` (0) routes degree-3 BP messages to K3
(``cuda_bp``).  64-bit dtypes never take a kernel path.  A colour group's
slot-pair buckets always run as one stacked update (the reference's
per-bucket switch has no counterpart here).

On a CUDA device every matmul runs in full float32 (no TF32), as the
reference runs every einsum at ``Precision.HIGHEST``:
:func:`tensornetworkquantumsimulator_torch.select_device` sets that.  There,
on a route that reads nothing back to the host, the colour-group update
replays as CUDA graphs (``su_graphs``), and so does each BP sweep between
its host reads (``bp_graphs``).
"""

from __future__ import annotations

import functools
import math
import os
import string
from typing import NamedTuple

import numpy as np
import torch

from ..devices import resolve_device
from ..utils.profiling import Counter, span
from .cuda_linalg import (
    clip_roots,
    eigh_plain,
    hermitize,
    jacobi_eigh,
    jacobi_pseudo_roots,
    library_qr,
    roots_kernel_supported,
)
from . import bp_graphs, su_graphs
from .structure import BatchedGraphSpec

_LETTERS = string.ascii_lowercase
_JACOBI_AUTO_MAX_N = 24

# counted while tracing (``utils.profiling``): BP's sweeps; in a folded
# ensemble the member-sweeps computed and those of members still running;
# the program's own blocking host reads, by site
_BP_SWEEPS = Counter("bp.sweeps")
_MEMBER_SWEEPS_COMPUTED = Counter("bp.member_sweeps_computed")
_MEMBER_SWEEPS_ACTIVE = Counter("bp.member_sweeps_active")
_CONVERGE_READS = Counter("host.reads.bp.converge")
_REFACTOR_READS = Counter("host.reads.qr.refactor")
# the Cholesky factors of the update's CholeskyQR passes, and of those the
# ones that took a shifted factorization (a device sum; `_gram_cholesky`)
_CHOL_FACTORS = Counter("qr.chol_factors")
_CHOL_SHIFTED = Counter("qr.chol_shifted")
# the slot-pair buckets handed to each `apply_color_group` call
_GROUP_BUCKETS = Counter("su.group.buckets")


def _svd_alg() -> str:
    return os.environ.get("TNQS_SVD_ALG", "default")


def _is_x64(m: torch.Tensor) -> bool:
    return m.dtype in (torch.complex128, torch.float64)


def _eigh_alg() -> str:
    return os.environ.get("TNQS_EIGH_ALG", "default")


def _use_jacobi(m: torch.Tensor) -> bool:
    """The reference's routing rule (engine.py:74-82): ``jacobi`` always,
    ``auto`` for n ≤ 24 on the accelerator; never for 64-bit dtypes (the
    kernels compute in f32 and would drop ~8 digits)."""
    alg = _eigh_alg()
    return m.ndim >= 3 and not _is_x64(m) and (
        alg == "jacobi"
        or (alg == "auto" and m.shape[-1] <= _JACOBI_AUTO_MAX_N and m.is_cuda)
    )


def _eigh(m: torch.Tensor):
    with span("linalg.eigh", m):
        if _use_jacobi(m):
            lead = m.shape[:-2]
            w, v = jacobi_eigh(m.reshape((-1,) + m.shape[-2:]))
            return (w.reshape(lead + w.shape[-1:]),
                    v.reshape(lead + v.shape[-2:]))
        return eigh_plain(m)


def _ridged_cholesky(mat: torch.Tensor, shifted: list | None = None):
    """Lower L with L L† = A†A + ridge for a batch A [..., m, k]
    (:func:`_gram_cholesky` of A†A)."""
    return _gram_cholesky(mat.mH @ mat, mat.shape[-2], shifted)


def _gram_cholesky(gram: torch.Tensor, m: int, shifted: list | None = None):
    """Lower L with L L† = A†A + ridge from the Gram ``gram`` = A†A of an
    m-row block [m, k]: a relative ridge, 10·ε·(tr + k·ε) as in the JAX
    package's ``_chol_once``, keeps the factor finite when A has
    zero-padded bond columns (rank-deficient Gram).

    The Gram's rounding grows with m, and the ridge covers it only for a
    few hundred rows: on an H100, [4096, 128] blocks of Eagle at χ=64 read
    null-space eigenvalues down to −1.30e-6·tr against the ridge's
    1.19e-6·tr, and the factorization failed.  A matrix whose ridged
    factorization fails (``cholesky_ex``'s ``info`` ≠ 0) takes the first
    shifted one of A†A + s·I that succeeds, with u = ε/2: s = 10·√m·u·(tr +
    k·ε), the Gram's rounding as it grows with m; then shifted
    CholeskyQR's 11(mk + k(k+1))·u·‖A‖², tr ≥ ‖A‖² (Fukaya,
    Kannan, Nakatsukasa, Yamamoto and Yanagisawa, SIAM J. Sci. Comput. 42
    (2020)), which succeeds for any finite block whose Gram is finite.  A
    matrix none succeeds on (a non-finite A) gets a NaN factor, never a
    wrong finite one.  Each factorization runs on the whole batch, and
    ``torch.where`` selects per matrix: no host read, so the update's CUDA
    graphs hold it, and a matrix whose ridged factorization succeeds gets
    the factor it got before.  The JAX package has no fallback (its
    Cholesky returns NaN where this one fails).  ``shifted``, a list,
    receives the [B] bool of the matrices that took a shift."""
    k = gram.shape[-1]
    eps = torch.finfo(gram.real.dtype).eps
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1).real
    eye = torch.eye(k, dtype=gram.dtype, device=gram.device)
    with span("su.qr.cholesky"):
        # the ridge, then the two shifts (each a multiple of tr/k + ε):
        # three factorizations in one call
        t = tr / k + eps
        shifts = torch.stack([10.0 * k * eps * t,
                              10.0 * math.sqrt(m) * (eps / 2) * k * t,
                              11.0 * (m * k + k * (k + 1)) * (eps / 2) * k * t])
        # cholesky_ex: no host sync for the error check
        ells, info = torch.linalg.cholesky_ex(
            hermitize(gram) + shifts.to(gram.dtype)[..., None, None] * eye)
        ok = info == 0
        ell = torch.where(ok[0, ..., None, None], ells[0],
                          torch.where(ok[1, ..., None, None], ells[1],
                                      ells[2]))
        ell = torch.where(ok.any(0)[..., None, None], ell, torch.nan)
    if shifted is not None:
        shifted.append(~ok[0])
    return ell


def _polar_once(mat: torch.Tensor):
    """One polar-QR pass: M = (A†A)^{1/2}, Q = A·(A†A)^{-1/2} (through
    :func:`_pseudo_roots`, so one K1 launch on the Jacobi path)."""
    root, inv_root = _pseudo_roots(mat.mH @ mat)
    return mat @ inv_root, root


def _chol_once(mat: torch.Tensor, shifted: list | None = None):
    """One CholeskyQR pass: A = Q·L† from the Gram's Cholesky factor."""
    ell = _ridged_cholesky(mat, shifted)
    # x·L† = A
    q = torch.linalg.solve_triangular(ell.mH, mat, upper=True, left=False)
    return q, ell.mH


def _householder_qr(mat: torch.Tensor):
    """The library QR of a batch.  A 32-bit batch on the CPU is factorized
    in 64 bits and cast back: MKL's complex64 QR returns NaN on columns
    holding denormal entries, where XLA's stays finite.  On CUDA torch
    takes cuBLAS's batched geqrf for a batch of small matrices, which
    returns NaN for some rank-deficient matrices with zero columns (a
    padded bond: heavy-hex at χ=3 on an H100): those are factorized again
    (``_refactored``)."""
    if mat.device.type != "cpu" or _is_x64(mat):
        q, r = torch.linalg.qr(mat)
        return _refactored(mat, q, r) if mat.is_cuda and mat.ndim == 3 \
            else (q, r)
    wide = torch.complex128 if mat.is_complex() else torch.float64
    q, r = torch.linalg.qr(mat.to(wide))
    return q.to(mat.dtype), r.to(mat.dtype)


def _refactored(mat: torch.Tensor, q: torch.Tensor, r: torch.Tensor):
    """(q, r) of the batch ``mat`` [B, m, k] with every matrix whose
    factors are not finite factorized again alone (``library_qr``: one
    matrix per call, cuSOLVER's geqrf on CUDA).  One host read."""
    bad = ~(torch.isfinite(q).flatten(1).all(1)
            & torch.isfinite(r).flatten(1).all(1))
    idx = bad.nonzero().flatten()
    _REFACTOR_READS.add()
    if idx.numel():
        q[idx], r[idx] = library_qr(mat[idx])
    return q, r


def _qr_alg() -> str:
    return os.environ.get("TNQS_QR_ALG", "default")


def _qr_split(mat: torch.Tensor, shifted: list | None = None):
    """(Q, R) of a batch by the ``TNQS_QR_ALG`` route; ``shifted`` receives
    each CholeskyQR pass's shifted matrices (:func:`_ridged_cholesky`)."""
    alg = _qr_alg()
    if alg == "cholqr1":
        return _chol_once(mat, shifted)
    if alg == "cholqr2":
        q1, m1 = _chol_once(mat, shifted)
        q, m2 = _chol_once(q1, shifted)
        return q, m2 @ m1
    if alg != "polar":
        return _householder_qr(mat)
    q1, m1 = _polar_once(mat)
    q, m2 = _polar_once(q1)
    return q, m2 @ m1


def _qr_reduce(mat: torch.Tensor, shifted: list | None = None):
    """QR-reduce with an optionally deferred Q (``TNQS_QR_ALG=defer``).

    Returns ``(q, r, deferred)``: ``deferred=False`` → ``q`` orthonormal;
    ``deferred=True`` → ``q`` IS the input and the caller left-solves the
    small factors against upper-triangular ``r`` (:func:`_rinv_left`)
    before the `_su_finish` rebuild.  ``shifted`` as for :func:`_qr_split`."""
    if _qr_alg() == "defer":
        return mat, _ridged_cholesky(mat, shifted).mH, True
    q, r = _qr_split(mat, shifted)
    return q, r, False


def _rinv_left(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Solve upper-triangular ``R z = x`` (the deferred-Q rebuild)."""
    return torch.linalg.solve_triangular(r, x, upper=True, left=True)


_SVD_DRIVERS = {"default": None, "gram": None, "polar": None,
                "jacobi": "gesvdj", "qr": "gesvd"}


def _svd(mat: torch.Tensor):
    alg = _svd_alg()
    if alg not in _SVD_DRIVERS:
        raise ValueError(f"unknown TNQS_SVD_ALG {alg!r}")
    # the reference's lax SVD algorithms map onto cuSOLVER drivers on CUDA
    driver = _SVD_DRIVERS[alg] if mat.is_cuda else None
    return torch.linalg.svd(mat, full_matrices=False, driver=driver)


def _gram(mat: torch.Tensor) -> torch.Tensor:
    """The smaller Gram matrix of ``mat``: M†M, or MM† when M is wide."""
    h = mat.mH
    return h @ mat if mat.shape[-1] <= mat.shape[-2] else mat @ h


def _gram_factors(mat: torch.Tensor, w: torch.Tensor, v: torch.Tensor):
    """(U, s, V†) of ``mat`` from the ascending eigenpairs (w, v) of
    :func:`_gram` (mat).  Columns of U (rows of V†) for zero singular
    values are zeroed, not orthonormalized — the truncation path multiplies
    them by √s = 0."""
    w, v = w.flip(-1), v.flip(-1)  # descending
    s = torch.sqrt(torch.clamp(w, min=0.0))
    if mat.shape[-1] <= mat.shape[-2]:  # v holds V
        us = mat @ v  # = U diag(s)
        pos = (s > 0)[..., None, :]
        safe = torch.where(s > 0, s, torch.ones_like(s))[..., None, :]
        uu = torch.where(pos, us / safe, torch.zeros_like(us))
        return uu, s, v.mH
    sv = v.mH @ mat  # v holds U; = diag(s) V†
    pos = (s > 0)[..., :, None]
    safe = torch.where(s > 0, s, torch.ones_like(s))[..., :, None]
    vh = torch.where(pos, sv / safe, torch.zeros_like(sv))
    return v, s, vh


def _gram_split(mat: torch.Tensor):
    """(U, s, V†) via one eigh of the smaller Gram matrix."""
    return _gram_factors(mat, *_eigh(_gram(mat)))


class BatchedState(NamedTuple):
    """Padded vertex tensors + per-slot incoming messages."""

    tensors: torch.Tensor  # [V, χ, ..., χ (D times), d]
    messages: torch.Tensor  # [V, D, χ, χ] (ket, bra) environment matrices

    @property
    def chi(self) -> int:
        return self.tensors.shape[1]

    @property
    def degree(self) -> int:
        return self.tensors.ndim - 2


class GraphTables(NamedTuple):
    """The spec's neighbour tables as device tensors, built once."""

    nbr: torch.Tensor  # [V, D] int64
    nbr_slot: torch.Tensor  # [V, D] int64
    mask: torch.Tensor  # [V, D] bool


def graph_tables(spec: BatchedGraphSpec, device) -> GraphTables:
    return GraphTables(
        torch.as_tensor(spec.nbr_array(), dtype=torch.long, device=device),
        torch.as_tensor(spec.nbr_slot_array(), dtype=torch.long, device=device),
        torch.as_tensor(spec.mask_array(), dtype=torch.bool, device=device),
    )


def fold_members(estate: BatchedState) -> BatchedState:
    """An ensemble state [E, V, ...] as one state of E·V vertices (a view)."""
    return BatchedState(estate.tensors.flatten(0, 1),
                        estate.messages.flatten(0, 1))


def unfold_members(state: BatchedState, members: int) -> BatchedState:
    """The inverse of :func:`fold_members`."""
    return BatchedState(state.tensors.unflatten(0, (members, -1)),
                        state.messages.unflatten(0, (members, -1)))


def member_indices(idx: torch.Tensor, members: int,
                   num_vertices: int) -> torch.Tensor:
    """Vertex indices ``idx`` [n, ...] for every member of an ensemble
    folded into the vertex axis (member e's vertex v is row e·V + v), as
    one [members·n, ...] index, member-major."""
    if members == 1:
        return idx
    offs = num_vertices * torch.arange(members, device=idx.device)
    return (idx[None] + offs.reshape((members,) + (1,) * idx.ndim)).reshape(
        (-1,) + tuple(idx.shape[1:]))


def member_tables(tables: GraphTables, members: int,
                  num_vertices: int) -> GraphTables:
    """The neighbour tables of ``members`` copies of a graph folded into
    one graph of members·V vertices."""
    if members == 1:
        return tables
    return GraphTables(member_indices(tables.nbr, members, num_vertices),
                       tables.nbr_slot.repeat(members, 1),
                       tables.mask.repeat(members, 1))


def identity_messages(v: int, d: int, chi: int, dtype, device=None):
    """Identity messages [v, d, χ, χ] on ``device`` (None: the package's
    default, CUDA)."""
    eye = torch.eye(chi, dtype=dtype, device=resolve_device(device))
    return eye.expand(v, d, chi, chi).clone()


def _absorb(t: torch.Tensor, m: torch.Tensor, axis: int) -> torch.Tensor:
    """Σ_l t[..., l, ...] m[v, l, l'] along the given axis (batched on v)."""
    t2 = torch.movedim(t, axis, -1)
    out = torch.einsum("v...l,vlm->v...m", t2, m)
    return torch.movedim(out, -1, axis)


# ---------------------------------------------------------------------------
# flooding BP
# ---------------------------------------------------------------------------


def _all_except_one(t, messages, slots):
    """[t with every slot's message absorbed except slot j, for j in slots];
    a binary split reuses the shared half (D·log₂D absorbs)."""
    if len(slots) == 1:
        return [t]
    mid = len(slots) // 2
    left, right = slots[:mid], slots[mid:]
    t_right_absorbed = t
    for k in right:
        t_right_absorbed = _absorb(t_right_absorbed, messages[:, k], 1 + k)
    t_left_absorbed = t
    for k in left:
        t_left_absorbed = _absorb(t_left_absorbed, messages[:, k], 1 + k)
    return _all_except_one(t_right_absorbed, messages, left) + _all_except_one(
        t_left_absorbed, messages, right
    )


def outgoing_messages_einsum(t: torch.Tensor, messages: torch.Tensor,
                             bra_conj: torch.Tensor | None = None):
    """m_out[u, j] by the op-level chain: all incoming messages but slot
    j's absorbed, contracted with conj(t) over every other leg (or with
    ``bra_conj``, a pre-conjugated bra layer, on a two-layer sandwich)."""
    D = t.ndim - 2
    accs = _all_except_one(t, messages, list(range(D)))
    tconj = t.conj() if bra_conj is None else bra_conj
    outs = []
    for j, acc in zip(range(D), accs):
        lab = [_LETTERS[k] for k in range(D)]
        acc_lab = list(lab)
        acc_lab[j] = "p"  # outgoing ket leg
        conj_lab = list(lab)
        conj_lab[j] = "q"  # outgoing bra leg
        eq = f"v{''.join(acc_lab)}s,v{''.join(conj_lab)}s->vpq"
        outs.append(torch.einsum(eq, acc, tconj))
    return torch.stack(outs, dim=1)  # [V, D, χ, χ]


def _k3_route(t: torch.Tensor, messages: torch.Tensor) -> bool:
    """Whether :func:`_outgoing_messages` takes K3 on these inputs."""
    if os.environ.get("TNQS_BP_KERNEL", "0") != "1" or t.ndim != 5:
        return False
    if torch.is_grad_enabled() and (t.requires_grad or messages.requires_grad):
        return False
    from .cuda_bp import bp_kernel_supported

    chi = t.shape[1]
    return (bp_kernel_supported(3, chi, t.shape[-1], t.dtype, t.shape[0])
            and all(s == chi for s in t.shape[1:4]))


class _Eager:
    """The default runner of the stretches that BP and the simple update
    are cut into: each stretch runs as it comes, each input is read where
    it lies (``bp_graphs`` and ``su_graphs`` replay them as CUDA graphs)."""

    @staticmethod
    def stretch(_i, fn):
        return fn()

    @staticmethod
    def fixed(_name, value):
        return value


def _outgoing_messages(state: BatchedState, run=_Eager) -> torch.Tensor:
    """m_out[u, j]: message u sends through slot j
    (`abstractbeliefpropagationcache.jl:144-177`, batched).
    ``TNQS_BP_KERNEL=1`` routes degree-3 states with equal bond legs
    through the K3 CUDA kernel chain (``cuda_bp.bp_outgoing_d3``), called
    eagerly on every path; the einsum chain is the stretch ``"m"`` of
    ``run`` (:class:`_Eager`, or a refresh's replays in ``bp_graphs``).

    While autograd records a graph through this call (grad mode on, and
    the tensors or the messages require grad) the einsum chain runs
    instead: K3 writes its output through a ctypes launch, which leaves no
    ``grad_fn``, and the JAX kernel it ports has no VJP either.  This is a
    choice by what the caller needs (a differentiable result), not a
    retreat from a failed launch; ``cuda_bp.bp_launches`` counts only the
    calls that reach the kernel."""
    with span("bp.messages"):
        t = state.tensors
        if _k3_route(t, state.messages):
            from .cuda_bp import bp_outgoing_d3

            return bp_outgoing_d3(t, state.messages)
        t, m = run.fixed("t", t), run.fixed("m", state.messages)
        return run.stretch("m", lambda: (outgoing_messages_einsum(t, m),))[0]


def _normalize_messages(m, mask, hermitize_: bool = True):
    """Hermitize + divide by the entry sum (`abstractbeliefpropagationcache.
    jl:164-172`); dummy slots pinned to the identity."""
    if hermitize_:
        m = hermitize(m)
    s = m.sum(dim=(-2, -1), keepdim=True)
    safe = torch.where(s.abs() == 0, torch.ones_like(s), s)
    m = m / safe
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return torch.where(mask[..., None, None], m, eye)


def _incoming(m_out, nbr, nbr_slot, mask):
    """Stretch ``"n1"`` of a sweep: the message INTO v through slot k was
    sent by nbr[v,k] via nbr_slot[v,k]; gathered [V, D, χ, χ], normalized."""
    return (_normalize_messages(m_out[nbr, nbr_slot], mask),)


def bp_iteration(spec: BatchedGraphSpec, state: BatchedState,
                 tables: GraphTables | None = None,
                 run=_Eager) -> torch.Tensor:
    """One synchronous sweep: every directed message updated at once
    (``run`` as for :func:`_outgoing_messages`)."""
    if tables is None:
        tables = graph_tables(spec, state.tensors.device)
    m_out = _outgoing_messages(state, run)
    fn = functools.partial(_incoming, run.fixed("m_out", m_out),
                           *(run.fixed(name, x) for name, x in zip(
                               GraphTables._fields, tables)))
    return run.stretch("n1", fn)[0]


def _message_distance(a, b, mask, members: int = 1):
    """Mean per-edge fidelity distance (`beliefpropagationcache.jl:15-19`),
    one value per ensemble member: the rows of ``a``/``b``/``mask`` are
    ``members`` stacked copies of the graph's vertices.  Returns [members]."""
    dot = (a.conj() * b).sum(dim=(-2, -1))
    na = torch.linalg.vector_norm(a.flatten(-2), dim=-1)
    nb = torch.linalg.vector_norm(b.flatten(-2), dim=-1)
    nn = na * nb
    denom = torch.where(nn == 0, torch.ones_like(nn), nn)
    f = (dot / denom).abs() ** 2
    d = torch.where(mask, 1.0 - f, torch.zeros_like(f))
    count = mask.reshape(members, -1).sum(-1)
    return d.reshape(members, -1).sum(-1) / torch.clamp(count, min=1)


def default_batched_tolerance(dtype) -> float:
    if dtype in (torch.float32, torch.complex64):
        return 1e-5
    return 1e-8


def _sweep_end(m, new, active, mask, tolerance, damping, members):
    """Stretch ``"n2"`` of a sweep: damping, the distance to the last
    messages and, with ``members`` > 1, the freeze of the members already
    stopped.  Returns (messages, active members, go on, the [members]
    distances), the distances for whoever wraps the runner (``chip_smoke``
    records each member's stop from them)."""
    if damping > 0:
        new = _normalize_messages((1 - damping) * new + damping * m,
                                  mask, hermitize_=False)
    dist = _message_distance(m, new, mask, members)
    go = dist > tolerance
    if members == 1:
        return new, active, go, dist
    keep = active[:, None].expand(members, m.shape[0] // members)
    m = torch.where(keep.reshape(-1, 1, 1, 1), new, m)
    active = active & go
    return m, active, active.any(), dist


def _fixed_point(iterate, m, mask, maxiter, tolerance, damping,
                 members: int = 1, run=_Eager):
    """Iterate ``m ← iterate(m)`` (optionally damped) while the mean
    message change exceeds ``tolerance``, at most ``maxiter`` sweeps.

    The reference's ``lax.while_loop`` becomes a Python loop with the same
    semantics; reading whether to go on syncs the host with the device once
    per sweep (a design choice of this port, whose cost is for a later
    measurement).  With ``members`` > 1 the rows of ``m`` are that many
    ensemble members' messages stacked, and each member stops on its own
    distance, as ``jax.vmap`` of the while loop does: a member whose
    distance fell to the tolerance is frozen while the others go on.
    ``run`` runs the sweep's last stretch (:func:`_sweep_end`) as for
    :func:`_outgoing_messages`."""
    active = torch.ones(members, dtype=torch.bool, device=m.device)
    for _ in range(maxiter):
        with span("bp.sweep"):
            # the last sweep's outputs, copied in before any stretch replays
            m, active = run.fixed("m", m), run.fixed("active", active)
            new = iterate(m)
            _BP_SWEEPS.add()
            _MEMBER_SWEEPS_COMPUTED.add(members)
            if members > 1:
                # on the device: the members this sweep still moves
                _MEMBER_SWEEPS_ACTIVE.add_device(active)
            else:
                _MEMBER_SWEEPS_ACTIVE.add()
            m, active, go, _ = run.stretch("n2", functools.partial(
                _sweep_end, m, new, active, run.fixed("mask", mask),
                tolerance, damping, members))
            with span("bp.converge_read"):
                stop = not bool(go)
            _CONVERGE_READS.add()
        if stop:
            break
    return m


def bp_update(
    spec: BatchedGraphSpec,
    state: BatchedState,
    maxiter: int = 30,
    tolerance: float | None = None,
    damping: float = 0.0,
    tables: GraphTables | None = None,
    members: int = 1,
) -> BatchedState:
    """Flooding BP to the fixed point (tolerance on the mean message change,
    `abstractbeliefpropagationcache.jl:198-222`).  ``members`` > 1 runs an
    ensemble folded into the vertex axis (``tables`` then hold its offset
    neighbour tables), each member to its own stopping point.  On CUDA,
    outside autograd's recording, the sweeps replay as CUDA graphs
    (``bp_graphs``); the host still reads the stop once a sweep."""
    with span("bp.update"):
        if tolerance is None:
            tolerance = default_batched_tolerance(state.tensors.dtype)
        if tables is None:
            tables = graph_tables(spec, state.tensors.device)
        run = bp_graphs.refresh(state, tables, members, damping, tolerance)

        def iterate(m):
            return bp_iteration(spec, state._replace(messages=m), tables,
                                run)

        m = _fixed_point(iterate, state.messages, tables.mask, maxiter,
                         tolerance, damping, members, run)
        return state._replace(messages=run.out(m))


# ---------------------------------------------------------------------------
# environment roots
# ---------------------------------------------------------------------------


def _pseudo_roots(m: torch.Tensor):
    """(√M, 1/√M) of hermitian environment batches with cutoff zeroing
    (`utils.jl:18-26`, batched); padded/dummy directions stay exactly zero.

    On the Jacobi path the whole stage runs as one K1 launch
    (``cuda_linalg.jacobi_pseudo_roots``) when its shape gate admits n;
    ``TNQS_ROOTS_FUSED=0`` keeps the K2 eigh + PyTorch reconstruction."""
    with span("linalg.roots", m):
        m = hermitize(m)
        n = m.shape[-1]
        if _use_jacobi(m) and os.environ.get("TNQS_ROOTS_FUSED", "1") != "0":
            flat = m.reshape((-1,) + m.shape[-2:])
            if roots_kernel_supported(n, flat.shape[0]):
                root, inv_root = jacobi_pseudo_roots(flat)
                return root.reshape(m.shape), inv_root.reshape(m.shape)
        return clip_roots(*_eigh(m))


# ---------------------------------------------------------------------------
# batched simple update
# ---------------------------------------------------------------------------


def _index(idx, device) -> torch.Tensor:
    """Bucket indices as a device tensor (already one, or a static tuple)."""
    if isinstance(idx, torch.Tensor):
        return idx
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _write_back(tensors, messages, u_idx, v_idx, slot_u, slot_v,
                tu_new, tv_new, msg):
    """In-place row writes into the layer's own copies (indices are unique
    within a bucket)."""
    tensors.index_copy_(0, u_idx, tu_new.to(tensors.dtype))
    tensors.index_copy_(0, v_idx, tv_new.to(tensors.dtype))
    messages[u_idx, slot_u] = msg.to(messages.dtype)
    messages[v_idx, slot_v] = msg.to(messages.dtype)


def _theta(ru, rv, gate):
    """θ = gate · (Rᵤ Rᵥ) over the shared bond, matricized [B, r1·d, r2·d]."""
    theta = torch.einsum("bxlc,bylz->bxcyz", ru, rv)
    g = gate.to(theta.dtype)
    if g.ndim == 4:
        theta = torch.einsum("bxcyz,pqcz->bxpyq", theta, g)
    else:
        theta = torch.einsum("bxcyz,bpqcz->bxpyq", theta, g)
    B, r1, d, r2, _ = theta.shape
    return theta.reshape(B, r1 * d, r2 * d)


def _normalize_rows(t: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=-1)
    n = torch.where(n == 0, torch.ones_like(n), n)
    return t / n.reshape((-1,) + (1,) * (t.ndim - 1)).to(t.dtype)


def _edge_message(s_kept, normalize_tensors, dtype):
    if normalize_tensors:
        s_norm = torch.linalg.vector_norm(s_kept, dim=-1, keepdim=True)
        s_kept = s_kept / torch.where(s_norm == 0, torch.ones_like(s_norm),
                                      s_norm)
    return torch.diag_embed(s_kept).to(dtype)


def apply_one_site(state: BatchedState, gate: torch.Tensor,
                   idx=None) -> BatchedState:
    """Batched 1-site gates: gate [d', d] broadcast over vertices, or
    [V, d', d] per vertex; with ``idx``, [B, d', d] at those positions."""
    g = gate.to(state.tensors.dtype)
    eq = "v...d,pd->v...p" if g.ndim == 2 else "v...d,vpd->v...p"
    if idx is None:
        return state._replace(tensors=torch.einsum(eq, state.tensors, g))
    idx = _index(idx, state.tensors.device)
    sub = torch.einsum(eq, state.tensors[idx], g)
    return state._replace(tensors=state.tensors.index_copy(0, idx, sub))


def _su_prep(t, slot, roots_slice, chi, d):
    """Absorb √env on the non-gate legs and matricize to [B, M, χ·d]."""
    D = t.ndim - 2
    for i, k in enumerate(k for k in range(D) if k != slot):
        t = _absorb(t, roots_slice[i], 1 + k)
    perm = [0] + [1 + k for k in range(D) if k != slot] + [1 + slot, D + 1]
    tp = t.permute(perm)
    M = int(np.prod(tp.shape[1:D]))
    return tp.reshape(tp.shape[0], M, chi * d)


def _su_finish(q, fac, inv_roots, slot, t_ref, chi, d):
    """Rebuild the site tensor: Q·factor, undo the transpose, absorb 1/√env."""
    D = t_ref.ndim - 2
    B = q.shape[0]
    t = q @ fac.reshape(B, fac.shape[1], d * chi)  # [B, M, d·χ]
    other = [t_ref.shape[1 + kk] for kk in range(D) if kk != slot]
    t = t.reshape((B,) + tuple(other) + (d, chi))
    t = torch.movedim(t, -1, -2)  # [..., χ(slot), d]
    order = [kk for kk in range(D) if kk != slot] + [slot]
    inv_perm = [0] + [1 + order.index(kk) for kk in range(D)] + [D + 1]
    t = t.permute(inv_perm)
    it = iter(inv_roots)
    for kk in range(D):
        if kk == slot:
            continue
        # inv_root is hermitian: contracting the bra leg with it equals
        # the reference's dag(inv_sqrt_env) contraction
        t = _absorb(t, next(it), 1 + kk)
    return t


def _cat(xs, dim: int) -> torch.Tensor:
    """``torch.cat``, less the copy of a lone tensor."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)


def _bucket_gates(gate: torch.Tensor, sizes) -> list:
    """Each bucket's gate, for buckets of ``sizes`` edges: a shared gate
    [d, d, d, d] as it is, per-edge gates [ΣB, d, d, d, d] (stacked in
    bucket order) sliced into each bucket's [B, d, d, d, d]."""
    if gate.ndim == 4:
        return [gate] * len(sizes)
    return list(torch.split(gate, list(sizes)))


def apply_color_group(state: BatchedState, buckets, gate: torch.Tensor,
                      chi: int, cutoff: float, normalize_tensors: bool = True):
    """Apply a 2-site gate to every edge of a colour group
    (`2dIsing_dynamics.jl:25-28`, batched): one gate [d, d, d, d] shared by
    every edge, or per-edge gates [ΣB, d, d, d, d] stacked in bucket order.
    All slot-pair buckets of the group share ONE stacked roots call, ONE
    stacked QR and ONE stacked split.  Bucket indices may be static tuples
    or device tensors.  Errors come back bucket by bucket.  On CUDA the
    update replays as CUDA graphs where its route allows (``su_graphs``)."""
    with span("su.group"):
        dev = state.tensors.device
        group = [(b.slot_u, b.slot_v, _index(b.u_idx, dev),
                  _index(b.v_idx, dev)) for b in buckets]
        if not group:
            return state, torch.zeros((0,), device=dev)
        _GROUP_BUCKETS.add(len(group))
        return _group_update(state, group, gate, chi, cutoff,
                             normalize_tensors)


def _group_update(state, group, gate, chi, cutoff, normalize_tensors):
    """The simple update of the buckets ``group`` ([(slot_u, slot_v, u_idx,
    v_idx)]) (`simple_update.jl:17-68`), written into one copy of the state;
    the kept spectrum becomes each edge's message (`apply_gates.jl:108-115`).
    Returns (state, errors)."""
    results = su_graphs.updates(state, group, gate, chi, cutoff,
                                normalize_tensors)
    with span("su.finish"):
        tensors = state.tensors.clone()
        messages = state.messages.clone()
        for (su, sv, u_idx, v_idx), (tu_new, tv_new, msg, _err) in zip(
                group, results):
            _write_back(tensors, messages, u_idx, v_idx, su, sv, tu_new,
                        tv_new, msg)
        # a copy: a graph's outputs are overwritten by its next replay
        err = torch.cat([r[3] for r in results])
    return BatchedState(tensors, messages), err


def _gather(state, group):
    """The buckets' endpoint rows: ``items`` [(slot_u, slot_v, tu, tv, mu,
    mv)], as the update's stretches take them."""
    return [(su, sv, state.tensors[u_idx], state.tensors[v_idx],
             state.messages[u_idx], state.messages[v_idx])
            for su, sv, u_idx, v_idx in group]


# The update on gathered rows runs in three stretches with no host read,
# between which the Jacobi kernels run: K1 in `_pseudo_roots` after the
# first, K2 in `_eigh` (the Gram split) after the second.  `_group_core`
# runs them in that order through a runner: eagerly by default, replayed as
# CUDA graphs by `su_graphs`.


def _su_env(items):
    """Stretch 0: every bucket's environments but the gate's bond, stacked
    [2(D-1), ΣB, χ, χ] for one roots call."""
    envs = []
    for su, sv, _tu, _tv, mu, mv in items:
        D = mu.shape[1]
        envs.append(torch.stack([mu[:, k] for k in range(D) if k != su]
                                + [mv[:, k] for k in range(D) if k != sv],
                                dim=0))
    return _cat(envs, 1)


def _su_reduce(items, roots_all, gate, chi, shifted=None):
    """Stretch 1: absorb √env on each endpoint's other legs, QR-reduce every
    endpoint in one stacked batch, gate each edge's two R factors (each
    bucket its own slice of per-edge gates, :func:`_bucket_gates`).
    Returns (q_all, r_all, mat [ΣB, r·d, r·d]); ``shifted`` as for
    :func:`_qr_split`."""
    D, d = items[0][2].ndim - 2, items[0][2].shape[-1]
    with span("su.qr"):
        tps, off = [], 0
        for su, sv, tu, tv, _mu, _mv in items:
            roots = roots_all[:, off: off + tu.shape[0]]
            tps += [_su_prep(tu, su, roots[: D - 1], chi, d),
                    _su_prep(tv, sv, roots[D - 1:], chi, d)]
            off += tu.shape[0]
        q_all, r_all, _ = _qr_reduce(torch.cat(tps, dim=0), shifted)
    with span("su.theta"):
        mats, off = [], 0
        gates = _bucket_gates(gate, [it[2].shape[0] for it in items])
        for (_su, _sv, tu, _tv, _mu, _mv), g in zip(items, gates):
            B = tu.shape[0]
            ru = r_all[2 * off: 2 * off + B].reshape(B, -1, chi, d)
            rv = r_all[2 * off + B: 2 * off + 2 * B].reshape(B, -1, chi, d)
            mats.append(_theta(ru, rv, g))
            off += B
    return q_all, r_all, _cat(mats, 0)


def _su_truncate(uu, s, vh, chi, cutoff):
    """Truncate the split (U, s, V†) of the gated two-site matrices
    [B, r1·d, r2·d]: relative discarded Σσ² ≤ cutoff, cap χ, inside the
    static buffer.  Returns (x [B, r1·d, χ], y [B, χ, r2·d], s_kept [B, χ],
    err [B])."""
    p = s * s
    total = p.sum(-1, keepdim=True)
    safe_total = torch.where(total == 0, torch.ones_like(total), total)
    tail = torch.flip(torch.cumsum(torch.flip(p, [-1]), -1), [-1])
    keep = (tail / safe_total > cutoff).clone()
    keep[..., 0] = True
    keep &= torch.arange(s.shape[-1], device=s.device)[None, :] < chi
    err = torch.where(keep, torch.zeros_like(p), p).sum(-1) / safe_total[:, 0]
    k = min(chi, s.shape[-1])
    s_kept = torch.where(keep, s, torch.zeros_like(s))[..., :k]
    uu = uu[..., :k]
    vh = vh[..., :k, :]
    if k < chi:  # bond smaller than the buffer: zero-pad
        B, padn = s.shape[0], chi - k
        s_kept = torch.cat([s_kept, s_kept.new_zeros(B, padn)], dim=-1)
        uu = torch.cat([uu, uu.new_zeros(B, uu.shape[1], padn)], dim=-1)
        vh = torch.cat([vh, vh.new_zeros(B, padn, vh.shape[2])], dim=-2)
    sqrt_s = torch.sqrt(s_kept).to(uu.dtype)
    return uu * sqrt_s[:, None, :], sqrt_s[:, :, None] * vh, s_kept, err


def _su_rebuild(items, split, q_all, r_all, inv_roots_all, chi,
                normalize_tensors, deferred):
    """Stretch 2, after the truncated split (:func:`_su_truncate`): rebuild
    both endpoints of every edge (Q·factor, 1/√env), the kept spectrum as
    the edge message.  Returns [(tu_new, tv_new, msg, err)] per bucket."""
    x_all, y_all, s_all, err_all = split
    D, d = items[0][2].ndim - 2, items[0][2].shape[-1]
    r1, r2 = x_all.shape[1] // d, y_all.shape[2] // d
    results, off = [], 0
    with span("su.finish"):
        for su, sv, tu, tv, mu, _mv in items:
            B = tu.shape[0]
            sl = slice(off, off + B)
            inv_roots = inv_roots_all[:, sl]
            q_u = q_all[2 * off: 2 * off + B]
            q_v = q_all[2 * off + B: 2 * off + 2 * B]
            fac_u = x_all[sl].reshape(B, r1, d, chi)
            fac_v = y_all[sl].transpose(1, 2).reshape(B, r2, d, chi)
            if deferred:  # q is the raw tall matrix; undo R on the factor
                r_u = r_all[2 * off: 2 * off + B]
                r_v = r_all[2 * off + B: 2 * off + 2 * B]
                fac_u = _rinv_left(r_u, fac_u.reshape(B, r1, d * chi)
                                   ).reshape(B, r1, d, chi)
                fac_v = _rinv_left(r_v, fac_v.reshape(B, r2, d * chi)
                                   ).reshape(B, r2, d, chi)
            tu_new = _su_finish(q_u, fac_u, inv_roots[: D - 1], su, tu, chi,
                                d)
            tv_new = _su_finish(q_v, fac_v, inv_roots[D - 1:], sv, tv, chi,
                                d)
            msg = _edge_message(s_all[sl], normalize_tensors, mu.dtype)
            if normalize_tensors:
                tu_new = _normalize_rows(tu_new)
                tv_new = _normalize_rows(tv_new)
            results.append((tu_new, tv_new, msg, err_all[sl]))
            off += B
    return results


def _group_core(items, gate, chi, cutoff, normalize_tensors, run=_Eager):
    """The update of the buckets' gathered rows ``items``: ONE stacked roots
    call, ONE stacked QR and ONE stacked split across them.  ``run.stretch(i,
    fn)`` runs stretch ``i`` (``fn`` returns a tuple of tensors) and
    ``run.fixed(name, x)`` places a kernel's output ``x`` where the next
    stretch reads it (:class:`_Eager`, or ``su_graphs``' replays).  Returns
    [(tu_new, tv_new, msg, err)] in bucket order."""
    (env,) = run.stretch(0, lambda: (_su_env(items),))
    with span("su.roots"):
        roots, inv_roots = _pseudo_roots(env)
    roots = run.fixed("roots", roots)
    inv_roots = run.fixed("inv_roots", inv_roots)
    gram = _svd_alg() == "gram"

    def reduce():
        shifted = []
        q_all, r_all, mat = _su_reduce(items, roots, gate, chi, shifted)
        return ((q_all, r_all, mat) + ((_gram(mat),) if gram else ())
                + tuple(shifted))

    q_all, r_all, mat, *rest = run.stretch(1, reduce)
    h, shifted = rest[:int(gram)], rest[int(gram):]
    for took in shifted:  # CholeskyQR's passes: the matrices shifted
        _CHOL_FACTORS.add(took.numel())
        _CHOL_SHIFTED.add_device(took)
    with span("su.split"):
        factors = _eigh(h[0]) if gram else _svd(mat)
    factors = [run.fixed(f"split{i}", f) for i, f in enumerate(factors)]

    def rebuild():
        split = _su_truncate(*(_gram_factors(mat, *factors) if gram
                               else factors), chi, cutoff)
        return tuple(t for res in _su_rebuild(
            items, split, q_all, r_all, inv_roots, chi, normalize_tensors,
            _qr_alg() == "defer") for t in res)

    flat = run.stretch(2, rebuild)
    return [flat[i: i + 4] for i in range(0, len(flat), 4)]


def _select_rows(old, new, inv, wr):
    """Write-back without scatter: ``old[p] <- new[inv[p]] where wr[p]``.

    ``torch.where`` is an exact select, so every row carries either its
    exact old bits or the exact new lane."""
    m = wr.reshape(wr.shape + (1,) * (old.ndim - 1))
    return torch.where(m, new[inv].to(old.dtype), old)


def apply_color_group_masked(
    state: BatchedState,
    slot_pairs,  # tuple of (slot_u, slot_v) per canonical bucket
    tables,  # per bucket: dict of index tensors u_tab/v_tab [B], valid [B],
    #          u_inv/u_wr/v_inv/v_wr [V] (inverse-select write-back)
    gate: torch.Tensor,
    chi: int,
    cutoff: float,
    normalize_tensors: bool = True,
):
    """Colour-group apply with index tables passed as tensors, the
    reference's body of a layer that scans over colour groups.  Canonical
    buckets are padded to a uniform per-group shape: pad rows gather vertex
    0, compute garbage, and write nothing back (:func:`_select_rows`);
    their errors read 0.  Same update as :func:`apply_color_group`
    (:func:`_group_core`, eager: the rows come from padded tables); only
    the gather and the write-back differ.
    (``make_layer_fn(scan_groups=True)`` runs the unrolled layer: this is
    the entry point for callers holding such tables.)"""
    items = []
    for (slot_u, slot_v), tb in zip(slot_pairs, tables):
        u_idx, v_idx = tb["u_tab"], tb["v_tab"]
        items.append((
            slot_u, slot_v,
            state.tensors[u_idx], state.tensors[v_idx],
            state.messages[u_idx], state.messages[v_idx],
        ))
    results = _group_core(items, gate, chi, cutoff, normalize_tensors)
    tensors, messages = state.tensors, state.messages.clone()
    errs = []
    for (slot_u, slot_v), tb, (tu_new, tv_new, msg, err) in zip(
        slot_pairs, tables, results
    ):
        tensors = _select_rows(tensors, tu_new, tb["u_inv"], tb["u_wr"])
        tensors = _select_rows(tensors, tv_new, tb["v_inv"], tb["v_wr"])
        messages[:, slot_u] = _select_rows(messages[:, slot_u], msg,
                                           tb["u_inv"], tb["u_wr"])
        messages[:, slot_v] = _select_rows(messages[:, slot_v], msg,
                                           tb["v_inv"], tb["v_wr"])
        errs.append(torch.where(tb["valid"], err, torch.zeros_like(err)))
    return BatchedState(tensors, messages), torch.cat(errs)


# ---------------------------------------------------------------------------
# batched local expectation values
# ---------------------------------------------------------------------------


def local_rdms(spec: BatchedGraphSpec, state: BatchedState) -> torch.Tensor:
    """Unnormalized 1-site RDMs ρ[v, s, s'] from the BP environments."""
    D = spec.degree
    acc = state.tensors
    for k in range(D):
        acc = _absorb(acc, state.messages[:, k], 1 + k)
    lab = "".join(_LETTERS[k] for k in range(D))
    return torch.einsum(f"v{lab}s,v{lab}z->vsz", acc, state.tensors.conj())


def local_expectations(spec: BatchedGraphSpec, state: BatchedState,
                       op) -> torch.Tensor:
    """⟨op⟩ for every vertex (single-site observables, `expect.jl:58-83`)."""
    with span("readout"):
        rho = local_rdms(spec, state)  # [V, s(ket), z(bra)]
        op = torch.as_tensor(op).to(dtype=rho.dtype, device=rho.device)
        numer = torch.einsum("vsz,zs->v", rho, op)
        denom = torch.einsum("vss->v", rho)
        return numer / denom


def _site_transfer(state: BatchedState, idx: torch.Tensor, skip_slot: int):
    """E[b, l, l', s, s'] at the given vertices: ψ ψ̄ with all incoming
    messages absorbed except on ``skip_slot`` (open site legs)."""
    D = state.degree
    t = state.tensors[idx]
    m = state.messages[idx]
    acc = t
    for k in range(D):
        if k != skip_slot:
            acc = _absorb(acc, m[:, k], 1 + k)
    lab = [_LETTERS[k] for k in range(D)]
    acc_lab, conj_lab = list(lab), list(lab)
    acc_lab[skip_slot] = "o"
    conj_lab[skip_slot] = "p"
    eq = f"v{''.join(acc_lab)}s,v{''.join(conj_lab)}z->vopsz"
    return torch.einsum(eq, acc, t.conj())


@functools.lru_cache(maxsize=32)
def _bond_tables(spec: BatchedGraphSpec, device: torch.device):
    """The edges bucketed by (slot_u, slot_v), each bucket's endpoint
    indices as device tensors, and the permutation that puts the buckets'
    concatenated results back into ``spec.edges`` order: built once per
    (spec, device)."""
    buckets: dict = {}
    for pos, (iu, iv, su, sv) in enumerate(spec.edges):
        buckets.setdefault((su, sv), []).append((pos, iu, iv))
    tables, order = [], []
    for (su, sv), entries in sorted(buckets.items()):
        tables.append((su, sv, _index([e[1] for e in entries], device),
                       _index([e[2] for e in entries], device)))
        order += [e[0] for e in entries]
    return tuple(tables), _index(np.argsort(order), device)


def _bond_transfers(spec: BatchedGraphSpec, state: BatchedState):
    """[(E_u, E_v)] per bucket and the edge-order permutation."""
    buckets, inv = _bond_tables(spec, state.tensors.device)
    return [(_site_transfer(state, u_idx, su), _site_transfer(state, v_idx, sv))
            for su, sv, u_idx, v_idx in buckets], inv


def bond_expectations(spec: BatchedGraphSpec, state: BatchedState, op1,
                      op2) -> torch.Tensor:
    """⟨op1 ⊗ op2⟩ for every graph edge, in ``spec.edges`` order (the BP
    Steiner-tree contraction of `expect.jl:58-83` specialized to an edge,
    batched over each (slot_u, slot_v) bucket of edges)."""
    transfers, inv = _bond_transfers(spec, state)
    vals = []
    for eu, ev in transfers:
        o1 = torch.as_tensor(op1).to(dtype=eu.dtype, device=eu.device)
        o2 = torch.as_tensor(op2).to(dtype=eu.dtype, device=eu.device)
        numer = torch.einsum("bopsz,zs,bopcx,xc->b", eu, o1, ev, o2)
        denom = torch.einsum("bopss,bopcc->b", eu, ev)
        vals.append(numer / denom)
    return torch.cat(vals)[inv]


def bond_rdms(spec: BatchedGraphSpec, state: BatchedState) -> torch.Tensor:
    """Trace-normalized 2-site RDMs ρ[e, s, s', c, c'] for every graph edge
    (`rdm.jl:49-70` with alg="bp" on an edge's endpoints).  Index order:
    (ket_u, bra_u, ket_v, bra_v), edges in ``spec.edges`` order."""
    transfers, inv = _bond_transfers(spec, state)
    rhos = []
    for eu, ev in transfers:
        rho = torch.einsum("bopsz,bopcx->bszcx", eu, ev)
        tr = torch.einsum("bsscc->b", rho)
        rhos.append(rho / tr[:, None, None, None, None])
    return torch.cat(rhos)[inv]
