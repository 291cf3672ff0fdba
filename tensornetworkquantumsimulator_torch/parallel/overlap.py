"""Batched ⟨ψ|ϕ⟩ overlaps: BP on the two-layer sandwich.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.overlap``
(`inner.jl:53-98`): the sandwich never materializes.  The flooding-BP
message update is the engine's, with the bra layer threaded through the
contraction in place of ``conj(ket)`` (the only place the two layers
differ), so a Loschmidt echo ⟨ψ(0)|ψ(t)⟩, a truncation fidelity, the
purity of a density-matrix state or its per-site ⟨P⟩
(:func:`make_pauli_expectation_fn`) costs one fixed-point loop.

Sandwich messages are NOT hermitian (the two layers differ), so message
normalization skips the hermitization the norm BP applies.

Overlaps are returned as ``(log_abs, phase)`` (``exp(log_abs + i·phase)``):
overlaps of large lattices under- or overflow any float; callers
exponentiate differences, e.g. a normalized echo
``exp(log|⟨ψ|ϕ⟩| − ½log⟨ψ|ψ⟩ − ½log⟨ϕ|ϕ⟩)``.  The phase is a sum of
principal values, meaningful modulo 2π.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .convert import _numpy_dtype
from .engine import (
    _LETTERS,
    _absorb,
    _fixed_point,
    _normalize_messages,
    BatchedState,
    default_batched_tolerance,
    graph_tables,
    identity_messages,
    outgoing_messages_einsum,
)
from .structure import BatchedGraphSpec


def _sandwich_bp(spec, t_ket, t_bra_conj, messages, maxiter, tolerance,
                 damping, tables=None):
    """Sandwich BP to its fixed point, with the norm BP's loop semantics.
    The reference's ``_sandwich_outgoing`` is the engine's message update
    with the (pre-conjugated) bra layer closing the site leg."""
    if tables is None:
        tables = graph_tables(spec, t_ket.device)

    def iterate(m):
        m_out = outgoing_messages_einsum(t_ket, m, t_bra_conj)
        gathered = m_out[tables.nbr, tables.nbr_slot]
        return _normalize_messages(gathered, tables.mask, hermitize_=False)

    return _fixed_point(iterate, messages, tables.mask, maxiter, tolerance,
                        damping)


def sandwich_sweeps(spec, t_ket, t_bra_conj, messages, num_sweeps,
                    damping: float = 0.0, tables=None):
    """``num_sweeps`` sandwich-BP sweeps as a plain loop that autograd can
    cross: the fixed-count counterpart of the tolerance loop in
    :func:`batched_inner` (used by an overlap-penalty loss)."""
    if tables is None:
        tables = graph_tables(spec, t_ket.device)
    m = messages
    for _ in range(num_sweeps):
        m_out = outgoing_messages_einsum(t_ket, m, t_bra_conj)
        new = _normalize_messages(m_out[tables.nbr, tables.nbr_slot],
                                  tables.mask, hermitize_=False)
        if damping:
            new = _normalize_messages((1 - damping) * new + damping * m,
                                      tables.mask, hermitize_=False)
        m = new
    return m


def sandwich_logz(spec, t_ket, t_bra_conj, m):
    """Z_BP of the sandwich at message state ``m`` as ``(log_abs, phase)``
    (vertex/edge scalar algebra of `abstractbeliefpropagationcache.
    jl:252-267` on the two-layer network)."""
    D = spec.degree
    acc = t_ket
    for k in range(D):
        acc = _absorb(acc, m[:, k], 1 + k)
    lab = "".join(_LETTERS[k] for k in range(D))
    zv = torch.einsum(f"v{lab}s,v{lab}s->v", acc, t_bra_conj)
    edges = torch.as_tensor(np.asarray(spec.edges, dtype=np.int64),
                            device=m.device)
    m_at_v = m[edges[:, 1], edges[:, 3]]
    m_at_u = m[edges[:, 0], edges[:, 2]]
    se = torch.einsum("eab,eab->e", m_at_v, m_at_u)
    cdtype = torch.promote_types(t_ket.dtype, torch.complex64)
    lzv = torch.log(zv.to(cdtype))
    lse = torch.log(se.to(cdtype))
    return lzv.real.sum() - lse.real.sum(), lzv.imag.sum() - lse.imag.sum()


def batched_inner(
    spec: BatchedGraphSpec,
    psi: BatchedState,
    phi: BatchedState,
    *,
    maxiter: int = 50,
    tolerance: float | None = None,
    damping: float = 0.0,
):
    """Sandwich-BP overlap (`inner.jl:53-98`, alg="bp"): ``psi`` is the ket
    and ``phi`` is conjugated, i.e. this returns Σ ψ(x)·conj(ϕ(x)) = ⟨ϕ|ψ⟩
    as ``(log_abs, phase)``, two 0-dim real tensors on the states' device."""
    t_ket = psi.tensors
    t_bra_conj = phi.tensors.conj()
    if tolerance is None:
        tolerance = default_batched_tolerance(t_ket.dtype)
    tables = graph_tables(spec, t_ket.device)
    m0 = identity_messages(spec.num_vertices, spec.degree, t_ket.shape[1],
                           t_ket.dtype, t_ket.device)
    m = _sandwich_bp(spec, t_ket, t_bra_conj, m0, maxiter, tolerance,
                     damping, tables)
    # Z_BP = Π_v z_v / Π_e s_e on the sandwich
    return sandwich_logz(spec, t_ket, t_bra_conj, m)


def make_pauli_expectation_fn(
    spec: BatchedGraphSpec,
    chi: int,
    dtype: torch.dtype,
    ops: tuple = ("Z",),
    *,
    maxiter: int = 50,
    tolerance: float | None = None,
):
    """Per-site ⟨P⟩ = Tr[ρP_v]/Tr[ρ] on a batched density-matrix
    ("PauliRho", d=4) state.

    The linear functional Tr[ρ·⊗X_v] is the sandwich overlap against a
    bond-1 product bra (trace vector [1,0,0,0] per site,
    `measure.pauli_expectation`); one sandwich-BP fixed point serves every
    site and every op: each value is a local-scalar ratio with the bra's
    site vector swapped to the Pauli basis vector (exact on trees, BP
    otherwise).  Returns ``fn(state) -> {op: [V] real tensor}``."""
    basis = {"I": 0, "X": 1, "Y": 2, "Z": 3}
    V, D = spec.num_vertices, spec.degree
    if tolerance is None:
        tolerance = default_batched_tolerance(dtype)
    npdt = _numpy_dtype(dtype)

    def _bra(vec4):
        t = np.zeros((V,) + (chi,) * D + (4,), dtype=npdt)
        t[(slice(None),) + (0,) * D] = np.asarray(vec4, dtype=npdt)
        return torch.from_numpy(np.conj(t))  # the bra enters conjugated

    host = {"trace": _bra([1.0, 0, 0, 0])}
    host.update({op: _bra(np.eye(4)[basis[op.upper()]]) for op in ops})
    on_device: dict = {}  # device -> (bras, graph tables), built once
    lab = "".join(_LETTERS[k] for k in range(D))

    def fn(state: BatchedState):
        t_ket = state.tensors
        dev = t_ket.device
        if dev not in on_device:
            on_device[dev] = ({k: b.to(dev) for k, b in host.items()},
                              graph_tables(spec, dev))
        bras, tables = on_device[dev]
        m0 = identity_messages(V, D, chi, t_ket.dtype, dev)
        m = _sandwich_bp(spec, t_ket, bras["trace"], m0, maxiter, tolerance,
                         0.0, tables)
        acc = t_ket
        for k in range(D):
            acc = _absorb(acc, m[:, k], 1 + k)
        eq = f"v{lab}s,v{lab}s->v"
        zv = torch.einsum(eq, acc, bras["trace"])
        return {op: (torch.einsum(eq, acc, bras[op]) / zv).real for op in ops}

    return fn


def batched_purity(
    spec: BatchedGraphSpec,
    state: BatchedState,
    *,
    log2: bool = False,
    maxiter: int = 50,
    tolerance: float | None = None,
):
    """Tr[ρ²]/Tr[ρ]² of a batched density-matrix ("PauliRho", d=4) state.

    With ρ a ⊗-network of Pauli coefficients c: Tr[ρ²] = ‖c‖²/2ⁿ (one
    self-sandwich fixed point) and Tr[ρ] is the overlap against the bond-1
    trace-vector product bra, both in log space, so ``log2=True`` returns
    log₂ of the value (finite at any size; the second Rényi entropy is its
    negation) while the default exponentiates."""
    t = state.tensors
    V, D = spec.num_vertices, spec.degree
    la, _ = batched_inner(spec, state, state, maxiter=maxiter,
                          tolerance=tolerance)
    tr_t = torch.zeros_like(t)
    tr_t[(slice(None),) + (0,) * D + (0,)] = 1.0
    lt, _ = batched_inner(spec, state, BatchedState(tr_t, state.messages),
                          maxiter=maxiter, tolerance=tolerance)
    log2p = (la - V * math.log(2.0) - 2.0 * lt) / math.log(2.0)
    return log2p if log2 else 2.0 ** log2p


def batched_loschmidt_echo(
    spec: BatchedGraphSpec,
    psi0: BatchedState,
    psit: BatchedState,
    log_norm0=None,
    **kwargs,
):
    """Normalized echo |⟨ψ₀|ψ_t⟩| / (‖ψ₀‖·‖ψ_t‖) as ``(log_abs, phase)``.

    The phase follows the ⟨ψ₀|ψ_t⟩ = Σ conj(ψ₀(x))·ψ_t(x) numerator
    (:func:`batched_inner` conjugates its SECOND argument, so ψ_t goes
    first).  ``log_norm0`` optionally carries a precomputed log⟨ψ₀|ψ₀⟩: on
    a trajectory it never changes, so computing it once saves a third of
    each step's fixed-point work."""
    l01, p01 = batched_inner(spec, psit, psi0, **kwargs)
    if log_norm0 is None:
        log_norm0, _ = batched_inner(spec, psi0, psi0, **kwargs)
    ltt, _ = batched_inner(spec, psit, psit, **kwargs)
    return l01 - 0.5 * log_norm0 - 0.5 * ltt, p01


def _sharded_sandwich(plan, t_ket, t_bra_conj, maxiter, tolerance):
    """Per-shard sandwich-BP fixed point from identity messages: the halo
    fixed point with the bra layer threaded through and no hermitization
    (sandwich messages are not hermitian)."""
    from .sharding import _bp_fixed_point

    D = t_ket[0].ndim - 2
    m0 = [identity_messages(t.shape[0], D, t.shape[1], t.dtype, t.device)
          for t in t_ket]
    return _bp_fixed_point(plan, t_ket, m0, maxiter, tolerance,
                           t_bra_conj=t_bra_conj, hermitize=False)


def _absorbed(t_ket, messages):
    acc = t_ket
    for k in range(t_ket.ndim - 2):
        acc = _absorb(acc, messages[:, k], 1 + k)
    return acc


def make_sharded_inner(sspec, mesh, *, axis: str = "v", maxiter: int = 50,
                       tolerance: float | None = None):
    """Sandwich overlap of two sharded states: ``fn(psi, phi) ->
    (log_abs, phase)`` of Σ ψ(x)·conj(ϕ(x)) = ⟨ϕ|ψ⟩ — the SAME conjugation
    convention as :func:`batched_inner` (the second argument is
    conjugated) — with neither state ever gathered.

    On a ``sharding.ShardedBPSpec`` strip sharding: the sandwich fixed
    point runs with the halo exchange, vertex scalars are shard-local, and
    edge scalars use the bond-bucket tables (one ``ppermute`` per
    cross-shard direction bucket); one ``psum`` sums the logs.  The two
    results are 0-dim tensors on the mesh's first device."""
    from .sharded_layer import strip_bond_buckets
    from .sharding import strip_plan

    plan = strip_plan(sspec, mesh, axis)
    buckets = strip_bond_buckets(sspec, mesh, axis)
    lab = "".join(_LETTERS[k] for k in range(sspec.spec.degree))

    def inner_fn(psi, phi):
        t_ket = psi.tensors
        t_bra_conj = [t.conj() for t in phi.tensors]
        tol = (tolerance if tolerance is not None
               else default_batched_tolerance(t_ket[0].dtype))
        m = _sharded_sandwich(plan, t_ket, t_bra_conj, maxiter, tol)
        cdtype = torch.promote_types(t_ket[0].dtype, torch.complex64)
        parts = []
        for s, (t, b) in enumerate(zip(t_ket, t_bra_conj)):
            zv = torch.einsum(f"v{lab}s,v{lab}s->v", _absorbed(t, m[s]), b)
            lzv = torch.log(zv.to(cdtype))
            parts.append([lzv.real.sum(), lzv.imag.sum()])
        for b in buckets:
            mv = b.partner(mesh, [x[:, b.slot_v] for x in m])
            for s in range(len(t_ket)):
                if b.n[s]:
                    mu = m[s][b.u[s], b.slot_u]  # incoming into u
                    lse = torch.log(torch.einsum("eab,eab->e", mu, mv[s])
                                    .to(cdtype))
                    parts[s][0] = parts[s][0] - lse.real.sum()
                    parts[s][1] = parts[s][1] - lse.imag.sum()
        total = mesh.psum([torch.stack(p) for p in parts], axis)[0]
        return total[0], total[1]

    return inner_fn


def make_sharded_pauli_expectations(
    sspec, mesh, chi: int, dtype, ops: tuple = ("Z",), *,
    axis: str = "v", maxiter: int = 50, tolerance: float | None = None,
):
    """Per-site Tr[ρP_v]/Tr[ρ] on a sharded density-matrix ("PauliRho",
    d=4) state — the sharded counterpart of
    :func:`make_pauli_expectation_fn`.  One sharded sandwich fixed point
    against the bond-1 trace bra (halo ``ppermute``s only); every per-site
    value is a local scalar ratio, so the readout itself needs no
    exchange.  Returns ``fn(sstate) -> {op: [V] real tensor}`` on the
    mesh's first device."""
    from .sharding import strip_plan

    plan = strip_plan(sspec, mesh, axis)
    spec = sspec.spec
    D = spec.degree
    Vl = spec.num_vertices // sspec.num_shards
    basis = {"I": 0, "X": 1, "Y": 2, "Z": 3}
    if tolerance is None:
        tolerance = default_batched_tolerance(dtype)
    npdt = _numpy_dtype(dtype)

    def _bra(vec4):
        t = np.zeros((Vl,) + (chi,) * D + (4,), dtype=npdt)
        t[(slice(None),) + (0,) * D] = np.asarray(vec4, dtype=npdt)
        return torch.from_numpy(np.conj(t))  # the bra enters conjugated

    host = {"trace": _bra([1.0, 0, 0, 0])}
    host.update({op: _bra(np.eye(4)[basis[op.upper()]]) for op in ops})
    bras = [{k: b.to(d) for k, b in host.items()} for d in mesh.devices]
    lab = "".join(_LETTERS[k] for k in range(D))
    eq = f"v{lab}s,v{lab}s->v"

    def expect_fn(sstate):
        t_ket = sstate.tensors
        m = _sharded_sandwich(plan, t_ket, [b["trace"] for b in bras],
                              maxiter, tolerance)
        outs = {op: [] for op in ops}
        for s, t in enumerate(t_ket):
            acc = _absorbed(t, m[s])
            zv = torch.einsum(eq, acc, bras[s]["trace"])
            for op in ops:
                outs[op].append((torch.einsum(eq, acc, bras[s][op]) / zv).real)
        return {op: mesh.collect(v) for op, v in outs.items()}

    return expect_fn
