"""Batched arbitrary-distance two-point correlators on the BP path.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
correlations`` (`expect.jl:58-83`: the Steiner tree of two vertices is
their connecting path), beyond :func:`~.engine.local_expectations`
(distance 0) and :func:`~.engine.bond_expectations` (distance 1):

- the connecting paths are found host-side (BFS over the compiled spec's
  slot tables) when the function is built;
- every *interior* path vertex contributes a χ²×χ² transfer matrix (site
  leg traced against the identity, incoming BP messages absorbed on all
  non-path slots).  Interior entries are bucketed by their
  (slot_prev, slot_next) pattern, so ONE einsum per pattern builds every
  transfer matrix of that shape across all requested pairs at once;
- endpoints contribute χ²-vectors (observable applied to the site leg),
  bucketed by their single open slot;
- each pair's correlator is then a chain of batched matvecs through a
  gathered transfer table, one gather and one batched product per step
  (pairs padded to the longest path with an identity transfer), numerator
  and denominator riding the same chain as a doubled batch.  Per-entry
  max-abs rescaling of the shared transfer table keeps long float32 chains
  in range without touching the numer/denom ratio.

Cost scales as O(L·χ⁴) per pair: χ ≲ 32 territory; at χ=64 a single
transfer matrix is 128 MB and boundary-MPS correlators are the better
tool.

Index tables are built on the host once and copied to each device the
returned function meets once.  The ``jit`` argument of the reference's
factories is accepted and ignored.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from ..models.gates import _PAULIS
from .cuda_linalg import eigh_plain
from .engine import (
    _LETTERS,
    _absorb,
    _site_transfer,
    BatchedState,
    local_expectations,
)
from .structure import BatchedGraphSpec

__all__ = [
    "make_path_correlation_fn",
    "make_mutual_information_fn",
    "make_path_rdm_fn",
    "make_string_expectation_fn",
    "path_correlations",
    "shortest_path",
    "string_expectations",
]


def shortest_path(spec: BatchedGraphSpec, a, b) -> tuple[list, list]:
    """BFS shortest path a→b over the compiled slot tables (host-side).

    Returns ``(verts, slots)`` with ``verts`` a list of vertex positions
    (``verts[0] == pos(a)``, ``verts[-1] == pos(b)``) and ``slots[i]``
    the slot on ``verts[i]`` pointing toward ``verts[i+1]``."""
    ia, ib = spec.vertex_position(a), spec.vertex_position(b)
    if ia == ib:
        raise ValueError("path correlator needs two distinct vertices")
    prev: dict = {ia: None}
    q = deque([ia])
    while q and ib not in prev:
        u = q.popleft()
        for s in range(spec.degree):
            if spec.slot_mask[u][s]:
                w = spec.nbr[u][s]
                if w not in prev:
                    prev[w] = (u, s)
                    q.append(w)
    if ib not in prev:
        raise ValueError(f"vertices {a!r} and {b!r} are not connected")
    verts, slots = [ib], []
    while prev[verts[-1]] is not None:
        u, s = prev[verts[-1]]
        verts.append(u)
        slots.append(s)
    verts.reverse()
    slots.reverse()
    return verts, slots


def _open_two(state: BatchedState, idx, skip1: int, skip2: int):
    """The gathered tensors with incoming messages absorbed on every slot
    except the two path slots, and the einsum labels of ket and bra with
    (o, p) on ``skip1`` and (q, r) on ``skip2``."""
    D = state.degree
    t = state.tensors[idx]
    m = state.messages[idx]
    acc = t
    for k in range(D):
        if k != skip1 and k != skip2:
            acc = _absorb(acc, m[:, k], 1 + k)
    lab = [_LETTERS[k] for k in range(D)]
    acc_lab, conj_lab = list(lab), list(lab)
    acc_lab[skip1], conj_lab[skip1] = "o", "p"
    acc_lab[skip2], conj_lab[skip2] = "q", "r"
    return acc, t.conj(), "".join(acc_lab), "".join(conj_lab)


def _site_transfer2(state: BatchedState, idx, skip1: int, skip2: int):
    """Identity-traced transfer matrices at the given vertices: ψψ̄ with
    incoming messages absorbed on every slot except ``skip1``/``skip2``
    (the two path slots, left open) and the site leg traced.
    Returns ``E[b, o, p, q, r]`` with (o, p) = (ket, bra) legs on
    ``skip1`` and (q, r) on ``skip2``."""
    acc, tc, acc_lab, conj_lab = _open_two(state, idx, skip1, skip2)
    return torch.einsum(f"v{acc_lab}s,v{conj_lab}s->vopqr", acc, tc)


def _site_transfer2_op(state: BatchedState, idx, skip1: int, skip2: int, op):
    """Op-inserted variant of :func:`_site_transfer2`: the ``[d, d]`` site
    operator is applied between the ket and bra site legs instead of the
    identity trace.  Same index order ``E[b, o, p, q, r]``."""
    acc, tc, acc_lab, conj_lab = _open_two(state, idx, skip1, skip2)
    return torch.einsum(f"v{acc_lab}s,v{conj_lab}z,zs->vopqr", acc, tc, op)


def _build_path_tables(spec, pairs, paths):
    """Host-side tables of the path functions.

    Returns ``(paths, a_buckets, b_buckets, int_buckets, tab_t, n_int)``:
    endpoint entries bucketed by open slot (``{slot: [(pair, vertex)]}``),
    deduplicated interior entries bucketed by (slot_prev, slot_next)
    (``{(sp, sn): [(entry, vertex)]}``), and the per-pair interior chain
    ``tab_t [Lmax, P]`` (numpy int64; pad value ``n_int`` = identity)."""
    P = len(pairs)
    if P == 0:
        raise ValueError("need at least one vertex pair")
    if paths is None:
        paths = [shortest_path(spec, a, b) for a, b in pairs]
    a_entries, b_entries = [], []
    int_entries: list[tuple[int, int, int]] = []  # (vertex, slot_prev, slot_next)
    int_key: dict = {}
    Lmax = max(len(verts) - 2 for verts, _ in paths)
    tab = np.full((P, max(Lmax, 1)), -1, dtype=np.int64)
    for p, (verts, slots) in enumerate(paths):
        if len(verts) != len(slots) + 1 or len(verts) < 2:
            raise ValueError(f"malformed path for pair {pairs[p]!r}")
        a_entries.append((p, verts[0], slots[0]))
        b_entries.append((p, verts[-1], spec.nbr_slot[verts[-2]][slots[-1]]))
        for i in range(1, len(verts) - 1):
            slot_prev = spec.nbr_slot[verts[i - 1]][slots[i - 1]]
            key = (verts[i], slot_prev, slots[i])
            if key not in int_key:
                int_key[key] = len(int_entries)
                int_entries.append(key)
            tab[p, i - 1] = int_key[key]
    n_int = len(int_entries)
    tab[tab < 0] = n_int  # padding -> identity transfer
    a_buckets: dict = {}
    for p, v, s in a_entries:
        a_buckets.setdefault(s, []).append((p, v))
    b_buckets: dict = {}
    for p, v, s in b_entries:
        b_buckets.setdefault(s, []).append((p, v))
    int_buckets: dict = {}
    for j, (v, sp, sn) in enumerate(int_entries):
        int_buckets.setdefault((sp, sn), []).append((j, v))
    tab_t = np.ascontiguousarray(tab.T)  # [Lmax, P]
    return paths, a_buckets, b_buckets, int_buckets, tab_t, n_int


def _per_device(build: Callable) -> Callable:
    """``get(device)``: ``build(device)`` once per device."""
    cache: dict = {}

    def get(device):
        if device not in cache:
            cache[device] = build(device)
        return cache[device]

    return get


def _long(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.int64), device=device)


def _bucket_tensors(buckets: dict, device) -> list:
    """``{key: [(dest, vertex, ...)]}`` as ``[(key, vertex idx, dest idx,
    further columns...)]`` of device tensors, keys sorted."""
    out = []
    for key, entries in sorted(buckets.items()):
        cols = list(zip(*entries))
        out.append((key, _long(cols[1], device), _long(cols[0], device))
                   + tuple(_long(c, device) for c in cols[2:]))
    return out


def _interior_transfer_table(state, int_buckets, n_int, chi2, cdtype):
    """The shared interior chain table [n_int + 1, χ², χ²] (last row =
    identity pad): one `_site_transfer2` einsum per (slot_prev, slot_next)
    bucket (``int_buckets`` from :func:`_bucket_tensors`), with per-entry
    max-abs rescaling: each T multiplies numerator AND denominator (or a
    trace-normalized RDM), so the rescale never touches the reported value
    while keeping long float32 chains in range."""
    dev = state.tensors.device
    T = torch.zeros((n_int + 1, chi2, chi2), dtype=cdtype, device=dev)
    T[n_int] = torch.eye(chi2, dtype=cdtype, device=dev)
    for (sp, sn), idx, pos in int_buckets:
        mats = _site_transfer2(state, idx, sp, sn).reshape(-1, chi2, chi2)
        scale = mats.abs().amax(dim=(1, 2), keepdim=True)
        T[pos] = mats / torch.where(scale == 0, torch.ones_like(scale), scale)
    return T


def _as_op(op, cdtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(op)).to(dtype=cdtype, device=device)


def make_path_correlation_fn(
    spec: BatchedGraphSpec,
    pairs: Sequence[tuple],
    op1,
    op2=None,
    *,
    paths: Sequence[tuple[list, list]] | None = None,
    connected: bool = False,
    real_output: bool = False,
    jit: bool = True,
) -> Callable:
    """Build ``fn(state) -> [len(pairs)]`` of ⟨op1_a op2_b⟩ (BP alg).

    ``pairs`` are ``(a, b)`` vertex names at any graph distance ≥ 1;
    ``op1``/``op2`` are ``[d, d]`` site operators (``op2`` defaults to
    ``op1``).  ``paths`` overrides the BFS shortest paths with explicit
    ``(verts, slots)`` tuples (e.g. to route around a defect).  With
    ``connected=True`` the product ⟨op1_a⟩⟨op2_b⟩ of the single-site BP
    expectations is subtracted.  On loopy graphs the BP value depends on
    WHICH connecting path is contracted."""
    del jit
    op1 = np.asarray(op1)
    op2 = op1 if op2 is None else np.asarray(op2)
    paths, a_buckets, b_buckets, int_buckets, tab_t, n_int = (
        _build_path_tables(spec, pairs, paths)
    )
    P = len(pairs)
    tables = _per_device(lambda dev: (
        _bucket_tensors(a_buckets, dev), _bucket_tensors(b_buckets, dev),
        _bucket_tensors(int_buckets, dev), _long(tab_t, dev),
        _long([verts[0] for verts, _ in paths], dev),
        _long([verts[-1] for verts, _ in paths], dev)))

    def correlations(state: BatchedState) -> torch.Tensor:
        chi2 = state.chi * state.chi
        cdtype = state.tensors.dtype
        dev = state.tensors.device
        a_tab, b_tab, int_tab, chain, ia, ib = tables(dev)
        o1, o2 = _as_op(op1, cdtype, dev), _as_op(op2, cdtype, dev)

        def endpoints(tab, op):
            # χ²-vectors [P, χ²]: numerator (op applied) and denominator
            vn = torch.zeros((P, chi2), dtype=cdtype, device=dev)
            vd = torch.zeros((P, chi2), dtype=cdtype, device=dev)
            for s, idx, pos in tab:
                e = _site_transfer(state, idx, s)  # [B, o, p, s, z]
                vn[pos] = torch.einsum("bopsz,zs->bop", e, op).reshape(
                    -1, chi2)
                vd[pos] = torch.einsum("bopss->bop", e).reshape(-1, chi2)
            return torch.stack([vn, vd], dim=0)  # [2, P, χ²]

        m = endpoints(a_tab, o1)
        vb = endpoints(b_tab, o2)
        T = _interior_transfer_table(state, int_tab, n_int, chi2, cdtype)
        # numerator and denominator ride one chain, gathering each step's
        # transfer matrices ONCE (the two halves share indices)
        for idxs in chain:
            m = torch.einsum("kpi,pij->kpj", m, T[idxs])
        vals = torch.einsum("kpi,kpi->kp", m, vb)
        out = vals[0] / vals[1]
        if connected:
            z1 = local_expectations(spec, state, o1)
            z2 = local_expectations(spec, state, o2)
            out = out - z1[ia] * z2[ib]
        return out.real if real_output else out

    return correlations


def path_correlations(
    spec: BatchedGraphSpec,
    state: BatchedState,
    pairs: Sequence[tuple],
    op1,
    op2=None,
    **kwargs,
) -> torch.Tensor:
    """One-shot ⟨op1_a op2_b⟩ for the given vertex pairs (BP path alg).
    See :func:`make_path_correlation_fn` for options."""
    return make_path_correlation_fn(spec, pairs, op1, op2, **kwargs)(state)


def make_string_expectation_fn(
    spec: BatchedGraphSpec,
    strings: Sequence[tuple],
    *,
    real_output: bool = False,
    jit: bool = True,
) -> Callable:
    """Build ``fn(state) -> [len(strings)]`` of multi-site string
    expectations ⟨∏_i op_i⟩ (BP alg) for observables on MORE than two
    vertices whose Steiner tree is a path: parity strings ⟨Z Z … Z⟩, string
    order parameters ⟨Z X … X Z⟩, Wilson-line operators (`expect.jl:58-83`).

    Each string is ``(ops, verts)``: ``ops`` a string of Pauli letters
    (one per vertex) or a sequence of ``[d, d]`` matrices; ``verts`` the
    operator-carrying vertices *in path order*: consecutive entries are
    joined by BFS shortest paths and intermediate vertices carry the
    identity.  The combined walk must be vertex-disjoint (a path);
    branching vertex sets raise.

    Same transfer-chain design as :func:`make_path_correlation_fn`; the
    numerator and denominator chains no longer share every interior entry
    (op-inserted vs identity-traced), so each op-inserted transfer is
    rescaled by its OWN vertex's identity-traced scale: numerator and
    denominator then carry identical rescale factors per step and the
    ratio is untouched."""
    del jit
    op_mats: list[np.ndarray] = []
    op_key: dict = {}

    def op_id(mat: np.ndarray) -> int:
        k = (mat.shape, mat.dtype.str, mat.tobytes())
        if k not in op_key:
            op_key[k] = len(op_mats)
            op_mats.append(mat)
        return op_key[k]

    P = len(strings)
    if P == 0:
        raise ValueError("need at least one string observable")
    resolved = []  # (full_verts, full_slots, {pos: opid})
    for ops, verts in strings:
        if isinstance(ops, str):
            mats = [np.asarray(_PAULIS[c.upper()], np.complex128) for c in ops]
        else:
            mats = [np.asarray(o) for o in ops]
        if len(mats) != len(verts):
            raise ValueError(
                f"need one operator per vertex: got {len(mats)} ops for "
                f"{len(verts)} vertices"
            )
        if len(verts) < 2:
            raise ValueError(
                "string observables need >= 2 vertices; use "
                "local_expectations for single sites"
            )
        full_verts = [spec.vertex_position(verts[0])]
        full_slots: list[int] = []
        for a, b in zip(verts, verts[1:]):
            vs, ss = shortest_path(spec, a, b)
            full_verts += vs[1:]
            full_slots += ss
        if len(set(full_verts)) != len(full_verts):
            raise ValueError(
                "the string's walk revisits a vertex: only path-shaped "
                "Steiner trees run on the batched engine"
            )
        opid_at = {
            spec.vertex_position(v): op_id(m) for v, m in zip(verts, mats)
        }
        resolved.append((full_verts, full_slots, opid_at))

    # --- host-side bucket/table construction ---
    a_num: dict = {}   # (slot, opid) -> [(p, vertex)]
    a_den: dict = {}   # slot -> [(p, vertex)]
    b_num: dict = {}
    b_den: dict = {}
    den_entries: list[tuple] = []   # (vertex, slot_prev, slot_next)
    den_key: dict = {}
    num_entries: list[tuple] = []   # (vertex, slot_prev, slot_next, opid)
    num_key: dict = {}
    for full_verts, full_slots, opid_at in resolved:
        for i in range(1, len(full_verts) - 1):
            sp = spec.nbr_slot[full_verts[i - 1]][full_slots[i - 1]]
            sn = full_slots[i]
            dk = (full_verts[i], sp, sn)
            if dk not in den_key:
                den_key[dk] = len(den_entries)
                den_entries.append(dk)
            oid = opid_at.get(full_verts[i])
            if oid is not None:
                nk = (full_verts[i], sp, sn, oid)
                if nk not in num_key:
                    num_key[nk] = len(num_entries)
                    num_entries.append(nk)
    n_den, n_num = len(den_entries), len(num_entries)
    pad = n_den + n_num  # identity row
    Lmax = max(len(fv) - 2 for fv, _, _ in resolved)
    tab = np.full((P, max(Lmax, 1), 2), pad, dtype=np.int64)  # [.., (num, den)]
    for p, (full_verts, full_slots, opid_at) in enumerate(resolved):
        sa = full_slots[0]
        a_num.setdefault((sa, opid_at[full_verts[0]]), []).append(
            (p, full_verts[0])
        )
        a_den.setdefault(sa, []).append((p, full_verts[0]))
        sb = spec.nbr_slot[full_verts[-2]][full_slots[-1]]
        b_num.setdefault((sb, opid_at[full_verts[-1]]), []).append(
            (p, full_verts[-1])
        )
        b_den.setdefault(sb, []).append((p, full_verts[-1]))
        for i in range(1, len(full_verts) - 1):
            sp = spec.nbr_slot[full_verts[i - 1]][full_slots[i - 1]]
            sn = full_slots[i]
            j_den = den_key[(full_verts[i], sp, sn)]
            oid = opid_at.get(full_verts[i])
            # identity interiors share the den row in the num chain, so
            # their rescale factors cancel step-by-step by construction
            j_num = j_den if oid is None else n_den + num_key[
                (full_verts[i], sp, sn, oid)
            ]
            tab[p, i - 1] = (j_num, j_den)
    tab_t = np.ascontiguousarray(tab.transpose(1, 2, 0))  # [L, 2, P]
    den_buckets: dict = {}
    for j, (v, sp, sn) in enumerate(den_entries):
        den_buckets.setdefault((sp, sn), []).append((j, v))
    num_buckets: dict = {}
    for j, (v, sp, sn, oid) in enumerate(num_entries):
        num_buckets.setdefault((sp, sn, oid), []).append(
            (n_den + j, v, den_key[(v, sp, sn)])
        )
    tables = _per_device(lambda dev: (
        [_bucket_tensors(b, dev) for b in (a_num, a_den, b_num, b_den)],
        _bucket_tensors(den_buckets, dev), _bucket_tensors(num_buckets, dev),
        _long(tab_t, dev)))

    def string_fn(state: BatchedState) -> torch.Tensor:
        chi2 = state.chi * state.chi
        cdtype = state.tensors.dtype
        dev = state.tensors.device
        (a_n, a_d, b_n, b_d), den_tab, num_tab, chain = tables(dev)
        ops_dev = [_as_op(m, cdtype, dev) for m in op_mats]

        def endpoints(ntab, dtab):
            vn = torch.zeros((P, chi2), dtype=cdtype, device=dev)
            vd = torch.zeros((P, chi2), dtype=cdtype, device=dev)
            for (s, oid), idx, pos in ntab:
                e = _site_transfer(state, idx, s)  # [B, o, p, s, z]
                vn[pos] = torch.einsum("bopsz,zs->bop", e,
                                       ops_dev[oid]).reshape(-1, chi2)
            for s, idx, pos in dtab:
                e = _site_transfer(state, idx, s)
                vd[pos] = torch.einsum("bopss->bop", e).reshape(-1, chi2)
            return torch.stack([vn, vd], dim=0)

        m = endpoints(a_n, a_d)  # [2, P, χ²]
        vb = endpoints(b_n, b_d)

        T = torch.zeros((pad + 1, chi2, chi2), dtype=cdtype, device=dev)
        T[pad] = torch.eye(chi2, dtype=cdtype, device=dev)
        scales = torch.ones((max(n_den, 1),), dtype=T.real.dtype, device=dev)
        for (sp, sn), idx, pos in den_tab:
            e = _site_transfer2(state, idx, sp, sn).reshape(-1, chi2, chi2)
            sc = e.abs().amax(dim=(1, 2))
            sc = torch.where(sc == 0, torch.ones_like(sc), sc)
            T[pos] = e / sc[:, None, None]
            scales[pos] = sc
        for (sp, sn, oid), idx, pos, partner in num_tab:
            e = _site_transfer2_op(state, idx, sp, sn,
                                   ops_dev[oid]).reshape(-1, chi2, chi2)
            # partner den scale: cancels in the ratio
            T[pos] = e / scales[partner][:, None, None]

        for idxs in chain:  # idxs [2, P]
            m = torch.einsum("kpi,kpij->kpj", m, T[idxs])
        vals = torch.einsum("kpi,kpi->kp", m, vb)
        out = vals[0] / vals[1]
        return out.real if real_output else out

    return string_fn


def string_expectations(
    spec: BatchedGraphSpec,
    state: BatchedState,
    strings: Sequence[tuple],
    **kwargs,
) -> torch.Tensor:
    """One-shot multi-site string expectations (BP path alg).  See
    :func:`make_string_expectation_fn`."""
    return make_string_expectation_fn(spec, strings, **kwargs)(state)


def make_path_rdm_fn(
    spec: BatchedGraphSpec,
    pairs: Sequence[tuple],
    *,
    paths: Sequence[tuple[list, list]] | None = None,
    jit: bool = True,
) -> Callable:
    """Build ``fn(state) -> [len(pairs), d, d, d, d]`` of trace-normalized
    two-site RDMs ρ_ab for vertex pairs at ANY graph distance (BP alg,
    `rdm.jl:49-70`), extending :func:`~.engine.bond_rdms` beyond adjacent
    pairs.  Index order matches ``bond_rdms``: (ket_a, bra_a, ket_b, bra_b).

    Same machinery as :func:`make_path_correlation_fn` with the endpoint
    site legs left OPEN: the interior chain is identical, the carry just
    grows a d² axis."""
    del jit
    paths, a_buckets, b_buckets, int_buckets, tab_t, n_int = (
        _build_path_tables(spec, pairs, paths)
    )
    P = len(pairs)
    tables = _per_device(lambda dev: (
        _bucket_tensors(a_buckets, dev), _bucket_tensors(b_buckets, dev),
        _bucket_tensors(int_buckets, dev), _long(tab_t, dev)))

    def rdms(state: BatchedState) -> torch.Tensor:
        chi2 = state.chi * state.chi
        d = state.tensors.shape[-1]
        cdtype = state.tensors.dtype
        dev = state.tensors.device
        a_tab, b_tab, int_tab, chain = tables(dev)

        def endpoints(tab):
            out = torch.zeros((P, d * d, chi2), dtype=cdtype, device=dev)
            for s, idx, pos in tab:
                e = _site_transfer(state, idx, s)  # [B, o, p, s, z]
                out[pos] = e.reshape(-1, chi2, d * d).transpose(1, 2)
            return out

        m = endpoints(a_tab)  # [P, d², χ²]
        vb = endpoints(b_tab)
        T = _interior_transfer_table(state, int_tab, n_int, chi2, cdtype)
        for idxs in chain:
            m = torch.einsum("pdi,pij->pdj", m, T[idxs])
        rho = torch.einsum("pdi,pei->pde", m, vb).reshape(P, d, d, d, d)
        tr = torch.einsum("paabb->p", rho)
        return rho / tr[:, None, None, None, None]

    return rdms


def make_mutual_information_fn(
    spec: BatchedGraphSpec,
    pairs: Sequence[tuple],
    *,
    paths: Sequence[tuple[list, list]] | None = None,
    jit: bool = True,
) -> Callable:
    """Build ``fn(state) -> [len(pairs)]`` of the quantum mutual
    information I(a:b) = S(ρ_a) + S(ρ_b) − S(ρ_ab) between vertex pairs
    at any graph distance (BP alg; natural log).

    ρ_ab comes from :func:`make_path_rdm_fn`; the one-site marginals are
    traced out of it (so all three entropies share one contraction and
    are exactly consistent).  Entropies use eigenvalue clipping at 0:
    BP RDMs can carry tiny negative eigenvalues at float precision."""
    del jit
    rdm_fn = make_path_rdm_fn(spec, pairs, paths=paths)

    def entropy(rho):
        # the port's library eigh hermitizes, and solves rank-deficient
        # complex64 batches (a pure marginal) that cuSOLVER may refuse
        w = torch.clamp(eigh_plain(rho)[0], min=0.0)
        w = w / w.sum(-1, keepdim=True)
        safe = torch.where(w > 0, w, torch.ones_like(w))
        return -(w * torch.log(safe)).sum(-1)

    def mutual_information(state: BatchedState) -> torch.Tensor:
        rho = rdm_fn(state)  # [P, sa, za, sb, zb], trace-normalized
        d = rho.shape[-1]
        rho_a = torch.einsum("pszcc->psz", rho)
        rho_b = torch.einsum("pccsz->psz", rho)
        # rows (sa sb), cols (za zb)
        rho_ab = rho.permute(0, 1, 3, 2, 4).reshape(-1, d * d, d * d)
        return entropy(rho_a) + entropy(rho_b) - entropy(rho_ab)

    return mutual_information


def make_sharded_path_correlations(
    sspec,
    mesh,
    pairs: Sequence[tuple],
    op1,
    op2=None,
    *,
    paths: Sequence[tuple[list, list]] | None = None,
    connected: bool = False,
    real_output: bool = False,
    axis: str = "v",
) -> Callable:
    """Path correlators on the sharded state: ``fn(sstate) -> [len(pairs)]``
    on the mesh's first device.

    Same semantics as :func:`make_path_correlation_fn`, on a
    ``sharding.ShardedBPSpec`` strip sharding.  A path's transfer matrix
    needs only its OWN vertex's tensor and incoming messages, so no halo
    exchange is needed: each shard builds the χ²×χ² transfer entries and
    endpoint χ²-vectors it owns (slot-pattern buckets, per-shard tables),
    ONE ``psum`` per table assembles it (entries are zero off their owner
    shard), and the cheap matvec chain runs once.  The state itself never
    gathers (reference semantics: `expect.jl:58-83`)."""
    from .sharding import check_mesh

    check_mesh(sspec, mesh, axis)
    spec = sspec.spec
    S = sspec.num_shards
    Vl = spec.num_vertices // S
    op1 = np.asarray(op1)
    op2 = op1 if op2 is None else np.asarray(op2)
    P = len(pairs)
    paths, a_buckets, b_buckets, int_buckets, tab_t, n_int = (
        _build_path_tables(spec, pairs, paths)
    )

    def shard_tables(buckets):
        """``{key: [(dest, vertex)]}`` → per shard ``[(key, local idx,
        dest idx)]`` of device tensors, for the entries the shard owns."""
        out = []
        for s, dev in enumerate(mesh.devices):
            own = {k: [(d, v % Vl) for d, v in e if v // Vl == s]
                   for k, e in buckets.items()}
            out.append(_bucket_tensors({k: e for k, e in own.items() if e},
                                       dev))
        return out

    a_tabs, b_tabs = shard_tables(a_buckets), shard_tables(b_buckets)
    i_tabs = shard_tables(int_buckets)
    dev0 = mesh.devices[0]
    chain = _long(tab_t, dev0)

    def corr_fn(sstate):
        shards = sstate.shards
        chi = shards[0].chi
        chi2 = chi * chi
        cdtype = shards[0].tensors.dtype

        def endpoints(tabs, op):
            parts = []
            for s, st in enumerate(shards):
                dev = st.tensors.device
                o = _as_op(op, cdtype, dev)
                v = torch.zeros((2, P, chi2), dtype=cdtype, device=dev)
                for slot, idx, pos in tabs[s]:
                    e = _site_transfer(st, idx, slot)
                    v[0, pos] = torch.einsum("bopsz,zs->bop", e, o).reshape(
                        -1, chi2)
                    v[1, pos] = torch.einsum("bopss->bop", e).reshape(-1, chi2)
                parts.append(v)
            return mesh.psum(parts, axis)[0]  # [2, P, χ²]

        m = endpoints(a_tabs, op1)
        vb = endpoints(b_tabs, op2)
        parts = []
        for s, st in enumerate(shards):
            T = torch.zeros((n_int, chi2, chi2), dtype=cdtype,
                            device=st.tensors.device)
            for (sp, sn), idx, pos in i_tabs[s]:
                mats = _site_transfer2(st, idx, sp, sn).reshape(-1, chi2, chi2)
                scale = mats.abs().amax(dim=(1, 2), keepdim=True)
                T[pos] = mats / torch.where(scale == 0, torch.ones_like(scale),
                                            scale)
            parts.append(T)
        T = torch.cat([mesh.psum(parts, axis)[0],
                       torch.eye(chi2, dtype=cdtype, device=dev0)[None]])
        for idxs in chain:
            m = torch.einsum("kpi,pij->kpj", m, T[idxs])
        vals = torch.einsum("kpi,kpi->kp", m, vb)
        out = vals[0] / vals[1]
        return out.real if real_output else out

    if not connected:
        return corr_fn

    from .sharded_layer import make_sharded_site_expectations

    ia = _long([verts[0] for verts, _ in paths], dev0)
    ib = _long([verts[-1] for verts, _ in paths], dev0)
    site1 = make_sharded_site_expectations(sspec, mesh, op1, axis=axis)
    site2 = make_sharded_site_expectations(sspec, mesh, op2, axis=axis)

    def connected_fn(sstate):
        out = corr_fn(sstate)
        sub = site1(sstate)[ia] * site2(sstate)[ib]
        return out - (sub.real if real_output else sub)

    return connected_fn
