"""Sharded full Trotter layer: SPMD simple update + halo BP, and the sharded
BP readouts, gauge and truncation.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
sharded_layer``:

- vertex tensors and messages stay in contiguous lattice strips
  (``shard_spec`` order) for the whole layer;
- each edge-colour group splits into *intra-shard* buckets (local compute)
  and *cross-shard* buckets, whose partner rows are halo-exchanged with two
  ``ppermute``s (gather the partner's tensor and messages) and whose
  partner-side update goes back with two more — the analogue of the
  reference's sequential per-edge sweep (`apply_gates.jl:60-85`);
- every shard updates all of its buckets of a group through the engine's
  update (``engine._bucket_updates``, as ``apply_color_group_masked``
  does), so the Jacobi kernels (K1, K2) run inside every shard on the fast
  stack;
- the write-back is the reference's exact select, ``old[p] <- new[inv[p]]
  where wr[p]`` (``engine._select_rows``): each row receives either its
  exact new value or its exact old one;
- between colour groups the halo-exchange flooding BP
  (``sharding._bp_fixed_point``) refreshes the environments, at the
  unsharded ``make_layer_fn``'s refresh points.

The bucket tables are the reference's (numpy, padded to the widest shard);
a shard computes only its valid lanes, and a truncation-error lane that a
shard does not own reads 0 as in the reference.  No layer moves a whole
state: the exchanges are ``ppermute``s of halo rows and one ``psum`` of
the BP distance per sweep.  The readouts (site and bond values, RDMs,
spectra) come back as one tensor on the mesh's first device
(``ShardMesh.collect``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .engine import (
    _bucket_updates,
    _select_rows,
    _site_transfer,
    default_batched_tolerance,
    local_expectations,
    local_rdms,
)
from .sharding import (
    ShardedBPSpec,
    ShardedState,
    ShardMesh,
    _bp_fixed_point,
    _long,
    strip_plan,
)


@dataclasses.dataclass(frozen=True)
class _IntraBucket:
    slot_u: int
    slot_v: int
    u_tab: np.ndarray  # [S, B] local u positions (0-padded gather table)
    v_tab: np.ndarray  # [S, B]
    valid: np.ndarray  # [S, B]
    u_inv: np.ndarray  # [S, Vl] lane writing each local vertex (else 0)
    u_wr: np.ndarray  # [S, Vl] whether that vertex is written
    v_inv: np.ndarray  # [S, Vl]
    v_wr: np.ndarray  # [S, Vl]


@dataclasses.dataclass(frozen=True)
class _CrossBucket:
    slot_u: int  # slot on the computing-side (u) vertex
    slot_v: int  # slot on the partner (v) vertex
    dir: int  # +1: v lives in the next shard; -1: v lives in the prev shard
    u_tab: np.ndarray  # [S, B] computing shard's local u positions
    vsend_tab: np.ndarray  # [S, B] partner positions each shard sends out
    valid: np.ndarray  # [S, B] valid on the computing shard
    u_inv: np.ndarray  # [S, Vl]
    u_wr: np.ndarray  # [S, Vl]
    vs_inv: np.ndarray  # [S, Vl] lane of the returned payload per sender row
    vs_wr: np.ndarray  # [S, Vl]


def _inverse_table(pairs_per_shard, Vl: int):
    """[(target_local_vertex, lane)] per shard -> (inv [S,Vl], wr [S,Vl]).

    Color groups are matchings, so each local vertex is targeted by at
    most one lane; the write-back ``where(wr, new[inv], old)`` is then a
    deterministic select with no duplicate-scatter hazard."""
    S = len(pairs_per_shard)
    inv = np.zeros((S, Vl), np.int32)
    wr = np.zeros((S, Vl), bool)
    for s, pairs in enumerate(pairs_per_shard):
        for tgt, lane in pairs:
            assert not wr[s, tgt], "bucket writes a vertex twice"
            inv[s, tgt] = lane
            wr[s, tgt] = True
    return inv, wr


def build_layer_groups(sspec: ShardedBPSpec):
    """Split every color group of the strip-ordered spec into intra/cross
    buckets with per-shard padded tables."""
    spec = sspec.spec
    S = sspec.num_shards
    Vl = spec.num_vertices // S
    groups = []
    for group in spec.color_groups:
        intra: dict = {}
        cross: dict = {}
        for b in group:
            for iu, iv in zip(b.u_idx, b.v_idx):
                su_s, sv_s = iu // Vl, iv // Vl
                if su_s == sv_s:
                    intra.setdefault((b.slot_u, b.slot_v), []).append(
                        (su_s, iu % Vl, iv % Vl)
                    )
                elif (su_s + 1) % S == sv_s:
                    cross.setdefault((b.slot_u, b.slot_v, +1), []).append(
                        (su_s, iu % Vl, iv % Vl)
                    )
                elif (sv_s + 1) % S == su_s:
                    cross.setdefault((b.slot_u, b.slot_v, -1), []).append(
                        (su_s, iu % Vl, iv % Vl)
                    )
                else:
                    raise ValueError(
                        "non-adjacent cross-shard edge: strip partition "
                        "invalid for gate application"
                    )
        buckets = []
        for (su, sv), entries in sorted(intra.items()):
            per_shard: list = [[] for _ in range(S)]
            for (s, lu, lv) in entries:
                per_shard[s].append((lu, lv))
            B = max(1, max(len(l) for l in per_shard))
            u_tab = np.zeros((S, B), np.int32)
            v_tab = np.zeros((S, B), np.int32)
            valid = np.zeros((S, B), bool)
            for s, lst in enumerate(per_shard):
                for i, (lu, lv) in enumerate(lst):
                    u_tab[s, i], v_tab[s, i], valid[s, i] = lu, lv, True
            u_inv, u_wr = _inverse_table(
                [[(lu, i) for i, (lu, _) in enumerate(lst)]
                 for lst in per_shard], Vl)
            v_inv, v_wr = _inverse_table(
                [[(lv, i) for i, (_, lv) in enumerate(lst)]
                 for lst in per_shard], Vl)
            buckets.append(_IntraBucket(
                su, sv, u_tab, v_tab, valid, u_inv, u_wr, v_inv, v_wr))
        for (su, sv, dir_), entries in sorted(cross.items()):
            per_shard: list = [[] for _ in range(S)]
            for (s, lu, lv) in entries:
                per_shard[s].append((lu, lv))
            B = max(1, max(len(l) for l in per_shard))
            u_tab = np.zeros((S, B), np.int32)
            vsend = np.zeros((S, B), np.int32)
            valid = np.zeros((S, B), bool)
            for s, lst in enumerate(per_shard):
                for i, (lu, lv) in enumerate(lst):
                    u_tab[s, i], valid[s, i] = lu, True
            vs_pairs: list = [[] for _ in range(S)]
            for s in range(S):
                sender = (s + dir_) % S
                # edges computed by s; their v's live on the sender shard
                for i, (_, lv) in enumerate(per_shard[s]):
                    vsend[sender, i] = lv
                    vs_pairs[sender].append((lv, i))
            u_inv, u_wr = _inverse_table(
                [[(lu, i) for i, (lu, _) in enumerate(lst)]
                 for lst in per_shard], Vl)
            vs_inv, vs_wr = _inverse_table(vs_pairs, Vl)
            buckets.append(_CrossBucket(
                su, sv, dir_, u_tab, vsend, valid, u_inv, u_wr,
                vs_inv, vs_wr))
        groups.append(tuple(buckets))
    return tuple(groups)


# ---------------------------------------------------------------------------
# device-side buckets, shared by the strip and the block layouts
# ---------------------------------------------------------------------------


class _Bucket:
    """One slot-pair bucket as per-shard device tables.

    ``xfer`` is None for an intra-shard bucket, else ``((axis, perm_in),
    (axis, perm_back))``: the exchange that brings the partner's rows to
    the computing shard, and the one that returns its update.  Shard s
    computes ``n[s]`` lanes; ``v[s]`` are the partner rows it holds for
    its own lanes (intra) or sends out (cross); ``pos[s]`` (bond tables
    only) are its lanes' positions in ``spec.edges``."""

    def __init__(self, mesh: ShardMesh, slot_u, slot_v, xfer, u_tab, v_tab,
                 valid, u_inv, u_wr, v_inv, v_wr, pos_tab=None):
        devs = mesh.devices
        S = mesh.num_shards
        self.slot_u, self.slot_v, self.xfer = slot_u, slot_v, xfer
        self.width = valid.shape[1]
        self.n = [int(k) for k in np.asarray(valid).sum(1)]
        vlen = list(self.n)
        if xfer is not None:  # a sender sends its receiver's lane count
            for d, src in enumerate(mesh.sources(*xfer[0])):
                vlen[src] = self.n[d]
        self.u = [_long(u_tab[s, :self.n[s]], devs[s]) for s in range(S)]
        self.v = [_long(v_tab[s, :vlen[s]], devs[s]) for s in range(S)]
        self.u_inv = [_long(u_inv[s], devs[s]) for s in range(S)]
        self.v_inv = [_long(v_inv[s], devs[s]) for s in range(S)]
        self.u_wr = [torch.as_tensor(u_wr[s], device=devs[s])
                     for s in range(S)]
        self.v_wr = [torch.as_tensor(v_wr[s], device=devs[s])
                     for s in range(S)]
        self.pos = (None if pos_tab is None else
                    [np.asarray(pos_tab[s, :self.n[s]]) for s in range(S)])

    def partner(self, mesh: ShardMesh, xs) -> list:
        """Each computing shard's partner rows of ``xs`` (per-shard [Vl,
        ...] tensors): local rows, or a halo exchange."""
        rows = [x[v] for x, v in zip(xs, self.v)]
        return rows if self.xfer is None else mesh.ppermute(rows,
                                                            *self.xfer[0])


def _strip_xfer(mesh: ShardMesh, axis, dir_: int):
    """A strip bucket's exchanges: a partner in the next shard sends
    leftward and gets its update back rightward, and the mirror image."""
    if dir_ == 0:
        return None
    ahead = (axis, mesh.ring(axis, -1))
    back = (axis, mesh.ring(axis, +1))
    return (ahead, back) if dir_ == +1 else (back, ahead)


def _layer_buckets(mesh: ShardMesh, groups, xfer_of) -> list:
    out = []
    for group in groups:
        bks = []
        for b in group:
            if isinstance(b, _IntraBucket):
                bks.append(_Bucket(mesh, b.slot_u, b.slot_v, None, b.u_tab,
                                   b.v_tab, b.valid, b.u_inv, b.u_wr,
                                   b.v_inv, b.v_wr))
            else:
                bks.append(_Bucket(mesh, b.slot_u, b.slot_v, xfer_of(b.dir),
                                   b.u_tab, b.vsend_tab, b.valid, b.u_inv,
                                   b.u_wr, b.vs_inv, b.vs_wr))
        out.append(bks)
    return out


def _apply_group(mesh, buckets, tensors, messages, gates, chi, cutoff,
                 normalize_tensors):
    """One colour group on every shard: halo in, update, halo back, write
    back.  Returns (tensors, messages, per-shard error lists)."""
    S = mesh.num_shards
    partners = {}
    for i, b in enumerate(buckets):
        if b.xfer is not None:
            partners[i] = (b.partner(mesh, tensors), b.partner(mesh, messages))
    results = []
    for s in range(S):
        items, which = [], []
        for i, b in enumerate(buckets):
            if b.n[s] == 0:
                continue
            u = b.u[s]
            if b.xfer is None:
                tv, mv = tensors[s][b.v[s]], messages[s][b.v[s]]
            else:
                tv, mv = partners[i][0][s], partners[i][1][s]
            items.append((b.slot_u, b.slot_v, tensors[s][u], tv,
                          messages[s][u], mv))
            which.append(i)
        outs = (_bucket_updates(items, gates[s], chi, cutoff,
                                normalize_tensors)
                if items else [])
        res = [None] * len(buckets)
        for i, o in zip(which, outs):
            res[i] = o
        results.append(res)
    backs = {}
    for i, b in enumerate(buckets):
        if b.xfer is not None:
            ret = b.xfer[1]
            backs[i] = (
                mesh.ppermute([r[i] and r[i][1] for r in results], *ret),
                mesh.ppermute([r[i] and r[i][2] for r in results], *ret))
    new_t, new_m, errs = [], [], []
    for s in range(S):
        t, m = tensors[s], messages[s].clone()
        rdt = t.real.dtype
        e = []
        for i, b in enumerate(buckets):
            su, sv = b.slot_u, b.slot_v
            r = results[s][i]
            if r is not None:
                tu_new, tv_new, msg, err = r
                t = _select_rows(t, tu_new, b.u_inv[s], b.u_wr[s])
                m[:, su] = _select_rows(m[:, su], msg, b.u_inv[s],
                                        b.u_wr[s])
                if b.xfer is None:
                    t = _select_rows(t, tv_new, b.v_inv[s], b.v_wr[s])
                    m[:, sv] = _select_rows(m[:, sv], msg, b.v_inv[s],
                                            b.v_wr[s])
                err = err.to(rdt)
            else:
                err = torch.zeros((0,), dtype=rdt, device=t.device)
            if b.xfer is not None and backs[i][0][s] is not None:
                t = _select_rows(t, backs[i][0][s], b.v_inv[s], b.v_wr[s])
                m[:, sv] = _select_rows(m[:, sv], backs[i][1][s],
                                        b.v_inv[s], b.v_wr[s])
            # a lane this shard does not own reads 0, as in the reference
            e.append(torch.cat([err, err.new_zeros(b.width - err.shape[0])]))
        new_t.append(t)
        new_m.append(m)
        errs.append(e)
    return new_t, new_m, errs


def _one_site(tensors, gates):
    return [torch.einsum("v...d,pd->v...p", t, g.to(t.dtype))
            for t, g in zip(tensors, gates)]


def _make_layer(mesh: ShardMesh, fixed_point, dev_groups, gate2, gate1,
                chi, cutoff, normalize_tensors, bp_maxiter, bp_tolerance,
                one_site_first, final_update, initial_update):
    """The layer program shared by the strip and the block layouts;
    ``fixed_point(tensors, messages, maxiter, tolerance)`` is the layout's
    halo BP."""
    g2 = mesh.broadcast(torch.as_tensor(np.asarray(gate2)))
    g1 = None if gate1 is None else mesh.broadcast(
        torch.as_tensor(np.asarray(gate1)))

    def layer(sstate: ShardedState):
        tensors, messages = list(sstate.tensors), list(sstate.messages)
        tol = (bp_tolerance if bp_tolerance is not None
               else default_batched_tolerance(tensors[0].dtype))

        def bp(tensors, messages):
            return fixed_point(tensors, messages, bp_maxiter, tol)

        errs = [[] for _ in tensors]
        # initial_update forces a BP refresh before the first group even
        # when no one-site gate dirtied the messages (batched_truncate
        # semantics: every group is preceded by an update)
        applied = initial_update
        if g1 is not None and one_site_first:
            tensors = _one_site(tensors, g1)
            applied = True
        for buckets in dev_groups:
            if applied:
                messages = bp(tensors, messages)
            tensors, messages, e = _apply_group(
                mesh, buckets, tensors, messages, g2, chi, cutoff,
                normalize_tensors)
            for s, es in enumerate(e):
                errs[s] += es
            applied = True
        if g1 is not None and not one_site_first:
            tensors = _one_site(tensors, g1)
        if final_update:
            messages = bp(tensors, messages)
        errs = [torch.cat(es) if es else torch.zeros(
            (1,), dtype=torch.float32, device=t.device)
            for es, t in zip(errs, tensors)]
        return ShardedState.of(tensors, messages), errs

    return layer


def make_sharded_layer(
    sspec: ShardedBPSpec,
    mesh: ShardMesh,
    gate2: np.ndarray,  # [d, d, d, d] uniform 2-site gate (e.g. Rzz)
    gate1: np.ndarray | None,  # [d, d] uniform 1-site gate (e.g. Rx)
    chi: int,
    cutoff: float = 1e-12,
    normalize_tensors: bool = True,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    one_site_first: bool = True,
    final_update: bool = True,
    axis: str = "v",
    initial_update: bool = False,
):
    """Build the SPMD Trotter layer ``ShardedState -> (ShardedState,
    errors)``, the errors a per-shard list in the reference's lane layout.

    Matches the unsharded `make_layer_fn` semantics for the uniform
    kicked-Ising layer (1-site gate on every vertex + 2-site gate on every
    edge, color group by color group with BP refreshes in between).  The
    state's shards are the strips of ``sspec`` on ``mesh[axis]``
    (``mesh.shard``)."""
    plan = strip_plan(sspec, mesh, axis)
    groups = _layer_buckets(mesh, build_layer_groups(sspec),
                            lambda d: _strip_xfer(mesh, axis, d))
    return _make_layer(mesh, functools.partial(_bp_fixed_point, plan), groups,
                       gate2, gate1, chi, cutoff,
                       normalize_tensors, bp_maxiter, bp_tolerance,
                       one_site_first, final_update, initial_update)


# ---------------------------------------------------------------------------
# sharded BP-alg measurement
# ---------------------------------------------------------------------------


def make_sharded_site_expectations(sspec: ShardedBPSpec, mesh: ShardMesh,
                                   op, axis: str = "v"):
    """``fn(sstate) -> [V]`` of per-vertex ⟨op⟩ (`expect.jl:58-83`,
    single-site case), computed where each vertex lives: the BP one-site
    RDM is vertex-local once messages are converged, so no exchange at
    all; the values are collected on the mesh's first device."""
    spec = sspec.spec
    op = np.asarray(op)

    def site_fn(sstate: ShardedState):
        return mesh.collect([local_expectations(spec, st, op)
                             for st in sstate.shards])

    return site_fn


def _build_bond_tables(sspec: ShardedBPSpec):
    """Bucket ``spec.edges`` by (slot_u, slot_v[, halo direction]) with
    per-shard 0-padded gather tables (same table discipline as
    `build_layer_groups`) plus each lane's position in ``spec.edges`` so
    the caller can reassemble the canonical output order."""
    spec = sspec.spec
    S = sspec.num_shards
    Vl = spec.num_vertices // S
    intra: dict = {}
    cross: dict = {}
    for pos, (iu, iv, su, sv) in enumerate(spec.edges):
        s_u, s_v = iu // Vl, iv // Vl
        if s_u == s_v:
            intra.setdefault((su, sv), []).append(
                (s_u, iu % Vl, iv % Vl, pos))
        elif (s_u + 1) % S == s_v:
            cross.setdefault((su, sv, +1), []).append(
                (s_u, iu % Vl, iv % Vl, pos))
        elif (s_v + 1) % S == s_u:
            cross.setdefault((su, sv, -1), []).append(
                (s_u, iu % Vl, iv % Vl, pos))
        else:
            raise ValueError(
                "non-adjacent cross-shard edge: strip partition invalid "
                "for bond expectations"
            )

    def tables(entries, with_dir):
        per_shard: list = [[] for _ in range(S)]
        for e in entries:
            per_shard[e[0]].append(e[1:])
        B = max(1, max(len(l) for l in per_shard))
        u_tab = np.zeros((S, B), np.int32)
        v_tab = np.zeros((S, B), np.int32)
        valid = np.zeros((S, B), bool)
        pos_tab = np.full((S, B), -1, np.int64)
        v_pairs: list = [[] for _ in range(S)]
        for s, lst in enumerate(per_shard):
            for i, (lu, lv, pos) in enumerate(lst):
                u_tab[s, i], valid[s, i], pos_tab[s, i] = lu, True, pos
                if not with_dir:
                    v_tab[s, i] = lv
                    v_pairs[s].append((lv, i))
        if with_dir:
            # partner positions, laid out in the SENDER shard's row at the
            # computing shard's lane index (the ppermute then aligns them)
            for s, lst in enumerate(per_shard):
                sender = (s + with_dir) % S
                for i, (_, lv, _) in enumerate(lst):
                    v_tab[sender, i] = lv
                    v_pairs[sender].append((lv, i))
        u_inv, u_wr = _inverse_table(
            [[(lu, i) for i, (lu, _, _) in enumerate(lst)]
             for lst in per_shard], Vl)
        v_inv, v_wr = _inverse_table(v_pairs, Vl)
        return u_tab, v_tab, valid, pos_tab, u_inv, u_wr, v_inv, v_wr

    out = []
    for (su, sv), entries in sorted(intra.items()):
        out.append((su, sv, 0) + tables(entries, 0))
    for (su, sv, dir_), entries in sorted(cross.items()):
        out.append((su, sv, dir_) + tables(entries, dir_))
    return out


def _bond_buckets(mesh: ShardMesh, tables, xfer_of) -> list:
    """Device buckets of `_build_bond_tables` rows (either layout)."""
    return [_Bucket(mesh, su, sv, xfer_of(d), u_tab, v_tab, valid, u_inv,
                    u_wr, v_inv, v_wr, pos_tab)
            for (su, sv, d, u_tab, v_tab, valid, pos_tab, u_inv, u_wr, v_inv,
                 v_wr) in tables]


def strip_bond_buckets(sspec: ShardedBPSpec, mesh: ShardMesh,
                       axis) -> list:
    return _bond_buckets(mesh, _build_bond_tables(sspec),
                         lambda d: _strip_xfer(mesh, axis, d))


def _edge_collect(mesh: ShardMesh, buckets, per_shard_vals, n_edges):
    """Per-shard, per-bucket lane values put back into ``spec.edges``
    order, on the mesh's first device."""
    dev = mesh.devices[0]
    flat, pos = [], []
    for s, vals in enumerate(per_shard_vals):
        for b, v in zip(buckets, vals):
            if b.n[s]:
                flat.append(v)
                pos.append(b.pos[s])
    vals = mesh.collect(flat, dev)
    out = vals.new_zeros((n_edges,) + tuple(vals.shape[1:]))
    out[_long(np.concatenate(pos), dev)] = vals
    return out


def _bond_transfers(mesh: ShardMesh, buckets, sstate: ShardedState):
    """Per shard, per bucket: (E_u, E_v) on the shard owning u, the
    partner's open-bond transfer haloed in (one ``ppermute`` per cross
    bucket)."""
    S = mesh.num_shards
    shards = sstate.shards
    out = [[] for _ in range(S)]
    for b in buckets:
        ev = [_site_transfer(shards[s], b.v[s], b.slot_v) for s in range(S)]
        if b.xfer is not None:
            ev = mesh.ppermute(ev, *b.xfer[0])
        for s in range(S):
            out[s].append((_site_transfer(shards[s], b.u[s], b.slot_u),
                           ev[s]))
    return out


def _bond_values(mesh, buckets, n_edges, op1, op2):
    o1, o2 = np.asarray(op1), np.asarray(op2)

    def bond_fn(sstate: ShardedState):
        vals = []
        for per in _bond_transfers(mesh, buckets, sstate):
            row = []
            for eu, ev in per:
                a = torch.as_tensor(o1).to(dtype=eu.dtype, device=eu.device)
                b = torch.as_tensor(o2).to(dtype=eu.dtype, device=eu.device)
                numer = torch.einsum("bopsz,zs,bopcx,xc->b", eu, a, ev, b)
                denom = torch.einsum("bopss,bopcc->b", eu, ev)
                row.append(numer / denom)
            vals.append(row)
        return _edge_collect(mesh, buckets, vals, n_edges)

    return bond_fn


def make_sharded_bond_expectations(sspec: ShardedBPSpec, mesh: ShardMesh,
                                   op1, op2, axis: str = "v"):
    """``fn(sstate) -> [E]`` of ⟨op1 ⊗ op2⟩ on every edge of
    ``spec.edges`` (order preserved): each edge is evaluated on the shard
    owning its u vertex; for cross-shard edges the partner's open-bond site
    transfer E_v[b,l,l',s,s'] is built on the owner shard and moved with
    ONE ``ppermute`` per (slot-pair, direction) bucket.  Matches
    `engine.bond_expectations` (the BP Steiner contraction of
    `expect.jl:58-83` specialized to an edge) to float roundoff."""
    buckets = strip_bond_buckets(sspec, mesh, axis)
    return _bond_values(mesh, buckets, len(sspec.spec.edges), op1, op2)


def make_sharded_site_rdms(sspec: ShardedBPSpec, mesh: ShardMesh,
                           axis: str = "v"):
    """``fn(sstate) -> [V, d, d]`` of trace-normalized 1-site RDMs
    (`rdm.jl:49-70`, single-vertex Steiner tree), vertex-local given
    converged messages: no exchange."""
    spec = sspec.spec

    def rdm_fn(sstate: ShardedState):
        out = []
        for st in sstate.shards:
            rho = local_rdms(spec, st)
            tr = torch.einsum("vss->v", rho)
            out.append(rho / tr[:, None, None])
        return mesh.collect(out)

    return rdm_fn


def make_sharded_bond_rdms(sspec: ShardedBPSpec, mesh: ShardMesh,
                           axis: str = "v"):
    """``fn(sstate) -> [E, d, d, d, d]`` of trace-normalized 2-site RDMs
    (ket_u, bra_u, ket_v, bra_v) for every edge of ``spec.edges`` (order
    preserved), with the one-``ppermute``-per-cross-bucket halo of
    :func:`make_sharded_bond_expectations`."""
    buckets = strip_bond_buckets(sspec, mesh, axis)
    n_edges = len(sspec.spec.edges)

    def rdm_fn(sstate: ShardedState):
        vals = []
        for per in _bond_transfers(mesh, buckets, sstate):
            row = []
            for eu, ev in per:
                rho = torch.einsum("bopsz,bopcx->bszcx", eu, ev)
                tr = torch.einsum("bsscc->b", rho)
                row.append(rho / tr[:, None, None, None, None])
            vals.append(row)
        return _edge_collect(mesh, buckets, vals, n_edges)

    return rdm_fn


def _absorb_rows(rows, slot, transforms):
    """rows[e] ← Σ_l T[..., l(slot), ...] A[l, l'] on gathered rows."""
    t2 = torch.movedim(rows, 1 + slot, -1)
    t2 = torch.einsum("e...l,elm->e...m", t2, transforms)
    return torch.movedim(t2, -1, 1 + slot)


def _gauge_fn(mesh: ShardMesh, buckets, n_edges, rel_cutoff):
    """The Vidal gauge over device buckets (either layout)."""
    from .gauge import _edge_gauge_transforms

    S = mesh.num_shards

    def gauge_fn(sstate: ShardedState):
        tensors = list(sstate.tensors)
        messages = [m.clone() for m in sstate.messages]
        rc = rel_cutoff
        if rc is None:
            rc = 1e3 * torch.finfo(tensors[0].real.dtype).eps
        spectra = [[] for _ in range(S)]
        for b in buckets:
            su, sv = b.slot_u, b.slot_v
            X = b.partner(mesh, [m[:, sv] for m in messages])  # u→v, at v
            payload = []
            for s in range(S):
                if b.n[s] == 0:
                    payload.append(None)
                    spectra[s].append(None)
                    continue
                Y = messages[s][b.u[s], su]  # v→u message, stored at u
                a_u, a_v, ss = _edge_gauge_transforms(
                    X[s], Y, tensors[s].dtype, rc)
                s_diag = torch.diag_embed(ss.to(messages[s].dtype))
                tu = _absorb_rows(tensors[s][b.u[s]], su, a_u)
                tensors[s] = _select_rows(tensors[s], tu, b.u_inv[s],
                                          b.u_wr[s])
                messages[s][:, su] = _select_rows(
                    messages[s][:, su], s_diag, b.u_inv[s], b.u_wr[s])
                spectra[s].append(ss)
                payload.append(torch.stack([a_v, s_diag.to(a_v.dtype)], 1))
            if b.xfer is not None:
                payload = mesh.ppermute(payload, *b.xfer[1])
            for s in range(S):
                if payload[s] is None:
                    continue
                a_v, s_diag = payload[s][:, 0], payload[s][:, 1]
                tv = _absorb_rows(tensors[s][b.v[s]], sv, a_v)
                tensors[s] = _select_rows(tensors[s], tv, b.v_inv[s],
                                          b.v_wr[s])
                messages[s][:, sv] = _select_rows(
                    messages[s][:, sv], s_diag.to(messages[s].dtype),
                    b.v_inv[s], b.v_wr[s])
        out = ShardedState.of(tensors, messages)
        return out, _edge_collect(mesh, buckets, spectra, n_edges)

    return gauge_fn


def make_sharded_gauge(sspec: ShardedBPSpec, mesh: ShardMesh,
                       rel_cutoff: float | None = None, axis: str = "v"):
    """``fn(sstate) -> (sstate, spectra[E, χ])``: Vidal/symmetric gauge
    (`symmetric_gauge.jl:85-114`) on the sharded state.

    Identical math to `gauge.batched_symmetric_gauge`: each directed
    (vertex, slot) pair belongs to exactly one edge, so bucket-by-bucket
    processing reads and writes disjoint message slots.  Each edge is
    gauged on the shard owning its u vertex; a cross-shard edge halos in
    the partner's stored message (one ``ppermute``) and halos out the
    partner's bond transform and new diagonal message (one more).
    Spectra come back in ``spec.edges`` order."""
    buckets = strip_bond_buckets(sspec, mesh, axis)
    return _gauge_fn(mesh, buckets, len(sspec.spec.edges), rel_cutoff)


def make_sharded_truncate(
    sspec: ShardedBPSpec,
    mesh: ShardMesh,
    chi: int,
    cutoff: float = 0.0,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    normalize_tensors: bool = True,
    axis: str = "v",
    site_dim: int = 2,
):
    """Sharded bond truncation (`truncate.jl:12-38`, BP flavor): identity
    two-site gates on every edge, color group by color group with halo-BP
    refreshes — exactly `truncate.batched_truncate` on the sharded state
    (it IS `make_sharded_layer` with the identity gate)."""
    d = site_dim
    gate = np.eye(d * d).reshape(d, d, d, d)
    return make_sharded_layer(
        sspec, mesh, gate, None, chi, cutoff=cutoff,
        normalize_tensors=normalize_tensors, bp_maxiter=bp_maxiter,
        bp_tolerance=bp_tolerance, axis=axis, initial_update=True,
    )
