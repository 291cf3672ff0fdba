"""2-D block-sharded SPMD: BP + full Trotter layer over an (Sx, Sy) mesh.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
sharding2d``.  Vertices sort into (block_x, block_y) tiles of equal size;
every cross-shard edge joins axis-adjacent blocks, so

- flooding BP exchanges 4 halo message packets per sweep (``ppermute``
  along "x" for row neighbours, along "y" for column neighbours, each
  acting per ring of the mesh);
- the Trotter layer's cross-shard gate buckets carry a direction tag and
  halo-exchange partner rows along that axis, with the strip layer's
  write-back (``sharded_layer``'s device buckets and layer program serve
  both layouts).

The host-side tables are the reference's (numpy, copied).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .sharded_layer import (
    _Bucket,
    _bond_values,
    _gauge_fn,
    _inverse_table,
    _make_layer,
)
from .engine import local_expectations
from .sharding import (
    HaloPlan,
    ShardedState,
    ShardMesh,
    _bp_fixed_point,
    check_mesh,
)
from .structure import BatchedGraphSpec, compile_graph

_DIRS = ("xprev", "xnext", "yprev", "ynext")
_REVERSE_DIR = {"xprev": "xnext", "xnext": "xprev",
                "yprev": "ynext", "ynext": "yprev"}


@dataclasses.dataclass(frozen=True)
class Sharded2DSpec:
    """Static tables for halo-exchange over an Sx × Sy block mesh."""

    spec: BatchedGraphSpec  # block-contiguous vertex order
    sx: int
    sy: int
    halo: int  # H = padded halo size (shared by the 4 directions)
    send_v: dict  # dir -> [S, H] local vertex positions to send
    send_slot: dict  # dir -> [S, H]
    src_index: np.ndarray  # [S, Vl, D] into concat(local, recv per _DIRS)
    mask: np.ndarray  # [S, Vl, D]

    @property
    def num_shards(self) -> int:
        return self.sx * self.sy


def shard2d_spec(g, sx: int, sy: int) -> Sharded2DSpec:
    """Compile a coordinate lattice into equal (sx × sy) blocks.

    Blocks slab the sorted unique first coordinates into sx groups and the
    second into sy groups; requires equal block populations and cross-block
    edges only between axis-adjacent blocks (grids/tori qualify)."""
    xs = sorted({float(v[0]) for v in g.vertices()})
    ys = sorted({float(v[1]) for v in g.vertices()})
    if len(xs) % sx or len(ys) % sy:
        raise ValueError("coordinate counts must divide the mesh shape")
    bx = {x: i * sx // len(xs) for i, x in enumerate(xs)}
    by = {y: j * sy // len(ys) for j, y in enumerate(ys)}

    def block(v):
        return (bx[float(v[0])], by[float(v[1])])

    vertices = sorted(g.vertices(), key=lambda v: (block(v), v))
    V = len(vertices)
    S = sx * sy
    if V % S:
        raise ValueError(f"{V} vertices not divisible by {S} blocks")
    Vl = V // S
    reordered = type(g)(vertices)
    for e in g.edges():
        reordered.add_edge_inplace(e)
    spec = compile_graph(reordered)
    assert list(spec.vertices) == vertices
    counts: dict = {}
    for v in vertices:
        counts[block(v)] = counts.get(block(v), 0) + 1
    if len(set(counts.values())) != 1:
        raise ValueError("blocks are not equally populated")

    def shard_of(pos):
        b = block(vertices[pos])
        return b[0] * sy + b[1]

    nbr = spec.nbr_array()
    nbr_slot = spec.nbr_slot_array()
    mask = spec.mask_array()
    D = spec.degree

    send: dict = {d: [[] for _ in range(S)] for d in _DIRS}
    src: list = [[[None] * D for _ in range(Vl)] for _ in range(S)]

    def delta_dir(b_from, b_to):
        """Direction tag for a message traveling b_from -> b_to.

        When an axis has only 2 blocks, prev == next, so interior and
        wrap edges merge under one tag (dx==1==sx-1 hits the first
        branch).  Delivery stays correct (same neighbor) and the
        inverse-select write-back tolerates the wider merged buckets."""
        dx = (b_from[0] - b_to[0]) % sx
        dy = (b_from[1] - b_to[1]) % sy
        if (dx, dy) == (0, 0):
            return None
        if dy == 0 and dx == sx - 1:
            return "xprev"  # sender is the previous x-block
        if dy == 0 and dx == 1:
            return "xnext"
        if dx == 0 and dy == sy - 1:
            return "yprev"
        if dx == 0 and dy == 1:
            return "ynext"
        raise ValueError("cross-shard edge between non-adjacent blocks")

    for v in range(V):
        s, lv = shard_of(v), v % Vl
        for k in range(D):
            if not mask[v, k]:
                src[s][lv][k] = ("local", 0)
                continue
            sender = int(nbr[v, k])
            j = int(nbr_slot[v, k])
            d = delta_dir(block(vertices[sender]), block(vertices[v]))
            if d is None:
                src[s][lv][k] = ("local", (sender % Vl) * D + j)
            else:
                lst = send[d][shard_of(sender)]
                entry = (sender % Vl, j)
                if entry not in lst:
                    lst.append(entry)
                src[s][lv][k] = (d, lst.index(entry))

    H = max([1] + [len(l) for d in _DIRS for l in send[d]])

    def pad(lists, field):
        out = np.zeros((S, H), np.int32)
        for s, lst in enumerate(lists):
            for i, e in enumerate(lst):
                out[s, i] = e[field]
        return out

    base = {"local": 0}
    for i, d in enumerate(_DIRS):
        base[d] = Vl * D + i * H
    src_index = np.zeros((S, Vl, D), np.int32)
    for s in range(S):
        for lv in range(Vl):
            for k in range(D):
                kind, p = src[s][lv][k]
                src_index[s, lv, k] = base[kind] + p

    return Sharded2DSpec(
        spec=spec,
        sx=sx,
        sy=sy,
        halo=H,
        send_v={d: pad(send[d], 0) for d in _DIRS},
        send_slot={d: pad(send[d], 1) for d in _DIRS},
        src_index=src_index,
        mask=spec.mask_array().reshape(S, Vl, D),
    )


def _perms(sx: int, sy: int):
    """ppermute pairs: receiving FROM the prev/next block along each axis."""
    return {
        # "recv from xprev" = every x-ring member sends to the next one
        "xprev": ("x", [(i, (i + 1) % sx) for i in range(sx)]),
        "xnext": ("x", [(i, (i - 1) % sx) for i in range(sx)]),
        "yprev": ("y", [(i, (i + 1) % sy) for i in range(sy)]),
        "ynext": ("y", [(i, (i - 1) % sy) for i in range(sy)]),
    }


def _check_block_mesh(sspec: Sharded2DSpec, mesh: ShardMesh) -> None:
    check_mesh(sspec, mesh, None)
    if mesh.shape != {"x": sspec.sx, "y": sspec.sy}:
        raise ValueError(f"a {sspec.sx}x{sspec.sy} block spec needs an "
                         f"('x', 'y') mesh of that shape, not {mesh!r}")


def block_plan(sspec: Sharded2DSpec, mesh: ShardMesh) -> HaloPlan:
    """The 4-direction BP exchange of the block layout."""
    _check_block_mesh(sspec, mesh)
    perms = _perms(sspec.sx, sspec.sy)
    dirs = [perms[d] + (sspec.send_v[d], sspec.send_slot[d]) for d in _DIRS]
    return HaloPlan(mesh, dirs, sspec.src_index, sspec.mask)


def _bp2d_fixed_point(plan: HaloPlan, tensors, messages, maxiter,
                      tolerance):
    """Per-shard flooding BP with 4-direction halo exchange: the strip
    fixed point over the block plan, whose four receive directions follow
    the local messages in ``_DIRS`` order."""
    return _bp_fixed_point(plan, tensors, messages, maxiter, tolerance)


@dataclasses.dataclass(frozen=True)
class _Intra2D:
    slot_u: int
    slot_v: int
    u_tab: np.ndarray
    v_tab: np.ndarray
    valid: np.ndarray
    u_inv: np.ndarray  # [S, Vl] write-back lane per local vertex
    u_wr: np.ndarray  # [S, Vl]
    v_inv: np.ndarray
    v_wr: np.ndarray


@dataclasses.dataclass(frozen=True)
class _Cross2D:
    slot_u: int
    slot_v: int
    dir: str  # _DIRS entry: where the PARTNER (v) lives
    u_tab: np.ndarray
    vsend_tab: np.ndarray
    valid: np.ndarray
    u_inv: np.ndarray
    u_wr: np.ndarray
    vs_inv: np.ndarray
    vs_wr: np.ndarray


def _neighbor_fn(sx: int, sy: int):
    def neighbor(s, d):
        x, y = s // sy, s % sy
        if d == "xnext":
            return ((x + 1) % sx) * sy + y
        if d == "xprev":
            return ((x - 1) % sx) * sy + y
        if d == "ynext":
            return x * sy + (y + 1) % sy
        return x * sy + (y - 1) % sy

    return neighbor


def build_layer_groups_2d(sspec: Sharded2DSpec):
    """Intra/cross bucket tables per color group for the 2-D block mesh."""
    spec = sspec.spec
    sx, sy = sspec.sx, sspec.sy
    S = sx * sy
    Vl = spec.num_vertices // S
    neighbor = _neighbor_fn(sx, sy)

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
                    continue
                d = next(
                    (d for d in _DIRS if neighbor(su_s, d) == sv_s), None
                )
                if d is None:
                    raise ValueError("non-adjacent cross-block edge")
                cross.setdefault((b.slot_u, b.slot_v, d), []).append(
                    (su_s, iu % Vl, iv % Vl)
                )

        buckets = []
        for (su, sv), entries in sorted(intra.items()):
            per = [[] for _ in range(S)]
            for (s, lu, lv) in entries:
                per[s].append((lu, lv))
            B = max(1, max(len(l) for l in per))
            u_tab = np.zeros((S, B), np.int32)
            v_tab = np.zeros((S, B), np.int32)
            valid = np.zeros((S, B), bool)
            for s, lst in enumerate(per):
                for i, (lu, lv) in enumerate(lst):
                    u_tab[s, i], v_tab[s, i], valid[s, i] = lu, lv, True
            u_inv, u_wr = _inverse_table(
                [[(lu, i) for i, (lu, _) in enumerate(lst)] for lst in per],
                Vl)
            v_inv, v_wr = _inverse_table(
                [[(lv, i) for i, (_, lv) in enumerate(lst)] for lst in per],
                Vl)
            buckets.append(_Intra2D(
                su, sv, u_tab, v_tab, valid, u_inv, u_wr, v_inv, v_wr))
        for (su, sv, d), entries in sorted(cross.items()):
            per = [[] for _ in range(S)]
            for (s, lu, lv) in entries:
                per[s].append((lu, lv))
            B = max(1, max(len(l) for l in per))
            u_tab = np.zeros((S, B), np.int32)
            vsend = np.zeros((S, B), np.int32)
            valid = np.zeros((S, B), bool)
            for s, lst in enumerate(per):
                for i, (lu, lv) in enumerate(lst):
                    u_tab[s, i], valid[s, i] = lu, True
            vs_pairs: list = [[] for _ in range(S)]
            for s in range(S):
                sender = neighbor(s, d)
                for i, (_, lv) in enumerate(per[s]):
                    vsend[sender, i] = lv
                    vs_pairs[sender].append((lv, i))
            u_inv, u_wr = _inverse_table(
                [[(lu, i) for i, (lu, _) in enumerate(lst)] for lst in per],
                Vl)
            vs_inv, vs_wr = _inverse_table(vs_pairs, Vl)
            buckets.append(_Cross2D(
                su, sv, d, u_tab, vsend, valid, u_inv, u_wr, vs_inv, vs_wr))
        groups.append(tuple(buckets))
    return tuple(groups)


def _block_xfer(sspec: Sharded2DSpec, d):
    """A block bucket's exchanges: partner rows come from direction ``d``
    and the update goes back the reverse way."""
    if d is None:
        return None
    perms = _perms(sspec.sx, sspec.sy)
    return perms[d], perms[_REVERSE_DIR[d]]


def make_sharded_layer_2d(
    sspec: Sharded2DSpec,
    mesh: ShardMesh,
    gate2: np.ndarray,
    gate1: np.ndarray | None,
    chi: int,
    cutoff: float = 1e-12,
    normalize_tensors: bool = True,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    one_site_first: bool = True,
    final_update: bool = True,
):
    """SPMD Trotter layer over a 2-D ("x", "y") mesh; same semantics and
    write-back contract as the 1-D `make_sharded_layer`."""
    plan = block_plan(sspec, mesh)
    groups = []
    for group in build_layer_groups_2d(sspec):
        bks = []
        for b in group:
            if isinstance(b, _Intra2D):
                bks.append(_Bucket(mesh, b.slot_u, b.slot_v, None, b.u_tab,
                                   b.v_tab, b.valid, b.u_inv, b.u_wr,
                                   b.v_inv, b.v_wr))
            else:
                bks.append(_Bucket(mesh, b.slot_u, b.slot_v,
                                   _block_xfer(sspec, b.dir), b.u_tab,
                                   b.vsend_tab, b.valid, b.u_inv, b.u_wr,
                                   b.vs_inv, b.vs_wr))
        groups.append(bks)
    return _make_layer(mesh, functools.partial(_bp2d_fixed_point, plan),
                       groups, gate2, gate1, chi, cutoff, normalize_tensors,
                       bp_maxiter, bp_tolerance, one_site_first, final_update,
                       False)


# ---------------------------------------------------------------------------
# 2-D sharded measurement + gauge
# ---------------------------------------------------------------------------


def make_sharded_site_expectations_2d(sspec: Sharded2DSpec, mesh: ShardMesh):
    """``fn(sstate, op) -> [V]`` of per-vertex ⟨op⟩ on the (Sx, Sy) block
    mesh: vertex-local once messages are converged, so no exchange (the
    2-D twin of `sharded_layer.make_sharded_site_expectations`); the op
    is passed at call time."""
    _check_block_mesh(sspec, mesh)
    spec = sspec.spec

    def site_fn(sstate: ShardedState, op):
        op = np.asarray(op)
        return mesh.collect([local_expectations(spec, st, op)
                             for st in sstate.shards])

    return site_fn


def _build_bond_tables_2d(sspec: Sharded2DSpec):
    """Bucket ``spec.edges`` by (slot_u, slot_v, direction-of-partner)
    with per-shard 0-padded gather tables — the 2-D twin of
    `sharded_layer._build_bond_tables`; direction is one of `_DIRS` (or
    None for intra-block), naming which axis neighbor owns the partner
    vertex."""
    spec = sspec.spec
    S, sx, sy = sspec.num_shards, sspec.sx, sspec.sy
    Vl = spec.num_vertices // S

    def xy(s):
        return divmod(s, sy)

    neighbor = _neighbor_fn(sx, sy)

    grouped: dict = {}
    for pos, (iu, iv, su, sv) in enumerate(spec.edges):
        s_u, s_v = iu // Vl, iv // Vl
        if s_u == s_v:
            d = None
        else:
            bu, bv = xy(s_u), xy(s_v)
            dx = (bv[0] - bu[0]) % sx
            dy = (bv[1] - bu[1]) % sy
            if dy == 0 and dx == sx - 1:
                d = "xprev"  # partner lives in the previous x-block
            elif dy == 0 and dx == 1:
                d = "xnext"
            elif dx == 0 and dy == sy - 1:
                d = "yprev"
            elif dx == 0 and dy == 1:
                d = "ynext"
            else:
                raise ValueError(
                    "cross-shard edge between non-adjacent blocks"
                )
        grouped.setdefault((su, sv, d), []).append(
            (s_u, iu % Vl, iv % Vl, pos)
        )

    out = []
    for (su, sv, d), entries in sorted(
        grouped.items(), key=lambda kv: (kv[0][0], kv[0][1], str(kv[0][2]))
    ):
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
                if d is None:
                    v_tab[s, i] = lv
                    v_pairs[s].append((lv, i))
        if d is not None:
            # partner rows laid out in the SENDER shard's row at the
            # computing shard's lane index; ppermute(d) aligns them
            for s, lst in enumerate(per_shard):
                sender = neighbor(s, d)
                for i, (_, lv, _) in enumerate(lst):
                    v_tab[sender, i] = lv
                    v_pairs[sender].append((lv, i))
        u_inv, u_wr = _inverse_table(
            [[(lu, i) for i, (lu, _, _) in enumerate(lst)]
             for lst in per_shard], Vl)
        v_inv, v_wr = _inverse_table(v_pairs, Vl)
        out.append((su, sv, d, u_tab, v_tab, valid, pos_tab,
                    u_inv, u_wr, v_inv, v_wr))
    return out


def _block_bond_buckets(sspec: Sharded2DSpec, mesh: ShardMesh) -> list:
    from .sharded_layer import _bond_buckets

    _check_block_mesh(sspec, mesh)
    return _bond_buckets(mesh, _build_bond_tables_2d(sspec),
                         lambda d: _block_xfer(sspec, d))


def make_sharded_bond_expectations_2d(sspec: Sharded2DSpec, mesh: ShardMesh,
                                      op1, op2):
    """``fn(sstate) -> [E]`` of ⟨op1 ⊗ op2⟩ on every edge (order of
    ``spec.edges``) over the (Sx, Sy) block mesh: each edge evaluates on
    the block owning u; partners halo in with ONE ``ppermute`` along the
    right mesh axis per (slot-pair, direction) bucket.  The 2-D twin of
    `sharded_layer.make_sharded_bond_expectations`."""
    return _bond_values(mesh, _block_bond_buckets(sspec, mesh),
                        len(sspec.spec.edges), op1, op2)


def make_sharded_gauge_2d(sspec: Sharded2DSpec, mesh: ShardMesh,
                          rel_cutoff: float | None = None):
    """``fn(sstate) -> (sstate, spectra[E, χ])``: Vidal/symmetric gauge
    (`symmetric_gauge.jl:85-114`) on the 2-D block-sharded state — the
    block-mesh twin of `sharded_layer.make_sharded_gauge`."""
    return _gauge_fn(mesh, _block_bond_buckets(sspec, mesh),
                     len(sspec.spec.edges), rel_cutoff)
