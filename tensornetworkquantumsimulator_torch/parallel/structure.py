"""Compilation of a lattice into static-shape batch structure.

A copy of ``tensornetworkquantumsimulator_tpu.parallel.structure`` (numpy
only).  The graph is compiled once, in Python, into dense index tables:

- every vertex gets ``D = max_degree`` bond slots, dummy slots padded with
  bond dimension χ and identity messages (a δ-padded bond behaves exactly
  like a bond of dimension 1);
- vertex tensors become one array ``[V, χ, ..., χ, d]``;
- BP messages become one array ``[V, D, χ, χ]`` ("message arriving at vertex
  v through slot k");
- edge-color groups are bucketed by (slot_u, slot_v) so each bucket is a
  single batched update with a static axis layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.graphs import NamedGraph, edge_color


@dataclasses.dataclass(frozen=True)
class SlotPairBucket:
    """Edges of one color sharing (slot_u, slot_v): one vmapped kernel call."""

    slot_u: int
    slot_v: int
    u_idx: tuple  # vertex positions, static tuple for hashing
    v_idx: tuple


@dataclasses.dataclass(frozen=True)
class BatchedGraphSpec:
    """Static structure of a batched lattice (hashable, jit-friendly)."""

    vertices: tuple
    degree: int  # D = number of bond slots
    nbr: tuple  # [V][D] neighbor position (self for dummy slots)
    nbr_slot: tuple  # [V][D] slot on the neighbor pointing back
    slot_mask: tuple  # [V][D] True for real bonds
    color_groups: tuple  # tuple of tuples of SlotPairBucket
    edges: tuple  # all (u_pos, v_pos, slot_u, slot_v) in graph edge order

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def vertex_position(self, v) -> int:
        return self._pos[v]

    def __post_init__(self):
        object.__setattr__(
            self, "_pos", {v: i for i, v in enumerate(self.vertices)}
        )

    # numpy views (cached) -----------------------------------------------------
    def nbr_array(self):
        return np.asarray(self.nbr, dtype=np.int32)

    def nbr_slot_array(self):
        return np.asarray(self.nbr_slot, dtype=np.int32)

    def mask_array(self):
        return np.asarray(self.slot_mask, dtype=bool)


def compile_graph(g: NamedGraph, num_colors: int | None = None) -> BatchedGraphSpec:
    """Compile a NamedGraph into a :class:`BatchedGraphSpec`.

    Slot assignment is greedy per vertex in neighbor order; the edge-color
    groups come from the same proper coloring the reference uses for
    Trotterization (`edge_color`)."""
    vertices = tuple(g.vertices())
    pos = {v: i for i, v in enumerate(vertices)}
    D = max(1, g.max_degree())
    V = len(vertices)

    nbr = [[i] * D for i in range(V)]
    nbr_slot = [[0] * D for i in range(V)]
    mask = [[False] * D for _ in range(V)]
    slot_of = {}  # (u_pos, v_pos) -> slot on u
    fill = [0] * V
    edge_list = []
    for e in g.edges():
        iu, iv = pos[e.src], pos[e.dst]
        su, sv = fill[iu], fill[iv]
        fill[iu] += 1
        fill[iv] += 1
        nbr[iu][su] = iv
        nbr[iv][sv] = iu
        nbr_slot[iu][su] = sv
        nbr_slot[iv][sv] = su
        mask[iu][su] = True
        mask[iv][sv] = True
        slot_of[(iu, iv)] = su
        slot_of[(iv, iu)] = sv
        edge_list.append((iu, iv, su, sv))

    groups = []
    for group in edge_color(g, num_colors):
        buckets: dict = {}
        for e in group:
            iu, iv = pos[e.src], pos[e.dst]
            su, sv = slot_of[(iu, iv)], slot_of[(iv, iu)]
            buckets.setdefault((su, sv), []).append((iu, iv))
        bs = []
        for (su, sv), pairs in sorted(buckets.items()):
            bs.append(
                SlotPairBucket(
                    slot_u=su,
                    slot_v=sv,
                    u_idx=tuple(p[0] for p in pairs),
                    v_idx=tuple(p[1] for p in pairs),
                )
            )
        groups.append(tuple(bs))

    return BatchedGraphSpec(
        vertices=vertices,
        degree=D,
        nbr=tuple(map(tuple, nbr)),
        nbr_slot=tuple(map(tuple, nbr_slot)),
        slot_mask=tuple(map(tuple, mask)),
        color_groups=tuple(groups),
        edges=tuple(edge_list),
    )
