"""Boundary-MPS contraction engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.boundarymps``
(`src/MessagePassing/boundarympscache.jl`, the reference's planar-network
backend): the graph is partitioned into rows/columns forming a
line (or ring) of path partitions; inter-partition messages are MPS strands
(one tensor per crossing edge, chained by MPS bond indices); the outer loop
is BP over the partitions graph, and each message update is either

- "orthogonal": a one-site DMRG-style fitting sweep of the new boundary MPS
  against (old MPS × partition column) (`boundarympscache.jl:261-360`), or
- "ITensorMPS": a naive densify-and-truncate MPO×MPS apply
  (`boundarympscache.jl:476-496`), used for flat networks / certification.

Host reads.  The message tensors stay on the network's device.  The
fitting sweep reads each updated message's norm back (one read per
message update, to normalize it and to test the sweep's mean change
against the tolerance), and each scalar (`edge_scalar`, the vertex
scalars of `partitionfunction`) is read once: the reads of the JAX
package, none moved.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..models.forms import BilinearForm, QuadraticForm
from ..models.tensornetwork import TensorNetwork, TensorNetworkState
from ..ops.index import Index, commoninds, uniqueinds
from ..ops.linalg import qr_factor
from ..ops.paths import contraction_sequence
from ..ops.tensor import Tensor, contract, contract_pair, delta
from ..utils.graphs import NamedEdge, NamedGraph, forest_cover_edge_sequence
from .beliefpropagation import AbstractBeliefPropagationCache, default_tolerance
from .mps import generic_apply, mps_truncate

DEFAULT_BMPS_NITERS = 50  # `boundarympscache.jl:41`


class PartitionEdge:
    """Directed edge between partitions (labels are partition keys)."""

    __slots__ = ("src", "dst")

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst

    def reverse(self):
        return PartitionEdge(self.dst, self.src)

    def __eq__(self, other):
        return (
            isinstance(other, PartitionEdge)
            and self.src == other.src
            and self.dst == other.dst
        )

    def __hash__(self):
        return hash(("PE", self.src, self.dst))

    def __repr__(self):
        return f"P[{self.src}=>{self.dst}]"


class BoundaryMPSCache(AbstractBeliefPropagationCache):
    """`boundarympscache.jl:6-12`: network + messages + partitioned supergraph
    + per-partition-edge sorted crossing edges + the MPS bond dimension."""

    def __init__(
        self,
        tn,
        mps_bond_dimension: int,
        partition_by: str = "row",
        gauge_state: bool = False,
        set_messages: bool = True,
    ):
        if gauge_state and isinstance(tn, TensorNetworkState):
            from ..gauge import gauge_and_scale

            tn = gauge_and_scale(tn)
        self._network = tn
        self._messages: dict = {}
        self._mps_bond_dimension = mps_bond_dimension
        self._partition_by = partition_by

        def _first(v):
            return v[0] if isinstance(v, tuple) else v

        def _last(v):
            return v[-1] if isinstance(v, tuple) else v

        grouping = _first if partition_by == "row" else _last
        sorting = _last if partition_by == "row" else _first
        self._grouping = grouping
        self._sorting = sorting

        base = tn.graph()
        planar = base.copy()
        for e in _pseudo_planar_edges(base, grouping, sorting):
            planar.add_edge_inplace(e)
        self._planar = planar

        groups: dict = {}
        for v in planar.vertices():
            groups.setdefault(grouping(v), []).append(v)
        self._partitions = {p: sorted(vs, key=sorting) for p, vs in groups.items()}
        self._partition_of = {v: p for p, vs in self._partitions.items() for v in vs}

        # partitions graph
        pg = NamedGraph(self._partitions.keys())
        for e in planar.edges():
            p1, p2 = self._partition_of[e.src], self._partition_of[e.dst]
            if p1 != p2 and not pg.has_edge((p1, p2)):
                pg.add_edge_inplace(NamedEdge(p1, p2))
        self._partitions_graph = pg

        self._sorted_edges: dict = {}
        for pe_ in pg.edges():
            for pe in (PartitionEdge(pe_.src, pe_.dst), PartitionEdge(pe_.dst, pe_.src)):
                self._sorted_edges[pe] = _sorted_crossing_edges(
                    planar, self._partitions, pe
                )

        self._check_format()
        if set_messages:
            self.set_interpartition_messages_inplace()

    # -- bookkeeping -----------------------------------------------------------
    def _check_format(self):
        pg = self._partitions_graph
        if not (pg.is_line_graph() or pg.is_ring_graph()):
            raise ValueError(
                "Upon partitioning, graph does not form a line or ring: "
                "can't run boundary MPS"
            )
        for p in self._partitions:
            if not self.partition_graph(p).is_line_graph():
                raise ValueError(
                    "There's a partition that does not form a line: "
                    "can't run boundary MPS"
                )

    def network(self):
        return self._network

    def messages(self):
        return self._messages

    def graph(self):
        return self._planar

    def mps_bond_dimension(self):
        return self._mps_bond_dimension

    def partitions_graph(self) -> NamedGraph:
        return self._partitions_graph

    def partitionvertices(self, vertices=None) -> list:
        if vertices is None:
            return list(self._partitions.keys())
        out = []
        for v in vertices:
            p = self._partition_of[v]
            if p not in out:
                out.append(p)
        return out

    def partitionedges(self) -> list:
        return [PartitionEdge(e.src, e.dst) for e in self._partitions_graph.edges()]

    def all_partitionedges(self) -> list:
        pes = self.partitionedges()
        return pes + [pe.reverse() for pe in pes]

    def sorted_edges(self, pe: PartitionEdge) -> list:
        return self._sorted_edges[pe]

    def partition_vertices(self, p) -> list:
        return self._partitions[p]

    def partition_graph(self, p) -> NamedGraph:
        vs = self._partitions[p]
        vset = set(vs)
        g = NamedGraph(vs)
        for e in self._planar.edges():
            if e.src in vset and e.dst in vset:
                g.add_edge_inplace(e)
        return g

    def copy(self):
        obj = object.__new__(BoundaryMPSCache)
        obj._network = self._network.copy()
        obj._messages = dict(self._messages)
        obj._mps_bond_dimension = self._mps_bond_dimension
        obj._partition_by = self._partition_by
        obj._grouping = self._grouping
        obj._sorting = self._sorting
        obj._planar = self._planar
        obj._partitions = self._partitions
        obj._partition_of = self._partition_of
        obj._partitions_graph = self._partitions_graph
        obj._sorted_edges = self._sorted_edges
        return obj

    # -- message init -----------------------------------------------------------
    def virtual_index_dimension(self, e1: NamedEdge, e2: NamedEdge) -> int:
        """MPS bond dimension between two neighboring message tensors
        (`boundarympscache.jl:113-137`)."""
        pe = self._partitionedge_of(e1)
        es = self.sorted_edges(pe)
        if es.index(e1) > es.index(e2):
            lower_e, upper_e = e2, e1
        else:
            lower_e, upper_e = e1, e2
        pos_lower = es.index(lower_e)
        pos_upper = es.index(upper_e)
        inds_above = [
            i for e in es[pos_lower + 1 :] for i in self._network.virtualinds(e)
        ]
        inds_below = [i for e in es[:pos_upper] for i in self._network.virtualinds(e)]
        x1 = float(np.prod([float(i.dim) for i in inds_above], initial=1.0))
        x2 = float(np.prod([float(i.dim) for i in inds_below], initial=1.0))
        if isinstance(self._network, TensorNetworkState):
            return int(min(x1 * x1, x2 * x2, float(self._mps_bond_dimension)))
        return int(min(x1, x2, float(self._mps_bond_dimension)))

    def _partitionedge_of(self, e: NamedEdge) -> PartitionEdge:
        return PartitionEdge(self._partition_of[e.src], self._partition_of[e.dst])

    def set_interpartition_messages_inplace(self, partitionedges=None):
        """Product-MPS init entangled with computed virtual bonds
        (`boundarympscache.jl:172-194`)."""
        pes = partitionedges if partitionedges is not None else self.all_partitionedges()
        dtype = self.scalartype()
        for pe in pes:
            es = self.sorted_edges(pe)
            for e in es:
                if e not in self._messages:
                    self.setmessage(e, self.default_message(e))
            for i in range(len(es) - 1):
                virt_dim = self.virtual_index_dimension(es[i], es[i + 1])
                ind = Index(virt_dim, tags=(f"m{i}{i + 1}",))
                t = delta([ind], dtype=dtype, device=self._network.device())
                self.setmessage(es[i], contract_pair(self.message(es[i]), t))
                self.setmessage(es[i + 1], contract_pair(self.message(es[i + 1]), t))
        return self

    # -- message plumbing ----------------------------------------------------------
    def switch_messages_inplace(self, pe: PartitionEdge):
        """Swap (and conjugate) messages with their reverses on a partition
        edge (`boundarympscache.jl:198-210`)."""
        for e in self.sorted_edges(pe):
            me, mer = self.message(e), self.message(e.reverse())
            self.setmessage(e, _dag_any(mer))
            self.setmessage(e.reverse(), _dag_any(me))
        return self

    def delete_partition_messages_inplace(self, p):
        g = self.partition_graph(p)
        es = g.edges()
        for e in es + [e.reverse() for e in es]:
            self.deletemessage(e)
        return self

    def delete_interpartition_messages_inplace(self, pe: PartitionEdge):
        for e in self.sorted_edges(pe):
            self.deletemessage(e)
        return self

    # -- intra-partition (path) updates ------------------------------------------
    def update_partition_inplace(self, seq_or_partition):
        """Refresh intra-partition messages along a sequence (or a whole
        partition via its forest schedule) (`boundarympscache.jl:218-236`)."""
        if isinstance(seq_or_partition, list):
            seq = seq_or_partition
        else:
            seq = forest_cover_edge_sequence(self.partition_graph(seq_or_partition))
        for e in seq:
            m = self.updated_message(e, normalize=False, enforce_hermiticity=False)
            self.setmessage(e, m)
        return self

    def update_partitions(self, vertices_or_partitions):
        """Copy + refresh the intra messages of the partitions containing the
        given vertices (`boundarympscache.jl:239-257`)."""
        cache = self.copy()
        items = vertices_or_partitions
        ps = (
            self.partitionvertices(items)
            if items and items[0] in self._partition_of
            else items
        )
        for p in ps:
            cache.update_partition_inplace(p)
        return cache

    # -- scalars --------------------------------------------------------------------
    def vertex_scalar(self, v):
        if v in self._partitions:  # a partition label
            g = self.partition_graph(v)
            center = g.center()[0]
            cache = self.copy()
            cache.update_partition_inplace(g.post_order_dfs_edges(center))
            return AbstractBeliefPropagationCache.vertex_scalar(cache, center)
        return AbstractBeliefPropagationCache.vertex_scalar(self, v)

    def vertex_scalars(self, vertices=None):
        ps = vertices if vertices is not None else list(self._partitions.keys())
        return [self.vertex_scalar(p) for p in ps]

    def edge_scalar(self, pe):
        if isinstance(pe, NamedEdge):
            return AbstractBeliefPropagationCache.edge_scalar(self, pe)
        out = None
        for e in self.sorted_edges(pe):
            me, mer = self.message(e), self.message(e.reverse())
            for m in _as_list(me) + _as_list(mer):
                out = m if out is None else contract_pair(out, m)
        return out.scalar()

    def edge_scalars(self, edges=None):
        pes = edges if edges is not None else self.partitionedges()
        return [self.edge_scalar(pe) for pe in pes]

    # -- outer BP loop over partitions ------------------------------------------------
    def default_bp_maxiter(self):
        return 1 if self._partitions_graph.is_tree() else 5

    def default_bp_edge_sequence(self):
        return [
            PartitionEdge(e.src, e.dst)
            for e in forest_cover_edge_sequence(self._partitions_graph)
        ]

    def default_message_update_alg(self) -> str:
        tn = self._network
        if isinstance(tn, (TensorNetworkState, BilinearForm, QuadraticForm)):
            return "orthogonal"
        if isinstance(tn, TensorNetwork):
            return "ITensorMPS"
        raise ValueError("unrecognized network type for boundary MPS")

    def update(
        self,
        maxiter: int | None = None,
        edge_sequence=None,
        message_update_alg: str | None = None,
        tolerance=None,
        verbose: bool = False,
        **message_update_kwargs,
    ):
        """BP over the partitions graph (`abstractbeliefpropagationcache.jl:198`
        with the BMPS defaults of `boundarympscache.jl:14-27`)."""
        if maxiter is None:
            maxiter = self.default_bp_maxiter()
        if edge_sequence is None:
            edge_sequence = self.default_bp_edge_sequence()
        if message_update_alg is None:
            message_update_alg = self.default_message_update_alg()
        cache = self.copy()
        for _ in range(maxiter):
            for pe in edge_sequence:
                cache.update_message_partitionedge_inplace(
                    pe, alg=message_update_alg, **message_update_kwargs
                )
        return cache

    def update_message_partitionedge_inplace(
        self, pe: PartitionEdge, alg: str = "orthogonal", **kwargs
    ):
        if alg == "orthogonal":
            return self._update_message_orthogonal(pe, **kwargs)
        if alg == "ITensorMPS":
            return self._update_message_densify(pe, **kwargs)
        raise ValueError(f"unknown boundary MPS message update alg {alg!r}")

    # -- "orthogonal" one-site fitting sweep (`boundarympscache.jl:261-360`) -----
    def _gauge_step(self, e1: NamedEdge, e2: NamedEdge):
        """Move the orthogonality center from message(e1) to message(e2)."""
        m1, m2 = self.message(e1), self.message(e2)
        cinds = commoninds(m1.inds, m2.inds)
        if not cinds:
            raise ValueError("gauge step needs adjacent message tensors")
        left = uniqueinds(m1.inds, cinds)
        q, y = qr_factor(m1, left)
        self.setmessage(e1, q)
        self.setmessage(e2, contract_pair(y, m2))
        return self

    def _update_message_orthogonal(
        self,
        pe: PartitionEdge,
        niters: int = DEFAULT_BMPS_NITERS,
        tolerance=None,
        normalize: bool = True,
    ):
        if tolerance is None:
            tolerance = default_tolerance(self.scalartype())
        self.delete_partition_messages_inplace(pe.src)
        self.switch_messages_inplace(pe)
        es = self.sorted_edges(pe)
        g = self.partition_graph(pe.src)
        update_seq = list(es) + list(es[len(es) - 2 : 0 : -1])

        init_gauge_seq = [
            (es[i].reverse(), es[i - 1].reverse()) for i in range(len(es) - 1, 0, -1)
        ]
        init_update_seq = g.post_order_dfs_edges(update_seq[0].src)
        for (e1, e2) in init_gauge_seq:
            self._gauge_step(e1, e2)
        if init_update_seq:
            self.update_partition_inplace(init_update_seq)

        prev_cf, prev_e = 0.0, None
        for it in range(niters):
            cf = 0.0
            seq = update_seq if it < niters - 1 else update_seq + [es[0]]
            for update_e in seq:
                if prev_e is not None:
                    self._gauge_step(prev_e.reverse(), update_e.reverse())
                    path = g.a_star(prev_e.src, update_e.src)
                    if path:
                        self.update_partition_inplace(path)
                m = self.updated_message(
                    update_e, normalize=False, enforce_hermiticity=False
                )
                n = m.norm()
                cf += n
                if normalize and n != 0:
                    m = m * (1.0 / n)
                self.setmessage(update_e.reverse(), m.dag())
                prev_e = update_e
            cf /= len(seq)
            if tolerance is not None and abs(cf - prev_cf) < tolerance:
                break
            prev_cf = cf
        self.delete_partition_messages_inplace(pe.src)
        self.switch_messages_inplace(pe)
        return self

    # -- "ITensorMPS" densify-and-truncate (`boundarympscache.jl:476-496`) ------
    def prev_partitionedge(self, pe: PartitionEdge):
        pg = self._partitions_graph
        vns = pg.neighbors(pe.src)
        if len(vns) == 1:
            return None
        if len(vns) != 2:
            raise ValueError("partitions graph must be a line or ring")
        v1, v2 = vns
        if pe.dst == v1:
            return PartitionEdge(v2, pe.src)
        if pe.dst == v2:
            return PartitionEdge(v1, pe.src)
        return None

    def partition_mpo(self, p) -> list:
        """Sorted tensors of a partition as an MPO (`boundarympscache.jl:391-397`)."""
        return [self._network[v] for v in self._partitions[p]]

    def partitionedge_mps(self, pe: PartitionEdge) -> list:
        out = []
        for e in self.sorted_edges(pe):
            out.extend(_as_list(self.message(e)))
        return out

    def set_interpartition_message_inplace(self, tensors: list, pe: PartitionEdge):
        es = self.sorted_edges(pe)
        if len(tensors) != len(es):
            raise ValueError("strand length mismatch")
        for e, t in zip(es, tensors):
            self.setmessage(e, t)
        return self

    def truncate_interpartition_inplace(self, pe: PartitionEdge, maxdim=None, cutoff=None):
        m = mps_truncate(self.partitionedge_mps(pe), maxdim=maxdim, cutoff=cutoff)
        return self.set_interpartition_message_inplace(m, pe)

    def _update_message_densify(
        self, pe: PartitionEdge, cutoff: float = 1.0e-12, normalize: bool = True,
        maxdim: int | None = None,
    ):
        maxdim = maxdim if maxdim is not None else self._mps_bond_dimension
        prev_pe = self.prev_partitionedge(pe)
        o = mps_truncate(self.partition_mpo(pe.src), maxdim=maxdim, cutoff=cutoff)
        if prev_pe is None:
            out = generic_apply(o, None, normalize=normalize, maxdim=maxdim, cutoff=cutoff)
            return self.set_interpartition_message_inplace(out, pe)
        m = self.partitionedge_mps(prev_pe)
        out = generic_apply(o, m, normalize=normalize, maxdim=maxdim, cutoff=cutoff)
        return self.set_interpartition_message_inplace(out, pe)


def _dag_any(m):
    if isinstance(m, list):
        return [t.dag() for t in m]
    return m.dag()


def _as_list(m):
    return m if isinstance(m, list) else [m]


def _pseudo_planar_edges(g: NamedGraph, grouping, sorting) -> list:
    """Edges making each partition a path (`boundarympscache.jl:554-569`)."""
    partitions: dict = {}
    for v in g.vertices():
        partitions.setdefault(grouping(v), []).append(v)
    out = []
    for p, vs in partitions.items():
        vs = sorted(vs, key=sorting)
        for a, b in zip(vs, vs[1:]):
            if b not in g.neighbors(a):
                out.append(NamedEdge(a, b))
    return out


def _sorted_crossing_edges(planar: NamedGraph, partitions: dict, pe: PartitionEdge):
    """Bottom-to-top crossing edges between two partitions
    (`boundarympscache.jl:571-607`)."""
    src_vs = partitions[pe.src]
    dst_set = set(partitions[pe.dst])
    out = []
    for v in src_vs:
        for w in planar.neighbors(v):
            if w in dst_set:
                out.append(NamedEdge(v, w))
    return out


# ---------------------------------------------------------------------------
# measurement entry points used by `measure.py`
# ---------------------------------------------------------------------------


def path_contract(
    cache: BoundaryMPSCache,
    vs: list,
    op_string_f: Callable,
    bmps_messages_up_to_date: bool = False,
    calculate_denom: bool = True,
):
    """Numerator/denominator for observables along one partition path
    (`boundarympscache.jl:609-660`)."""
    ps = cache.partitionvertices(vs)
    if len(ps) > 1:
        raise ValueError(
            "Observable support must be within a single partition (row/column)."
        )
    p = ps[0]
    g = cache.partition_graph(p)
    if not bmps_messages_up_to_date:
        cache = cache.update_partitions([p])
    denom = cache.vertex_scalar(vs[0]) if calculate_denom else 0.0

    network = cache.network()
    if len(vs) > 1:
        leaves = g.leaf_vertices()
        lv1, lv2 = leaves[0], leaves[-1]
        path = g.a_star(lv1, lv2)
        lv1_vns = g.neighbors(lv1)
        prev_edge = None
        m = None
        for e in path:
            ignore = [e.reverse()] + ([prev_edge] if prev_edge is not None else [])
            incoming = cache.incoming_messages(e.src, ignore_edges=ignore)
            tensors = network.norm_factors([e.src], op_strings=op_string_f)
            tensors += incoming
            if m is not None:
                tensors.append(m)
            seq = contraction_sequence(tensors, alg="optimal")
            m = contract(tensors, seq)
            prev_edge = e
        tensors = network.norm_factors([lv2], op_strings=op_string_f)
        tensors += cache.incoming_messages(lv2, ignore_edges=[path[-1]])
        tensors.append(m)
        seq = contraction_sequence(tensors, alg="optimal")
        numer = contract(tensors, seq)
    else:
        tensors = network.norm_factors(vs, op_strings=op_string_f)
        tensors += cache.incoming_messages(vs[0])
        seq = contraction_sequence(tensors, alg="optimal")
        numer = contract(tensors, seq)
    return numer, denom


def expect_boundarymps(
    psi,
    observables: list,
    mps_bond_dimension: int | None = None,
    partition_by: str | None = None,
    gauge_state: bool = True,
    cache_update_kwargs: dict | None = None,
    bmps_messages_up_to_date: bool = False,
    **kwargs,
):
    """`expect.jl:85-155` boundary-MPS branch."""
    from ..measure import (
        boundarymps_partitioning,
        collectobservable,
        observables_vertices,
    )

    if isinstance(psi, BoundaryMPSCache):
        cache = psi
        if not bmps_messages_up_to_date:
            obs_vs = observables_vertices(observables, cache.network().graph())
            cache = cache.update_partitions(obs_vs)
    else:
        if partition_by is None:
            partition_by = boundarymps_partitioning(observables, psi.graph())
        cache = BoundaryMPSCache(
            psi, mps_bond_dimension, partition_by=partition_by, gauge_state=gauge_state
        )
        cache = cache.update(**(cache_update_kwargs or {}))
        obs_vs = observables_vertices(observables, psi.graph())
        cache = cache.update_partitions(obs_vs)

    out = []
    for obs in observables:
        op_strings, obs_vs, coeff = collectobservable(obs, cache.network().graph())
        if coeff == 0:
            out.append(0)
            continue
        table = {v: o for v, o in zip(obs_vs, op_strings)}
        op_f = lambda v: table.get(v, "I")
        numer, denom = path_contract(
            cache, obs_vs, op_f, bmps_messages_up_to_date=True
        )
        out.append(coeff * numer.scalar() / denom)
    return out


def rdm_boundarymps(
    psi,
    verts: list,
    normalize: bool = True,
    mps_bond_dimension: int | None = None,
    partition_by: str | None = None,
    cache_update_kwargs: dict | None = None,
    bmps_messages_up_to_date: bool = False,
    **kwargs,
):
    """`rdm.jl:72-115` boundary-MPS branch."""
    from ..measure import normalize_rdm

    if isinstance(psi, BoundaryMPSCache):
        cache = psi
    else:
        if partition_by is None:
            partition_by = _rdm_partitioning(verts)
        cache = BoundaryMPSCache(psi, mps_bond_dimension, partition_by=partition_by)
        cache = cache.update(**(cache_update_kwargs or {}))
    op_f = lambda v: "ρ" if v in verts else "I"
    rho, _ = path_contract(
        cache, verts, op_f, bmps_messages_up_to_date=bmps_messages_up_to_date,
        calculate_denom=False,
    )
    return normalize_rdm(rho) if normalize else rho


def _rdm_partitioning(vs):
    first = lambda v: v[0] if isinstance(v, tuple) else v
    last = lambda v: v[-1] if isinstance(v, tuple) else v
    if all(first(v) == first(vs[0]) for v in vs):
        return "row"
    if all(last(v) == last(vs[0]) for v in vs):
        return "col"
    raise ValueError("Vertices must align in a single column or row for BoundaryMPS.")


def truncate_boundarymps(
    psi: TensorNetworkState,
    mps_bond_dimension: int,
    maxdim: int,
    cutoff=None,
    gauge_state: bool = True,
    normalize_tensors: bool = True,
):
    """Boundary-MPS truncation: full-update per edge within row then column
    sweeps (`truncate.jl:40-96`)."""
    psi = psi.copy()
    for partition_by in ("row", "col"):
        cache = BoundaryMPSCache(
            psi, mps_bond_dimension, partition_by=partition_by, gauge_state=gauge_state
        )
        pg = cache.partitions_graph()
        leaves = pg.leaf_vertices()
        seq = [
            PartitionEdge(e.src, e.dst) for e in pg.a_star(leaves[-1], leaves[0])
        ]
        cache = cache.update(edge_sequence=seq, maxiter=1)
        cache = _truncate_bmps_cache(
            cache, maxdim=maxdim, cutoff=cutoff, normalize_tensors=normalize_tensors
        )
        psi = cache.network()
    return psi


def _truncate_bmps_cache(
    cache: BoundaryMPSCache, maxdim: int, cutoff=None, normalize_tensors: bool = True
):
    """`truncate.jl:40-72`."""
    from ..apply import full_update
    from ..truncate import _identity_gate, _truncatable_edge

    cache = cache.copy()
    s = cache.network().siteinds()
    dtype = cache.scalartype()
    ps = sorted(cache.partitionvertices())
    for i, p in enumerate(ps):
        g = cache.partition_graph(p)
        leaves = g.leaf_vertices()
        seq = g.a_star(leaves[-1], leaves[0])
        if seq:
            cache.update_partition_inplace(seq)
        for e in [e.reverse() for e in reversed(seq)]:
            if _truncatable_edge(cache, e):
                gate = _identity_gate(s, e.src, e.dst, dtype,
                                      cache.network().device())
                envs = cache.incoming_messages([e.src, e.dst])
                rv1, rv2 = full_update(
                    gate,
                    cache.network(),
                    [e.src, e.dst],
                    envs=envs,
                    maxdim=maxdim,
                    cutoff=cutoff,
                    symmetrize=True,
                )
                if normalize_tensors:
                    rv1, rv2 = rv1.normalize(), rv2.normalize()
                cache.setindex_preserve(rv1, e.src)
                cache.setindex_preserve(rv2, e.dst)
            cache.update_partition_inplace([e])
        if i != len(ps) - 1:
            cache = cache.update(
                edge_sequence=[PartitionEdge(ps[i], ps[i + 1])], maxiter=1
            )
    return cache
