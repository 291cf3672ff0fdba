"""Lattice constructors.

A jax-free copy of ``tensornetworkquantumsimulator_tpu.utils.lattices``
(the reference's `graph_ops.jl` geometry and NamedGraphs re-exports):
grids, paths, comb trees, heavy-hex and Eagle, Lieb, triangular and kagome
lattices, and graphs from adjacency lists or circuits.  Vertex naming and
edge order follow the JAX package exactly, so both packages compile the
same slot tables.
"""

from __future__ import annotations

import itertools

import networkx as nx

from .graphs import NamedEdge, NamedGraph


def named_grid(dims, periodic=False) -> NamedGraph:
    """n-dimensional grid with 1-based tuple vertices; `periodic=True` wraps
    every axis (used for 3-d tori, `examples/3dIsing_dynamics.jl:8`).
    ``periodic`` may also be a per-axis tuple, e.g. ``(True, False)`` for a
    cylinder — rows then form the ring partition graph the boundary-MPS
    cache accepts (`boundarympscache.jl:66-78`)."""
    if isinstance(dims, int):
        dims = (dims,)
    dims = tuple(dims)
    if isinstance(periodic, bool):
        periodic = (periodic,) * len(dims)
    periodic = tuple(periodic)
    if len(periodic) != len(dims):
        raise ValueError("periodic must be a bool or one flag per axis")
    ranges = [range(1, d + 1) for d in dims]
    vertices = list(itertools.product(*ranges))
    g = NamedGraph(vertices)
    for v in vertices:
        for axis, d in enumerate(dims):
            if v[axis] < d:
                w = list(v)
                w[axis] += 1
                g.add_edge_inplace(NamedEdge(v, tuple(w)))
            elif periodic[axis] and d > 2:
                w = list(v)
                w[axis] = 1
                g.add_edge_inplace(NamedEdge(v, tuple(w)))
    if len(dims) >= 2 and all(d == 1 for d in dims[1:]):
        # named_grid((n, 1)) keeps tuple names in the reference; only a true
        # 1-d spec collapses to integers
        return g
    if len(dims) == 1:
        return g.rename_vertices(lambda v: v[0])
    return g


def named_path_graph(n: int) -> NamedGraph:
    g = NamedGraph(range(1, n + 1))
    for i in range(1, n):
        g.add_edge_inplace(NamedEdge(i, i + 1))
    return g


def named_comb_tree(dims) -> NamedGraph:
    """Comb tree: a backbone path (x, 1) with teeth (x, y)
    (NamedGraphs `named_comb_tree`)."""
    nx_, ny_ = dims
    g = NamedGraph([(x, y) for x in range(1, nx_ + 1) for y in range(1, ny_ + 1)])
    for x in range(1, nx_):
        g.add_edge_inplace(NamedEdge((x, 1), (x + 1, 1)))
    for x in range(1, nx_ + 1):
        for y in range(1, ny_):
            g.add_edge_inplace(NamedEdge((x, y), (x, y + 1)))
    return g


def named_hexagonal_lattice_graph(m: int, n: int) -> NamedGraph:
    """Hexagonal (honeycomb) lattice with m x n hexagons, matching
    NamedGraphs.jl's construction (networkx `hexagonal_lattice_graph` with
    1-based coordinate names)."""
    h = nx.hexagonal_lattice_graph(m, n)
    h = nx.relabel_nodes(h, {v: (v[0] + 1, v[1] + 1) for v in h.nodes})
    g = NamedGraph()
    for v in sorted(h.nodes):
        g.add_vertex_inplace(v)
    for u, v in sorted(h.edges):
        g.add_edge_inplace(NamedEdge(u, v))
    return g


def heavy_hexagonal_lattice(nx_: int, ny_: int) -> NamedGraph:
    """IBM-style heavy-hex: hexagonal lattice with a degree-2 vertex inserted
    on every edge (`graph_ops.jl:6-18`)."""
    g = named_hexagonal_lattice_graph(nx_, ny_)
    g = g.rename_vertices(lambda v: (2 * v[0] - 1, 2 * v[1] - 1))
    out = g.copy()
    for e in g.edges():
        vsrc, vdst = e.src, e.dst
        v_new = ((vsrc[0] + vdst[0]) / 2, (vsrc[1] + vdst[1]) / 2)
        out.add_vertex_inplace(v_new)
        out.rem_edge_inplace(e)
        out.add_edge_inplace(NamedEdge(vsrc, v_new))
        out.add_edge_inplace(NamedEdge(v_new, vdst))
    return out


def ibm_eagle_lattice() -> NamedGraph:
    """The 127-qubit IBM-Eagle heavy-hex topology (the utility-scale
    kicked-Ising geometry): 7 long rows of 14/15 qubits on columns 0–14,
    bridged every 4 columns with alternating offset; 127 vertices, 144
    edges, max degree 3.

    Vertices are (row, col) with bridge qubits at (row + 0.5, col)."""
    g = NamedGraph()
    rows = range(7)
    cols_of = {0: range(0, 14), 6: range(1, 15)}
    for r in rows:
        cols = cols_of.get(r, range(0, 15))
        prev = None
        for c in cols:
            v = (r, c)
            g.add_vertex_inplace(v)
            if prev is not None:
                g.add_edge_inplace(NamedEdge(prev, v))
            prev = v
    for r in range(6):
        offset = 0 if r % 2 == 0 else 2
        for c in range(offset, 15, 4):
            if not (g.has_vertex((r, c)) and g.has_vertex((r + 1, c))):
                continue
            b = (r + 0.5, c)
            g.add_vertex_inplace(b)
            g.add_edge_inplace(NamedEdge((r, c), b))
            g.add_edge_inplace(NamedEdge(b, (r + 1, c)))
    return g


def _gate_vertices(spec):
    if isinstance(spec, NamedEdge):
        return [spec.src, spec.dst]
    if isinstance(spec, list):
        return spec
    if isinstance(spec, tuple) and any(isinstance(x, tuple) for x in spec):
        return list(spec)
    # a bare coordinate tuple (or scalar) names a single vertex
    return [spec]


def lieb_lattice(nx_: int, ny_: int, periodic: bool = False) -> NamedGraph:
    """Lieb lattice: square grid with even-even vertices removed
    (`graph_ops.jl:25-38`)."""
    ok = (not periodic and nx_ % 2 == 1 and ny_ % 2 == 1) or (
        periodic and nx_ % 2 == 0 and ny_ % 2 == 0
    )
    if not ok:
        raise ValueError("lieb_lattice: odd dims if open, even dims if periodic")
    g = named_grid((nx_, ny_), periodic=periodic)
    for v in list(g.vertices()):
        if v[0] % 2 == 0 and v[1] % 2 == 0:
            g.rem_vertex_inplace(v)
    return g


def triangular_lattice(nx_: int, ny_: int, periodic: bool = False) -> NamedGraph:
    """nx×ny triangular lattice: the square grid plus one diagonal per
    plaquette, giving interior vertices degree 6 (2 up / 2 down / left /
    right).  No reference counterpart (the reference builds custom graphs
    for such geometries by hand); the batched engine is degree-generic, so
    triangular states run through the same BP/simple-update path as grids
    (degree-6 is already exercised by the 3-d torus).  ``periodic`` wraps
    both axes (needs nx, ny > 2, like `named_grid`)."""
    g = named_grid((nx_, ny_), periodic=periodic)
    rmax = nx_ if periodic else nx_ - 1
    cmax = ny_ if periodic else ny_ - 1
    if periodic and (nx_ <= 2 or ny_ <= 2):
        raise ValueError("periodic triangular lattice needs nx, ny > 2")
    for r in range(1, rmax + 1):
        for c in range(1, cmax + 1):
            v = (r, c)
            w = (r % nx_ + 1, c % ny_ + 1)
            g.add_edge_inplace(NamedEdge(v, w))
    return g


def kagome_lattice(m: int, n: int) -> NamedGraph:
    """Kagome (trihexagonal) lattice with m×n hexagons: the medial graph of
    the hexagonal lattice — one vertex per honeycomb edge (named by its
    midpoint coordinates), two vertices adjacent when their honeycomb edges
    share an endpoint.  Corner-sharing triangles, degree ≤ 4.  No reference
    counterpart; runs on the generic and batched engines like any graph."""
    hg = named_hexagonal_lattice_graph(m, n)
    mid = {}
    for e in hg.edges():
        u, v = e.src, e.dst
        mid[frozenset((u, v))] = ((u[0] + v[0]) / 2, (u[1] + v[1]) / 2)
    if len(set(mid.values())) != len(mid):
        raise ValueError("hexagonal embedding produced colliding midpoints")
    g = NamedGraph(sorted(mid.values()))
    for hv in hg.vertices():
        incident = sorted(
            mid[frozenset((hv, w))] for w in hg.neighbors(hv)
        )
        for a, b in itertools.combinations(incident, 2):
            if not g.has_edge(NamedEdge(a, b)):
                g.add_edge_inplace(NamedEdge(a, b))
    return g


def topology_to_graph(topology) -> NamedGraph:
    """Adjacency-pair list -> graph with integer vertices (`graph_ops.jl:40-49`)."""
    nq = max(max(pair) for pair in topology)
    g = NamedGraph(range(1, nq + 1))
    for i, j in topology:
        g.add_edge_inplace(NamedEdge(i, j))
    return g


def build_graph_from_gates(circuit) -> NamedGraph:
    """Infer the lattice from a circuit's two-site gate support
    (`graph_ops.jl:53-69`); errors if disconnected."""
    vs = []
    seen = set()
    for gate in circuit:
        for v in _gate_vertices(gate[1]):
            if v not in seen:
                seen.add(v)
                vs.append(v)
    g = NamedGraph(vs)
    for gate in circuit:
        qubits = _gate_vertices(gate[1])
        if len(qubits) == 2:
            if not g.has_edge(NamedEdge(qubits[0], qubits[1])):
                g.add_edge_inplace(NamedEdge(qubits[0], qubits[1]))
    if not g.is_connected():
        raise ValueError(
            "The circuit graph is not connected; simulate the connected "
            "components separately (no entanglement is generated between them)."
        )
    return g


build_graph_from_circuit = build_graph_from_gates
