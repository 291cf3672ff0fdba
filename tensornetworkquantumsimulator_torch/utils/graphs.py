"""Named graphs and the graph algorithms the contraction engines need.

A jax-free copy of ``tensornetworkquantumsimulator_tpu.utils.graphs``: the
Python/networkx counterpart of the reference's NamedGraphs.jl layer
(`src/imports.jl:6-45`).  Vertices are arbitrary hashables (usually
coordinate tuples); message edges are directed :class:`NamedEdge` pairs.
It holds the graph queries of the generic engine (trees, forest covers,
Steiner trees, boundaries), its sequential BP schedule
(:func:`forest_cover_edge_sequence`), the proper edge colouring of the
batched engine and the loop enumeration of the loop-correction series.
Every algorithm is the reference's own, so the port compiles the same slot
tables and colour groups, and walks the same BP schedule, as the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable, Iterable

import networkx as nx


@dataclass(frozen=True)
class NamedEdge:
    """A directed edge (messages live on directed edges)."""

    src: Hashable
    dst: Hashable

    def reverse(self) -> "NamedEdge":
        return NamedEdge(self.dst, self.src)

    def __repr__(self):
        return f"{self.src}=>{self.dst}"

    def __iter__(self):
        return iter((self.src, self.dst))


def reverse(e: NamedEdge) -> NamedEdge:
    return e.reverse()


def src(e: NamedEdge):
    return e.src


def dst(e: NamedEdge):
    return e.dst


class NamedGraph:
    """Undirected graph with insertion-ordered vertices/edges.

    Mirrors the NamedGraphs.jl surface the reference uses: `vertices`,
    `edges`, `neighbors`, `add_edge(!)`, `rem_vertex(!)`, `steiner_tree`,
    `forest_cover`, `post_order_dfs_edges`, `a_star`, `center`, ...
    """

    def __init__(self, vertices: Iterable = (), edges: Iterable = ()):
        self._g = nx.Graph()
        for v in vertices:
            self._g.add_node(v)
        for e in edges:
            self.add_edge_inplace(e)

    # -- structure ----------------------------------------------------------
    @classmethod
    def _wrap(cls, g: nx.Graph) -> "NamedGraph":
        out = cls()
        out._g = g
        return out

    def nx(self) -> nx.Graph:
        return self._g

    def copy(self) -> "NamedGraph":
        return NamedGraph._wrap(self._g.copy())

    def vertices(self) -> list:
        return list(self._g.nodes)

    def edges(self) -> list:
        return [NamedEdge(u, v) for u, v in self._g.edges]

    def nv(self) -> int:
        return self._g.number_of_nodes()

    def ne(self) -> int:
        return self._g.number_of_edges()

    def has_vertex(self, v) -> bool:
        return v in self._g

    def has_edge(self, e) -> bool:
        u, v = (e.src, e.dst) if isinstance(e, NamedEdge) else e
        return self._g.has_edge(u, v)

    def neighbors(self, v) -> list:
        return list(self._g.neighbors(v))

    def degree(self, v) -> int:
        return self._g.degree(v)

    def max_degree(self) -> int:
        return max((d for _, d in self._g.degree), default=0)

    def add_vertex(self, v) -> "NamedGraph":
        g = self.copy()
        g.add_vertex_inplace(v)
        return g

    def add_vertex_inplace(self, v):
        self._g.add_node(v)
        return self

    def add_edge(self, e, v=None) -> "NamedGraph":
        if v is not None:
            e = NamedEdge(e, v)
        g = self.copy()
        g.add_edge_inplace(e)
        return g

    def add_edge_inplace(self, e, v=None):
        if v is not None:
            e = NamedEdge(e, v)
        u, w = (e.src, e.dst) if isinstance(e, NamedEdge) else e
        self._g.add_edge(u, w)
        return self

    def add_edges(self, es) -> "NamedGraph":
        g = self.copy()
        for e in es:
            g.add_edge_inplace(e)
        return g

    def rem_edge(self, e) -> "NamedGraph":
        g = self.copy()
        g.rem_edge_inplace(e)
        return g

    def rem_edge_inplace(self, e):
        u, v = (e.src, e.dst) if isinstance(e, NamedEdge) else e
        self._g.remove_edge(u, v)
        return self

    def rem_edges_inplace(self, es):
        for e in es:
            self.rem_edge_inplace(e)
        return self

    def rem_vertex(self, v) -> "NamedGraph":
        g = self.copy()
        g.rem_vertex_inplace(v)
        return g

    def rem_vertex_inplace(self, v):
        self._g.remove_node(v)
        return self

    def rename_vertices(self, f) -> "NamedGraph":
        return NamedGraph._wrap(nx.relabel_nodes(self._g, {v: f(v) for v in self._g}))

    def subgraph(self, vs) -> "NamedGraph":
        return NamedGraph._wrap(self._g.subgraph(vs).copy())

    def incident_edges(self, v) -> list:
        return [NamedEdge(v, w) for w in self._g.neighbors(v)]

    def __eq__(self, other):
        if not isinstance(other, NamedGraph):
            return NotImplemented
        return set(self._g.nodes) == set(other._g.nodes) and {
            frozenset(e) for e in self._g.edges
        } == {frozenset(e) for e in other._g.edges}

    def __repr__(self):
        return f"NamedGraph({self.nv()} vertices, {self.ne()} edges)"

    # -- queries -------------------------------------------------------------
    def is_connected(self) -> bool:
        return self.nv() > 0 and nx.is_connected(self._g)

    def is_tree(self) -> bool:
        return self.nv() > 0 and nx.is_tree(self._g)

    def connected_components(self) -> list:
        return [list(c) for c in nx.connected_components(self._g)]

    def center(self) -> list:
        return sorted(nx.center(self._g))

    def leaf_vertices(self) -> list:
        return [v for v in self._g.nodes if self._g.degree(v) == 1]

    def is_line_graph(self) -> bool:
        """A path: a tree whose degrees are [1, 1, 2, 2, ...] (`utils.jl:2-10`)."""
        if self.nv() == 1:
            return True
        if not self.is_tree():
            return False
        ds = sorted(d for _, d in self._g.degree)
        return ds == [1, 1] + [2] * (self.nv() - 2)

    def is_ring_graph(self) -> bool:
        if self.ne() == 0:
            return False
        g = self.rem_edge(self.edges()[0])
        return g.is_line_graph()

    # -- paths and trees -----------------------------------------------------
    def a_star(self, v1, v2) -> list:
        """Shortest path from v1 to v2 as a list of directed edges."""
        path = nx.shortest_path(self._g, v1, v2)
        return [NamedEdge(a, b) for a, b in zip(path, path[1:])]

    def steiner_tree(self, terminal_vs) -> "NamedGraph":
        t = nx.algorithms.approximation.steiner_tree(self._g, list(terminal_vs))
        if t.number_of_nodes() == 0:  # single terminal
            t = self._g.subgraph(list(terminal_vs)).copy()
        return NamedGraph._wrap(nx.Graph(t))

    def post_order_dfs_edges(self, root) -> list:
        """Edges of a tree directed child→parent, leaves first
        (NamedGraphs `post_order_dfs_edges`)."""
        order = list(nx.dfs_postorder_nodes(self._g, root))
        parent = {root: None}
        for u, v in nx.dfs_edges(self._g, root):
            parent[v] = u
        return [NamedEdge(v, parent[v]) for v in order if parent.get(v) is not None]

    def forest_cover(self) -> list:
        """Partition the edges into spanning forests (NamedGraphs
        `forest_cover`): greedily peel maximal forests until all edges used."""
        remaining = set(frozenset((u, v)) for u, v in self._g.edges)
        forests = []
        while remaining:
            uf = nx.utils.UnionFind(self._g.nodes)
            forest_edges = []
            for e in list(self.edges()):
                key = frozenset((e.src, e.dst))
                if key in remaining and uf[e.src] != uf[e.dst]:
                    uf.union(e.src, e.dst)
                    forest_edges.append(e)
                    remaining.discard(key)
            f = NamedGraph(self.vertices())
            for e in forest_edges:
                f.add_edge_inplace(e)
            forests.append(f)
        return forests

    def boundary_edges(self, vs, dir: str = "in") -> list:
        """Edges crossing the boundary of vertex set ``vs``; ``dir="in"``
        orients them pointing into the set (NamedGraphs `boundary_edges`)."""
        vset = set(vs)
        out = []
        for v in vs:
            for w in self._g.neighbors(v):
                if w not in vset:
                    out.append(NamedEdge(w, v) if dir == "in" else NamedEdge(v, w))
        return out


# ---------------------------------------------------------------------------
# schedules / colorings
# ---------------------------------------------------------------------------


def forest_cover_edge_sequence(g: NamedGraph, root_vertex=None) -> list:
    """The reference's default sequential BP schedule
    (`beliefpropagationcache.jl:74-85`): per forest, per tree, post-order DFS
    edges toward the root then the same edges reversed — tree-exact in one
    sweep."""
    edges = []
    for forest in g.forest_cover():
        for comp in forest.connected_components():
            tree = forest.subgraph(comp)
            if tree.ne() == 0:
                continue
            root = root_vertex if root_vertex in comp else _default_root(tree)
            tree_edges = tree.post_order_dfs_edges(root)
            edges.extend(tree_edges)
            edges.extend(e.reverse() for e in reversed(tree_edges))
    return edges


def _default_root(tree: NamedGraph):
    leaves = tree.leaf_vertices()
    return leaves[-1] if leaves else tree.vertices()[0]


def edge_color(g: NamedGraph, num_colors: int | None = None) -> list:
    """Proper edge coloring, returned as groups of edges per color.

    The Trotterization grouping primitive (reference re-exports
    SimpleGraphAlgorithms.edge_color; used in every example and in
    `truncate.jl:19-20`).  Bipartite graphs get an exact Δ-coloring via
    König/matching; general graphs get Vizing Δ+1 via Misra–Gries.
    """
    delta = g.max_degree()
    if g.ne() == 0:
        return []
    if nx.is_bipartite(g.nx()):
        groups = _bipartite_edge_color(g)
    else:
        budget = max(delta + 1, num_colors or 0)
        groups = _kempe_edge_color(g, budget)
    if num_colors is not None and len(groups) > num_colors:
        raise ValueError(
            f"edge coloring needs {len(groups)} colors, {num_colors} requested"
        )
    _assert_proper(g, groups)
    return groups


def _assert_proper(g: NamedGraph, groups):
    total = 0
    for group in groups:
        seen = set()
        for e in group:
            assert e.src not in seen and e.dst not in seen, "improper edge coloring"
            seen.update((e.src, e.dst))
        total += len(group)
    assert total == g.ne(), "edge coloring misses edges"


def _bipartite_edge_color(g: NamedGraph) -> list:
    """Exact Δ-edge-coloring of a bipartite graph (König): pad to a
    Δ-regular bipartite multigraph and peel perfect matchings."""
    delta = g.max_degree()
    # per-component 2-coloring: nx.bipartite.sets raises on disconnected
    # graphs (e.g. a shard-padded lattice with inert isolated vertices)
    left_set: set = set()
    right_set: set = set()
    nxg = g.nx()
    for comp in nx.connected_components(nxg):
        if len(comp) == 1:
            continue  # isolated vertex touches no edge
        lc, rc = nx.bipartite.sets(nxg.subgraph(comp))
        left_set |= lc
        right_set |= rc
    left, right = sorted(left_set, key=str), sorted(right_set, key=str)
    n = max(len(left), len(right))
    # build bipartite multigraph adjacency with dummy vertices/edges
    lnodes = [("L", v) for v in left] + [("Ld", i) for i in range(n - len(left))]
    rnodes = [("R", v) for v in right] + [("Rd", i) for i in range(n - len(right))]
    mg = nx.MultiGraph()
    mg.add_nodes_from(lnodes, bipartite=0)
    mg.add_nodes_from(rnodes, bipartite=1)
    for u, v in g.nx().edges:
        lu = ("L", u) if u in left_set else ("L", v)
        rv = ("R", v) if v in right_set else ("R", u)
        mg.add_edge(lu, rv, real=(u, v))
    # pad to Δ-regular: greedily connect deficient pairs
    ldeg = {u: mg.degree(u) for u in lnodes}
    rdeg = {u: mg.degree(u) for u in rnodes}
    li, ri = 0, 0
    lqueue = [u for u in lnodes for _ in range(delta - ldeg[u])]
    rqueue = [u for u in rnodes for _ in range(delta - rdeg[u])]
    for lu, rv in zip(lqueue, rqueue):
        mg.add_edge(lu, rv, real=None)
    groups = []
    for _ in range(delta):
        # perfect matching on the simple graph view with multiplicities
        sg = nx.Graph()
        sg.add_nodes_from(lnodes, bipartite=0)
        sg.add_nodes_from(rnodes, bipartite=1)
        keymap = {}
        for u, v, k in mg.edges(keys=True):
            lu, rv = (u, v) if u[0].startswith("L") else (v, u)
            if not sg.has_edge(lu, rv):
                sg.add_edge(lu, rv)
                keymap[(lu, rv)] = k
        matching = nx.bipartite.hopcroft_karp_matching(sg, top_nodes=lnodes)
        group = []
        for lu in lnodes:
            rv = matching[lu]
            k = keymap[(lu, rv)]
            real = mg.edges[lu, rv, k]["real"]
            if real is not None:
                group.append(NamedEdge(*real))
            mg.remove_edge(lu, rv, key=k)
        if group:
            groups.append(group)
    return groups


def _kempe_edge_color(g: NamedGraph, ncolors: int) -> list:
    """Greedy edge coloring with Kempe-chain repair, randomized restarts,
    escalating the budget if needed (always terminates; budget 2Δ-1 is
    trivially sufficient for greedy)."""
    import random as _random

    def attempt(ncol, seed):
        rng = _random.Random(seed)
        edges_list = [tuple(e) for e in g.edges()]
        rng.shuffle(edges_list)
        color = {}  # frozenset -> color

        def colors_at(u):
            return {
                color[frozenset((u, w))]
                for w in g.nx().neighbors(u)
                if frozenset((u, w)) in color
            }

        for (u, v) in edges_list:
            free_u = [c for c in range(ncol) if c not in colors_at(u)]
            free_v = set(c for c in range(ncol) if c not in colors_at(v))
            both = [c for c in free_u if c in free_v]
            if both:
                color[frozenset((u, v))] = both[0]
                continue
            # Kempe-chain repair: invert an (a,b)-chain from v for some
            # a free at u, b free at v; succeeds unless the chain ends at u.
            done = False
            for a in free_u:
                for b in free_v:
                    chain = []
                    node, want = v, a
                    ok = True
                    while True:
                        nxt = None
                        for w in g.nx().neighbors(node):
                            if color.get(frozenset((node, w))) == want:
                                nxt = w
                                break
                        if nxt is None:
                            break
                        chain.append(frozenset((node, nxt)))
                        node = nxt
                        want = b if want == a else a
                        if node == u:
                            ok = False
                            break
                    if ok:
                        for ek in chain:
                            color[ek] = b if color[ek] == a else a
                        color[frozenset((u, v))] = a
                        done = True
                        break
                if done:
                    break
            if not done:
                return None
        return color

    delta = g.max_degree()
    budget = ncolors
    while True:
        for seed in range(40):
            color = attempt(budget, seed)
            if color is not None:
                groups = [[] for _ in range(budget)]
                for u, v in g.nx().edges:
                    groups[color[frozenset((u, v))]].append(NamedEdge(u, v))
                return [grp for grp in groups if grp]
        budget += 1


# ---------------------------------------------------------------------------
# loop enumeration (for loop-corrected BP)
# ---------------------------------------------------------------------------


def edgeinduced_subgraphs_no_leaves(
    g: NamedGraph, max_edges: int, allowed_leaves=()
) -> list:
    """All edge-induced subgraphs with ≤ max_edges edges and min degree ≥ 2
    (the 'generalized loops' of the BP loop series; NamedGraphs
    `edgeinduced_subgraphs_no_leaves`, used in `loopcorrection.jl:11-12`).

    ``allowed_leaves`` optionally names vertices where degree-1 IS allowed
    — the numerator series of loop-corrected expectation values anchors
    excitation components (paths, tadpoles) at the observable vertices;
    the default (empty) is the strict leaf-free enumeration.

    Returns a list of NamedGraph (possibly disconnected unions of
    vertex-disjoint components).

    Dispatches to the native C++ bitset enumerator (`csrc/subgraphs.cpp`,
    built with g++ at first use by the package's ``native`` loader) when available — the
    pure-Python enumeration below is O(minutes) at max_edges=10 on a 5×5
    grid, the native one O(ms) — and runs the Python one without a
    toolchain.  Both paths produce the identical sorted list
    (`tests/test_torch_loopcorrection.py` cross-checks them).
    """
    if max_edges is None or max_edges <= 0:
        return []
    edges = g.edges()
    allowed = frozenset(allowed_leaves)

    native_sets = _leaffree_edge_sets_native(g, edges, max_edges, allowed)
    if native_sets is not None:
        out = []
        for es in sorted(native_sets, key=lambda s: (len(s), sorted(s))):
            sub = NamedGraph()
            for i in sorted(es):
                e = edges[i]
                sub.add_vertex_inplace(e.src)
                sub.add_vertex_inplace(e.dst)
                sub.add_edge_inplace(e)
            out.append(sub)
        return out
    return _edgeinduced_subgraphs_no_leaves_py(g, max_edges, allowed)


def _leaffree_edge_sets_native(g: NamedGraph, edges: list, max_edges: int,
                               allowed=frozenset()):
    """Edge-index sets from the native enumerator, or None (no toolchain /
    graph exceeds the 256-edge/vertex bitset capacity)."""
    from ..native import leaffree_subsets_native

    verts = {v: i for i, v in enumerate(g.vertices())}
    pairs = [(verts[e.src], verts[e.dst]) for e in edges]
    leaf_ok = None
    if allowed:
        leaf_ok = [False] * len(verts)
        for v in allowed:
            if v in verts:
                leaf_ok[verts[v]] = True
    sets = leaffree_subsets_native(pairs, len(verts), max_edges, leaf_ok)
    return None if sets is None else [frozenset(s) for s in sets]


def _edgeinduced_subgraphs_no_leaves_py(
    g: NamedGraph, max_edges: int, allowed=frozenset()
) -> list:
    """Pure-Python fallback (and parity oracle) for
    `edgeinduced_subgraphs_no_leaves`."""
    edges = g.edges()
    eidx = {frozenset((e.src, e.dst)): k for k, e in enumerate(edges)}

    # enumerate connected edge subsets ≤ max_edges, keep the leaf-free ones
    connected = []
    seen = set()

    def grow(current: frozenset, frontier_banned: frozenset):
        if current in seen:
            return
        seen.add(current)
        sub = [edges[i] for i in sorted(current)]
        degs = {}
        for e in sub:
            degs[e.src] = degs.get(e.src, 0) + 1
            degs[e.dst] = degs.get(e.dst, 0) + 1
        n_leaves = sum(1 for d in degs.values() if d == 1)
        leaves_ok = all(
            d >= 2 or v in allowed for v, d in degs.items()
        )
        if leaves_ok and (len(current) >= 3 or n_leaves > 0):
            connected.append(frozenset(current))
        if len(current) >= max_edges:
            return
        # expand by adjacent edges not banned
        adjacent = set()
        verts = set(degs)
        for v in verts:
            for w in g.nx().neighbors(v):
                k = eidx[frozenset((v, w))]
                if k not in current and k not in frontier_banned:
                    adjacent.add(k)
        banned = set(frontier_banned)
        for k in sorted(adjacent):
            grow(current | {k}, frozenset(banned))
            banned.add(k)

    for k in range(len(edges)):
        grow(frozenset({k}), frozenset(range(k)))

    connected = sorted(set(connected), key=lambda s: (len(s), sorted(s)))
    # vertex sets for disjoint unions
    def vset(es):
        out = set()
        for i in es:
            out.update((edges[i].src, edges[i].dst))
        return frozenset(out)

    vsets = {c: vset(c) for c in connected}
    results = []

    def unions(start, acc_edges, acc_verts):
        if acc_edges:
            results.append(frozenset(acc_edges))
        for i in range(start, len(connected)):
            c = connected[i]
            if len(acc_edges) + len(c) > max_edges:
                continue
            if vsets[c] & acc_verts:
                continue
            unions(i + 1, acc_edges | c, acc_verts | vsets[c])

    unions(0, frozenset(), frozenset())
    out = []
    for es in sorted(set(results), key=lambda s: (len(s), sorted(s))):
        sub = NamedGraph()
        for i in sorted(es):
            e = edges[i]
            sub.add_vertex_inplace(e.src)
            sub.add_vertex_inplace(e.dst)
            sub.add_edge_inplace(e)
        out.append(sub)
    return out


def unique_simplecycles_limited_length(g: NamedGraph, max_length: int) -> list:
    """Simple cycles up to the given length, each as a list of vertices."""
    return [c for c in nx.simple_cycles(g.nx(), length_bound=max_length)]


def cycle_to_path(cycle_vertices: list) -> list:
    """Vertex cycle -> closed list of directed edges."""
    n = len(cycle_vertices)
    return [
        NamedEdge(cycle_vertices[i], cycle_vertices[(i + 1) % n]) for i in range(n)
    ]
