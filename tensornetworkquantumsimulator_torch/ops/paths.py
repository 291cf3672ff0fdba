"""Contraction-order search (host code, memoised on structure).

The counterpart of ``tensornetworkquantumsimulator_tpu.ops.paths`` (the
reference's `contraction_sequences.jl`: `optimaltree` / EinExprs Greedy),
with no ``opt_einsum``.  ``alg="optimal"`` runs the exact native DP
(``csrc/pathopt.cpp``, built with g++ at first use by :mod:`..native`) up
to 64 tensors; where that library is missing or declines (its enumeration
budget overflows on dense lists), an exact cost-capped dynamic programme
over connected subsets runs here for lists of at most 24 tensors, and a
greedy search beyond.  ``alg="einexpr"``/``"greedy"`` is the greedy
search.  A worse path never changes a value, only time and memory.

Paths are memoised on the structural signature of the tensor list (index
pattern and shapes, never the index ids), so the per-gate and per-message
searches of the BP hot loop amortise to dict lookups.  The returned
sequence is SSA-style: a list of ``(i, j)`` pairs indexing into a pool that
starts as the input list and grows by one result per step.
"""

from __future__ import annotations

import heapq
import math
from collections import Counter, defaultdict
from typing import Sequence

_PATH_CACHE: dict = {}
_MAX_CACHE = 200_000

# the exact Python DP's reach; the JAX package sends the same lists to
# opt_einsum's cost-capped "dp" (ops/paths.py:97-105 there)
DP_MAX_TENSORS = 24


def _size(legs, dims) -> int:
    return math.prod(dims[c] for c in legs)


def _tree_to_ssa(tree, n: int) -> list:
    """SSA pairs of a binary contraction tree over leaves 0..n-1."""
    ssa = []
    nxt = [n]

    def walk(t):
        if isinstance(t, int):
            return t
        a, b = walk(t[0]), walk(t[1])
        ssa.append((a, b))
        nxt[0] += 1
        return nxt[0] - 1

    walk(tree)
    return ssa


def _components(inputs, output) -> list:
    """Tensor positions grouped by connection through summed indices."""
    by_ind = defaultdict(list)
    for k, legs in enumerate(inputs):
        for c in legs - output:
            by_ind[c].append(k)
    seen = set()
    comps = []
    for start in range(len(inputs)):
        if start in seen:
            continue
        comp, stack = [], [start]
        seen.add(start)
        while stack:
            k = stack.pop()
            comp.append(k)
            for c in inputs[k] - output:
                for j in by_ind[c]:
                    if j not in seen:
                        seen.add(j)
                        stack.append(j)
        comps.append(sorted(comp))
    return comps


def _dp_component(comp, inputs, output, dims):
    """Cheapest contraction tree of one connected component with no outer
    products (Pfeifer, Haegeman, Verstraete, PRE 90, 033315): subsets are
    built by size from pairs of disjoint subsets that share a summed index,
    keeping the cheapest way to reach each subset; a cost cap, raised by
    the smallest dimension until the whole component is reached, prunes
    the search.  The cost is Σ over steps of the product of the dimensions
    of both operands' legs, the native DP's measure.  Returns
    (legs, cost, tree)."""
    n = len(comp)
    if n == 1:
        return inputs[comp[0]], 0, comp[0]
    full = 0
    for k in comp:
        full |= 1 << k
    inds = frozenset().union(*(inputs[k] for k in comp))
    cap = max(_size(inds & output, dims), 1)
    step = max(min((dims[c] for c in inds), default=2), 2)
    best = [None, {1 << k: (inputs[k], 0, k) for k in comp}]
    best += [{} for _ in range(n - 1)]

    def legs_of(s, union, shared):
        rest = full & ~s
        outside = set()
        k = 0
        while rest:
            if rest & 1:
                outside |= inputs[k]
            rest >>= 1
            k += 1
        return union - (shared - outside)

    while not best[n]:
        for size in range(2, n + 1):
            level = best[size]
            for m in range(1, size // 2 + 1):
                for s1, (l1, c1, t1) in best[m].items():
                    for s2, (l2, c2, t2) in best[size - m].items():
                        if s1 & s2 or (m == size - m and s1 >= s2):
                            continue
                        shared = (l1 & l2) - output
                        if not shared:
                            continue
                        union = l1 | l2
                        cost = c1 + c2 + _size(union, dims)
                        if cost > cap:
                            continue
                        s = s1 | s2
                        old = level.get(s)
                        if old is None or cost < old[1]:
                            level[s] = (legs_of(s, union, shared), cost,
                                        (t1, t2))
        cap *= step
    return next(iter(best[n].values()))


def _dp_path(inputs, output, dims) -> list:
    """Exact DP per connected component, the components then joined by
    outer products, smallest result first."""
    parts = [_dp_component(c, inputs, output, dims)
             for c in _components(inputs, output)]
    parts.sort(key=lambda p: _size(p[0], dims))
    tree = parts[0][2]
    for p in parts[1:]:
        tree = (tree, p[2])
    return _tree_to_ssa(tree, len(inputs))


def _greedy_path(inputs, output, dims) -> list:
    """Greedy pairwise order: repeatedly contract the pair of tensors that
    share a summed index whose result is smallest relative to its operands
    (size(result) - size(a) - size(b), ties to the earliest tensors), then
    join what is left by outer products, smallest first."""
    n = len(inputs)
    legs = {k: frozenset(s) for k, s in enumerate(inputs)}
    holders = defaultdict(set)  # summed index -> live tensors holding it
    for k, s in legs.items():
        for c in s - output:
            holders[c].add(k)
    ssa = []
    nxt = n
    heap = []

    def result_legs(a, b):
        shared = (legs[a] & legs[b]) - output
        gone = {c for c in shared if holders[c] <= {a, b}}
        return (legs[a] | legs[b]) - gone

    def push(a, b):
        r = result_legs(a, b)
        cost = _size(r, dims) - _size(legs[a], dims) - _size(legs[b], dims)
        heapq.heappush(heap, (cost, min(a, b), max(a, b)))

    for c in sorted(holders, key=repr):
        ks = sorted(holders[c])
        for i, a in enumerate(ks):
            for b in ks[i + 1:]:
                push(a, b)
    while heap:
        _, a, b = heapq.heappop(heap)
        if a not in legs or b not in legs:
            continue
        r = result_legs(a, b)
        for k in (a, b):
            for c in legs[k] - output:
                holders[c].discard(k)
        del legs[a], legs[b]
        ssa.append((a, b))
        legs[nxt] = r
        partners = set()
        for c in r - output:
            holders[c].add(nxt)
            partners |= holders[c]
        partners.discard(nxt)
        for p in sorted(partners):
            push(p, nxt)
        nxt += 1
    rest = sorted(legs, key=lambda k: (_size(legs[k], dims), k))
    heap = [(_size(legs[k], dims), k) for k in rest]
    heapq.heapify(heap)
    if heap:
        _, a = heapq.heappop(heap)
        while heap:
            _, b = heapq.heappop(heap)
            ssa.append((min(a, b), max(a, b)))
            legs[nxt] = legs[a] | legs[b]
            a = nxt
            nxt += 1
            a_size = _size(legs[a], dims)
            _, a = heapq.heappushpop(heap, (a_size, a))
    return ssa


def contraction_sequence(tensors: Sequence, alg: str = "optimal", **kwargs):
    """Find a pairwise contraction order for ``tensors``.

    alg="optimal"  -> exact: the native DP, else the Python DP up to
                      :data:`DP_MAX_TENSORS` tensors, greedy beyond
                      (reference `contraction_sequences.jl:15-26`).
    alg="einexpr"/"greedy" -> greedy (reference `:28-34`).
    """
    n = len(tensors)
    if n <= 1:
        return []
    if n == 2:
        return [(0, 1)]

    # map indices to integer symbols (first-appearance order, so the cache
    # key is invariant to concrete index ids — only the structure matters)
    symbols: dict = {}
    inputs = []
    for t in tensors:
        sub = []
        for i in t.inds:
            k = (i.id, i.plev)
            if k not in symbols:
                symbols[k] = len(symbols)
            sub.append(symbols[k])
        inputs.append(tuple(sub))
    shapes = tuple(tuple(t.shape) for t in tensors)

    key = (tuple(inputs), shapes, alg)
    hit = _PATH_CACHE.get(key)
    if hit is not None:
        return hit

    dims = {}
    for sub, shape in zip(inputs, shapes):
        for c, d in zip(sub, shape):
            dims[c] = d
    counts = Counter(c for sub in inputs for c in sub)
    output = frozenset(c for c, k in counts.items() if k == 1)
    sets = [frozenset(sub) for sub in inputs]

    seq = None
    if alg == "optimal":
        if n <= 64:
            from ..native import optimal_path_native

            seq = optimal_path_native(inputs, dims)
        if seq is None and n <= DP_MAX_TENSORS:
            seq = _dp_path(sets, output, dims)
    elif alg not in ("einexpr", "greedy"):
        raise ValueError(f"unknown contraction-sequence alg {alg!r}")
    if seq is None:
        seq = _greedy_path(sets, output, dims)
    if len(_PATH_CACHE) < _MAX_CACHE:
        _PATH_CACHE[key] = seq
    return seq
