"""Free-function parity layer with the reference's export list.

The counterpart of ``tensornetworkquantumsimulator_tpu.api``, delegate for
delegate.

The reference exports ~75 free functions (multiple dispatch,
`src/TensorNetworkQuantumSimulator.jl:36-113`); this package implements
the same operations as methods on `NamedGraph` / `AbstractTensorNetwork`
/ the caches.  These thin delegates give a reference user the exact
spelling they already know — `vertices(tn)`, `update(cache)`,
`partitionfunction(cache)` — without duplicating any logic.  Mutating
`foo!` spellings map to the non-mutating `foo` here (the engines are
functional); `_inplace` methods remain available on the objects.
"""

from __future__ import annotations

from .measure import expect
from .utils.graphs import NamedEdge, NamedGraph  # noqa: F401  (re-export)


def vertices(x):
    """Vertex list of a graph / network / cache (`imports.jl` re-export)."""
    return x.vertices()


def edges(x):
    return x.edges()


def neighbors(x, v):
    return x.neighbors(v)


def degree(g, v):
    return g.degree(v)


def nv(x):
    return x.nv()


def add_edge(g, e, v=None):
    return g.add_edge(e, v)


def rem_vertex(x, v):
    """Non-mutating `rem_vertex` (the reference also exports the `!`
    variant; use ``x.rem_vertex_inplace(v)`` for that)."""
    out = x.copy()
    out.rem_vertex_inplace(v)
    return out


def is_tree(x):
    return x.is_tree()


def center(g):
    return g.center()


def graph(x):
    return x.graph()


def ket_network(form):
    """The ket layer of a Bilinear/Quadratic form (`bilinearform.jl`)."""
    return form.ket()


def maxvirtualdim(tn):
    return tn.maxvirtualdim()


def virtualind(tn, e):
    return tn.virtualind(e)


def virtualinds(tn, e=None):
    return tn.virtualinds(e) if e is not None else tn.virtualinds()


def vertextype(x):
    """Type of the vertex names (`vertextype` re-export)."""
    vs = x.vertices()
    return type(next(iter(vs))) if len(vs) else object


def scalartype(x):
    return x.scalartype()


def datatype(x):
    """Alias of `scalartype` (the reference exports both)."""
    return x.scalartype()


def map_tensors(f, tn):
    return tn.map_tensors(f)


def map_virtualinds(f, tn):
    return tn.map_virtualinds(f)


def network(cache):
    return cache.network()


def message(cache, e):
    return cache.message(e)


def messages(cache):
    return cache.messages()


def update(cache, **kwargs):
    return cache.update(**kwargs)


def partitionfunction(cache):
    return cache.partitionfunction()


def rescale(cache, vertices=None):
    return cache.rescale(vertices)


def expect_boundarymps(psi, observables, **kwargs):
    """`expect(..., alg="boundarymps")` spelled as in the reference."""
    return expect(psi, observables, alg="boundarymps", **kwargs)


def expect_loopcorrect(psi, observables, max_configuration_size=4, **kwargs):
    """`expect(..., alg="loopcorrections")` spelled as in the reference."""
    return expect(
        psi,
        observables,
        alg="loopcorrections",
        max_configuration_size=max_configuration_size,
        **kwargs,
    )
