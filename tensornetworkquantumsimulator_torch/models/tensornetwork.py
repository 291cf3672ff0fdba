"""Graph-of-tensors data model.

The counterpart of ``tensornetworkquantumsimulator_tpu.models.
tensornetwork`` (the reference's L1 layer: `src/TensorNetworks/
abstracttensornetwork.jl`, `tensornetwork.jl`, `tensornetworkstate.jl`,
`tensornetworkstate_constructors.jl`).

A :class:`TensorNetwork` is a dict of named-index :class:`~..ops.Tensor`
objects plus a :class:`~..utils.graphs.NamedGraph`; a
:class:`TensorNetworkState` adds explicit per-vertex site indices and the
`norm_factors` builder that every contraction engine shares.  A network
lives on one device.  The constructors take ``device=None``, the package
default (CUDA, raising when none is visible), and default to float64, as
the JAX package does with x64 enabled.

:func:`state_to_numpy` / :func:`state_from_numpy` carry a state across as
plain data (graph, arrays, indices as ``(id, dim, tags, plev)``), e.g.
from the JAX package's generic engine.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..devices import resolve_device
from ..ops.index import (
    Index,
    commoninds,
    index_from_plain,
    index_to_plain,
    reserve_ids,
    uniqueinds,
)
from ..ops.tensor import (
    Tensor,
    as_torch_dtype,
    delta,
    from_array,
    onehot,
    random_tensor,
)
from ..utils.graphs import NamedEdge, NamedGraph
from . import sites as _sites


def _promote_dtype(dtypes):
    out = None
    for d in dtypes:
        out = d if out is None else torch.promote_types(out, d)
    return out


def _is_dtype(x) -> bool:
    return isinstance(x, (torch.dtype, np.dtype, type))


class AbstractTensorNetwork:
    """Shared graph/tensor interface (`abstracttensornetwork.jl`)."""

    # subclasses provide: graph(), tensors() (dict v->Tensor), __getitem__

    def graph(self) -> NamedGraph:
        raise NotImplementedError

    def tensors(self) -> dict:
        raise NotImplementedError

    # -- graph forwarding ----------------------------------------------------
    def vertices(self):
        return self.graph().vertices()

    def edges(self):
        return self.graph().edges()

    def neighbors(self, v):
        return self.graph().neighbors(v)

    def is_tree(self):
        return self.graph().is_tree()

    def steiner_tree(self, vs):
        return self.graph().steiner_tree(vs)

    def nv(self):
        return self.graph().nv()

    def __getitem__(self, v) -> Tensor:
        return self.tensors()[v]

    # -- index queries ---------------------------------------------------------
    def virtualinds(self, e: NamedEdge):
        """Indices shared across an edge (`abstracttensornetwork.jl:25-26`)."""
        return commoninds(self[e.src].inds, self[e.dst].inds)

    def virtualind(self, e: NamedEdge):
        vinds = self.virtualinds(e)
        if len(vinds) != 1:
            raise ValueError(f"edge {e} has {len(vinds)} virtual indices")
        return vinds[0]

    def maxvirtualdim(self) -> int:
        dims = [i.dim for e in self.edges() for i in self.virtualinds(e)]
        return max(dims, default=1)

    def uniqueinds(self, v):
        """Dangling indices of the tensor at ``v`` (site indices)."""
        tv = list(self[v].inds)
        vns = self.neighbors(v)
        if not vns:
            return tv
        neighbor_inds = set()
        for vn in vns:
            neighbor_inds.update(self[vn].inds)
        return [i for i in tv if i not in neighbor_inds]

    # -- dtypes and device -------------------------------------------------------
    def scalartype(self) -> torch.dtype:
        return _promote_dtype(self[v].dtype for v in self.vertices())

    def device(self) -> torch.device:
        """The device the network's tensors live on."""
        return self[self.vertices()[0]].device

    # -- mutation ---------------------------------------------------------------
    def setindex_preserve(self, value: Tensor, v):
        """Replace a tensor without recomputing edges
        (`abstracttensornetwork.jl:41-44`)."""
        self.tensors()[v] = value
        return self

    def map_tensors_inplace(self, f: Callable):
        for v in self.vertices():
            self.setindex_preserve(f(self[v]), v)
        return self

    def map_tensors(self, f: Callable):
        return self.copy().map_tensors_inplace(f)

    def map_virtualinds_inplace(self, f: Callable):
        for e in self.edges():
            vinds = self.virtualinds(e)
            vinds_new = [f(i) for i in vinds]
            self.setindex_preserve(self[e.src].replaceinds(vinds, vinds_new), e.src)
            self.setindex_preserve(self[e.dst].replaceinds(vinds, vinds_new), e.dst)
        return self

    def map_virtualinds(self, f: Callable):
        return self.copy().map_virtualinds_inplace(f)

    def astype(self, dtype):
        """Adapt all tensors to a dtype (the reference's `Adapt` role)."""
        return self.map_tensors(lambda t: t.astype(dtype))

    def insert_virtualinds_inplace(self, bond_dimension: int = 1):
        """Pad graph edges missing a shared index with a trivial bond
        (`abstracttensornetwork.jl:76-87`)."""
        dtype = self.scalartype()
        for e in self.edges():
            if not commoninds(self[e.src].inds, self[e.dst].inds):
                l = Index(bond_dimension)
                p = onehot(l, 0, dtype=dtype, device=self.device())
                self.setindex_preserve(self[e.src] * p, e.src)
                self.setindex_preserve(self[e.dst] * p, e.dst)
        return self

    def combine_virtualinds_inplace(self):
        """Fuse multiple parallel indices on an edge into one
        (`abstracttensornetwork.jl:109-120`)."""
        from ..ops.tensor import combiner

        for e in self.edges():
            vinds = self.virtualinds(e)
            if len(vinds) > 1:
                c, _ = combiner(vinds, dtype=self.scalartype(),
                                device=self.device())
                self.setindex_preserve(self[e.src] * c, e.src)
                self.setindex_preserve(self[e.dst] * c, e.dst)
        return self

    def __add__(self, other):
        return add(self, other)


class TensorNetwork(AbstractTensorNetwork):
    """Concrete flat tensor network (`tensornetwork.jl`)."""

    def __init__(self, tensors, graph: NamedGraph | None = None):
        if isinstance(tensors, (list, tuple)):
            tensors = {i + 1: t for i, t in enumerate(tensors)}
        self._tensors = dict(tensors)
        if graph is None:
            graph = _infer_graph(self._tensors)
        self._graph = graph

    @classmethod
    def _make(cls, tensors: dict, graph: NamedGraph):
        obj = object.__new__(cls)
        obj._tensors = tensors
        obj._graph = graph
        return obj

    def graph(self) -> NamedGraph:
        return self._graph

    def tensors(self) -> dict:
        return self._tensors

    def copy(self) -> "TensorNetwork":
        return TensorNetwork._make(dict(self._tensors), self._graph.copy())

    def rem_vertex_inplace(self, v):
        self._graph.rem_vertex_inplace(v)
        del self._tensors[v]
        return self

    def add_tensor_inplace(self, tensor: Tensor, v):
        """Set a tensor and re-derive incident edges (`tensornetwork.jl:44-60`)."""
        if not self._graph.has_vertex(v):
            self._graph.add_vertex_inplace(v)
        else:
            self._graph.rem_edges_inplace(self._graph.incident_edges(v))
        self._tensors[v] = tensor
        for vp in self.vertices():
            if vp != v and commoninds(tensor.inds, self._tensors[vp].inds):
                self._graph.add_edge_inplace(NamedEdge(v, vp))
        return self

    def __setitem__(self, v, tensor: Tensor):
        if not self._graph.has_vertex(v):
            raise KeyError(f"vertex {v} not in tensor network")
        self.add_tensor_inplace(tensor, v)

    # -- BP interface -----------------------------------------------------------
    def default_message(self, e: NamedEdge) -> Tensor:
        return delta(self.virtualinds(e), dtype=self.scalartype(),
                     device=self.device())

    def bp_factors(self, vs) -> list:
        if not isinstance(vs, list):  # a bare vertex may itself be a tuple
            vs = [vs]
        return [self[v] for v in vs]

    def siteinds(self) -> dict:
        return {v: self.uniqueinds(v) for v in self.vertices()}


def _infer_graph(tensors: dict) -> NamedGraph:
    """Edges inferred from shared indices (`tensornetwork.jl:19-30`)."""
    g = NamedGraph(tensors.keys())
    vs = list(tensors.keys())
    for i, v in enumerate(vs):
        for vp in vs[i + 1 :]:
            if commoninds(tensors[v].inds, tensors[vp].inds):
                g.add_edge_inplace(NamedEdge(v, vp))
    return g


def random_tensornetwork(
    dtype, g: NamedGraph = None, bond_dimension: int = 1, generator=None,
    device=None,
) -> TensorNetwork:
    """Random flat network on a graph (`tensornetwork.jl:74-86`); draws
    from ``generator`` (None: the module generator, see :func:`seed`)."""
    if g is None:  # allow random_tensornetwork(g) with default dtype
        dtype, g = torch.float64, dtype
    if generator is None:
        generator = _GENERATOR
    link = {}
    for e in g.edges():
        l = Index(bond_dimension)
        link[(e.src, e.dst)] = l
        link[(e.dst, e.src)] = l
    tensors = {}
    for v in g.vertices():
        inds = [link[(v, vn)] for vn in g.neighbors(v)]
        tensors[v] = random_tensor(generator, inds, dtype=dtype, device=device)
    return TensorNetwork(tensors, g.copy())


class TensorNetworkState(AbstractTensorNetwork):
    """Wavefunction/operator state: network + explicit site indices
    (`tensornetworkstate.jl:4-7`)."""

    def __init__(self, tensornetwork: TensorNetwork, siteinds: dict | None = None):
        if not isinstance(tensornetwork, TensorNetwork):
            tensornetwork = TensorNetwork(tensornetwork)
        self._tn = tensornetwork
        if siteinds is None:
            siteinds = tensornetwork.siteinds()
        self._siteinds = {v: list(s) for v, s in siteinds.items()}

    def tensornetwork(self) -> TensorNetwork:
        return self._tn

    def graph(self) -> NamedGraph:
        return self._tn.graph()

    def tensors(self) -> dict:
        return self._tn.tensors()

    def siteinds(self, v=None):
        if v is None:
            return self._siteinds
        return self._siteinds[v]

    def copy(self) -> "TensorNetworkState":
        return TensorNetworkState(self._tn.copy(), dict(self._siteinds))

    def __setitem__(self, v, tensor: Tensor):
        """Set a tensor, re-deriving edges and refreshing site indices of the
        vertex and its neighbors (`tensornetworkstate.jl:33-40`)."""
        self._tn[v] = tensor
        for vn in self.neighbors(v) + [v]:
            self._siteinds[vn] = self.uniqueinds(vn)

    # -- the universal ⟨ψ|O|ψ⟩ factor builder -----------------------------------
    def norm_factors(self, verts, op_strings: Callable = None) -> list:
        """Per-vertex factors of the norm/observable network
        (`tensornetworkstate.jl:42-59`).  Special strings: "I" (identity,
        site legs contracted), "ρ" (leave site legs open for RDMs).
        """
        if op_strings is None:
            op_strings = lambda v: "I"  # noqa: E731
        if not isinstance(verts, list):  # a bare vertex may itself be a tuple
            verts = [verts]
        factors = []
        for v in verts:
            sinds = self.siteinds(v)
            tnv = self[v]
            tnv_dag = tnv.dag().prime()
            ops = op_strings(v)
            if ops == "ρ" or not sinds:
                factors.extend([tnv, tnv_dag])
            elif ops == "I":
                tnv_dag = tnv_dag.replaceinds([s.prime() for s in sinds], sinds)
                factors.extend([tnv, tnv_dag])
            else:
                if len(sinds) != 1:
                    raise ValueError("operator strings need exactly one site index")
                op = _sites.op_tensor(ops, sinds[0], dtype=self.scalartype(),
                                      device=tnv.device)
                factors.extend([tnv, tnv_dag, op])
        return factors

    def bp_factors(self, vs) -> list:
        return self.norm_factors(vs)

    def default_message(self, e: NamedEdge) -> Tensor:
        linds = self.virtualinds(e)
        return delta(linds + [l.prime() for l in linds],
                     dtype=self.scalartype(), device=self.device())

    def vertices_of_tensor(self, t: Tensor) -> list:
        """Which vertices a gate tensor acts on, by site-index matching
        (`tensornetworkstate.jl:173-176`)."""
        t_inds = set(t.inds)
        return [
            v for v in self.vertices() if t_inds.intersection(self.siteinds(v))
        ]


# ---------------------------------------------------------------------------
# constructors (`tensornetworkstate.jl:82-171`, `tensornetworkstate_constructors.jl`)
# ---------------------------------------------------------------------------

# the random constructors' generator (a CPU generator: the draws are copied
# to the device, so one seed gives the same network on every device)
_GENERATOR = torch.Generator().manual_seed(0)


def seed(n: int):
    """Seed the library RNG used by the random constructors."""
    _GENERATOR.manual_seed(int(n))


def _siteinds_of(siteinds, g):
    if siteinds is None:
        return _sites.default_siteinds(g)
    if isinstance(siteinds, str):
        return _sites.siteinds(siteinds, g)
    return siteinds


def random_tensornetworkstate(
    dtype, g: NamedGraph = None, siteinds=None, bond_dimension: int = 1,
    generator=None, device=None,
) -> TensorNetworkState:
    if g is None:
        dtype, g = torch.float64, dtype
    siteinds = _siteinds_of(siteinds, g)
    if generator is None:
        generator = _GENERATOR
    link = {}
    for e in g.edges():
        l = Index(bond_dimension)
        link[(e.src, e.dst)] = l
        link[(e.dst, e.src)] = l
    tensors = {}
    for v in g.vertices():
        inds = list(siteinds[v]) + [link[(v, vn)] for vn in g.neighbors(v)]
        tensors[v] = random_tensor(generator, inds, dtype=dtype, device=device)
    return TensorNetworkState(TensorNetwork(tensors, g.copy()), siteinds)


def tensornetworkstate(
    dtype, f: Callable = None, g: NamedGraph = None, siteinds=None,
    device=None,
) -> TensorNetworkState:
    """Product state from per-vertex state strings or vectors
    (`tensornetworkstate.jl:124-144`), on ``device`` (None: the package
    default)."""
    if not _is_dtype(dtype):
        # tensornetworkstate(f, g[, siteinds]) with default dtype
        dtype, f, g, siteinds = torch.float64, dtype, f, g
    dtype = as_torch_dtype(dtype)
    device = resolve_device(device)
    siteinds = _siteinds_of(siteinds, g)
    tensors = {}
    for v in g.vertices():
        local = f(v)
        sind = siteinds[v][0]
        if isinstance(local, str):
            vec = _sites.state_vector(local, sind.dim)
        else:
            vec = np.asarray(local)
        if np.iscomplexobj(vec) and not dtype.is_complex:
            raise ValueError(f"state {local!r} needs a complex dtype")
        tensors[v] = from_array(vec, (sind,), dtype=dtype, device=device)
    for e in g.edges():
        l = Index(1)
        p = onehot(l, 0, dtype=dtype, device=device)
        tensors[e.src] = tensors[e.src] * p
        tensors[e.dst] = tensors[e.dst] * p
    return TensorNetworkState(TensorNetwork(tensors, g.copy()), siteinds)


def zerostate(dtype, g: NamedGraph = None, siteinds=None,
              device=None) -> TensorNetworkState:
    """All-up product state (`tensornetworkstate_constructors.jl:8-12`)."""
    if isinstance(dtype, NamedGraph):
        dtype, g, siteinds = torch.float64, dtype, g
    return tensornetworkstate(dtype, lambda v: "↑", g, siteinds, device=device)


def paulitensornetworkstate(
    dtype, f: Callable = None, g: NamedGraph = None, siteinds=None,
    device=None,
) -> TensorNetworkState:
    """Heisenberg-picture operator state over Pauli sites
    (`tensornetworkstate_constructors.jl:19-24`)."""
    if not _is_dtype(dtype):
        dtype, f, g, siteinds = torch.float64, dtype, f, g
    if siteinds is None:
        siteinds = _sites.siteinds("Pauli", g)
    h = lambda v: _sites.PAULI_BASIS_STATES[f(v)]  # noqa: E731
    return tensornetworkstate(dtype, h, g, siteinds, device=device)


def identitytensornetworkstate(dtype, g=None, siteinds=None,
                               device=None) -> TensorNetworkState:
    """Identity operator in the Pauli basis
    (`tensornetworkstate_constructors.jl:31-35`)."""
    if isinstance(dtype, NamedGraph):
        dtype, g, siteinds = torch.float64, dtype, g
    return paulitensornetworkstate(dtype, lambda v: "I", g, siteinds,
                                   device=device)


def density_matrix_tensornetworkstate(
    dtype, f: Callable = None, g: NamedGraph = None, siteinds=None,
    device=None,
) -> TensorNetworkState:
    """Product density matrix as a Pauli-coefficient network over
    "PauliRho" sites (no reference counterpart).

    ``f(v)`` may return a state string ("0", "+", "y-", "mixed", …), a
    pure-state 2-vector, a 2×2 density matrix, or a 4-long Pauli
    coefficient vector.  The site tensor holds c_P = Tr[ρ_v P] in basis
    order [I, X, Y, Z], so ρ = ⊗_v (1/2) Σ_P c_P P; gates and channels
    then apply as Schrödinger transfer matrices (`to_tensor`), the trace is
    the contraction against per-site [1,0,0,0], and Tr[ρ P_string] against
    the corresponding basis vectors (`measure.pauli_expectation`)."""
    if not _is_dtype(dtype):
        dtype, f, g, siteinds = torch.float64, dtype, f, g
    if f is None:
        f = lambda v: "0"  # noqa: E731
    if siteinds is None:
        siteinds = _sites.siteinds("PauliRho", g)
    h = lambda v: _sites.pauli_coefficients(f(v))  # noqa: E731
    return tensornetworkstate(dtype, h, g, siteinds, device=device)


# ---------------------------------------------------------------------------
# direct-sum addition (`abstracttensornetwork.jl:128-170`)
# ---------------------------------------------------------------------------


def add(tn1: AbstractTensorNetwork, tn2: AbstractTensorNetwork):
    if tn1.graph() != tn2.graph():
        raise ValueError("direct-sum add requires identical graphs")
    is_state = isinstance(tn1, TensorNetworkState)
    if is_state != isinstance(tn2, TensorNetworkState):
        raise ValueError("cannot add a TensorNetwork and a TensorNetworkState")
    device = tn1.device()
    if tn2.device() != device:
        raise ValueError(f"networks on different devices: {device} and "
                         f"{tn2.device()}")

    es = tn1.edges()
    new_edge_index = {}
    for e in es:
        d1 = tn1.virtualind(e).dim
        d2 = tn2.virtualind(e).dim
        new_edge_index[frozenset((e.src, e.dst))] = Index(d1 + d2)

    out_tensors = {}
    dtype = torch.promote_types(tn1.scalartype(), tn2.scalartype())
    for v in tn1.vertices():
        es_v = [e for e in es if e.src == v or e.dst == v]
        l1 = [tn1.virtualind(e) for e in es_v]
        l2 = [tn2.virtualind(e) for e in es_v]
        l12 = [new_edge_index[frozenset((e.src, e.dst))] for e in es_v]
        t1, t2 = tn1[v], tn2[v]
        # shared (site) indices must match
        shared1 = uniqueinds(t1.inds, l1)
        shared2 = uniqueinds(t2.inds, l2)
        if set(shared1) == set(shared2):
            shared2 = shared1
        elif [i.dim for i in shared1] != [i.dim for i in shared2]:
            raise ValueError("direct-sum add: dangling index mismatch")
        new_inds = tuple(shared1) + tuple(l12)
        shape = tuple(i.dim for i in new_inds)
        data = torch.zeros(shape, dtype=dtype, device=device)
        a1 = t1.array(tuple(shared1) + tuple(l1)).to(dtype)
        a2 = t2.replaceinds(shared2, shared1).array(
            tuple(shared1) + tuple(l2)).to(dtype)
        sl1 = tuple([slice(None)] * len(shared1) + [slice(0, i.dim) for i in l1])
        sl2 = tuple(
            [slice(None)] * len(shared2)
            + [slice(i1.dim, i1.dim + i2.dim) for i1, i2 in zip(l1, l2)]
        )
        data[sl1] = a1
        data[sl2] = a2
        out_tensors[v] = Tensor(data, new_inds)
    tn12 = TensorNetwork(out_tensors, tn1.graph().copy())
    if is_state:
        if {v: [i.dim for i in s] for v, s in tn1.siteinds().items()} != {
            v: [i.dim for i in s] for v, s in tn2.siteinds().items()
        }:
            raise ValueError("direct-sum add: site index mismatch")
        return TensorNetworkState(tn12, tn1.siteinds())
    return tn12


# ---------------------------------------------------------------------------
# carry-across as plain data
# ---------------------------------------------------------------------------


def state_to_numpy(tns: AbstractTensorNetwork) -> dict:
    """A network as plain data: ``vertices``, ``edges`` (pairs), per vertex
    ``tensors[v] = (array, [(id, dim, tags, plev), ...])`` and, for a
    state, ``siteinds[v]`` in the same index form.  Host copies."""
    out = {
        "vertices": list(tns.vertices()),
        "edges": [(e.src, e.dst) for e in tns.edges()],
        "tensors": {v: (tns[v].numpy(), [index_to_plain(i) for i in tns[v].inds])
                    for v in tns.vertices()},
    }
    if isinstance(tns, TensorNetworkState):
        out["siteinds"] = {v: [index_to_plain(i) for i in s]
                           for v, s in tns.siteinds().items()}
    return out


def state_from_numpy(data: dict, device=None) -> AbstractTensorNetwork:
    """The inverse of :func:`state_to_numpy`, on ``device`` (None: the
    package default): a :class:`TensorNetworkState` when ``data`` has
    ``siteinds``, else a :class:`TensorNetwork`.  Index ids are kept, and
    the package's id counter moves past the largest, so indices minted
    later never collide with them."""
    device = resolve_device(device)
    g = NamedGraph(data["vertices"])
    for u, v in data["edges"]:
        g.add_edge_inplace(NamedEdge(u, v))
    ids = [p[0] for _, inds in data["tensors"].values() for p in inds]
    ids += [p[0] for s in data.get("siteinds", {}).values() for p in s]
    reserve_ids(max(ids, default=0))
    tensors = {v: from_array(np.asarray(arr), [index_from_plain(p) for p in inds],
                             device=device)
               for v, (arr, inds) in data["tensors"].items()}
    tn = TensorNetwork(tensors, g)
    if "siteinds" not in data:
        return tn
    siteinds = {v: [index_from_plain(p) for p in s]
                for v, s in data["siteinds"].items()}
    return TensorNetworkState(tn, siteinds)
