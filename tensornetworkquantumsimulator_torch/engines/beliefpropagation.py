"""Belief-propagation contraction engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.
beliefpropagation`` (`src/MessagePassing/abstractbeliefpropagationcache.jl`
and `beliefpropagationcache.jl`): a cache object wrapping a network plus a
dictionary of per-directed-edge message tensors, with the uniform interface
``network / messages / update / vertex_scalar / edge_scalar /
partitionfunction / rescale`` that every backend shares.

The default schedule is the reference's sequential forest-cover sweep
(tree-exact in one iteration); the batched synchronous ("flooding")
schedule lives in `parallel/engine.py` (``bp_update``).

Host reads.  A sweep keeps its scalars on the messages' device: each
message is normalized by its entry sum there (a zero sum leaves it as it
is, as in the JAX package), and each message's change
1 - |⟨a,b⟩|²/(‖a‖‖b‖)² is added to a device total.  The sweep reads that
total once, to test the mean change against the tolerance: one host read
per sweep where the JAX package reads three scalars per directed edge.
The values are the same; only where they are read differs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.tensornetwork import AbstractTensorNetwork, TensorNetworkState
from ..ops.paths import contraction_sequence
from ..ops.tensor import (
    Tensor,
    as_torch_dtype,
    contract,
    contract_pair,
    make_hermitian,
)
from ..utils.graphs import NamedEdge, NamedGraph, forest_cover_edge_sequence

DEFAULT_BP_MAXITER = 25  # `beliefpropagationcache.jl:108`


def default_tolerance(dtype) -> float:
    """Reference per-dtype defaults (`beliefpropagationcache.jl:109-112`)."""
    if as_torch_dtype(dtype) in (torch.float32, torch.complex64):
        return 1.0e-5
    return 1.0e-8


def message_diff_tensor(a: Tensor, b: Tensor) -> torch.Tensor:
    """1 - |⟨a,b⟩|²/(‖a‖‖b‖)² as a 0-dim real tensor on the messages'
    device, 1 where either norm is 0 (`beliefpropagationcache.jl:15-19`)."""
    na, nb = a.norm_tensor(), b.norm_tensor()
    zero = (na == 0) | (nb == 0)
    den = torch.where(zero, torch.ones_like(na), na * nb)
    f = (contract_pair(a.dag(), b).data.abs() / den) ** 2
    return torch.where(zero, torch.ones_like(f), 1 - f)


def message_diff(a: Tensor, b: Tensor) -> float:
    """1 - |⟨a,b⟩|²/(‖a‖‖b‖)² fidelity metric (`beliefpropagationcache.jl:15-19`)."""
    return float(message_diff_tensor(a, b))


class AbstractBeliefPropagationCache:
    """Message-passing engine skeleton (`abstractbeliefpropagationcache.jl`)."""

    # subclasses provide: network(), messages(), graph(), copy(),
    # default_bp_edge_sequence(), edge_scalar(), rescale_messages_inplace(),
    # rescale_vertices_inplace()

    def network(self) -> AbstractTensorNetwork:
        raise NotImplementedError

    def messages(self) -> dict:
        raise NotImplementedError

    def graph(self) -> NamedGraph:
        raise NotImplementedError

    # -- network/graph forwarding ---------------------------------------------
    def bp_factors(self, vs):
        return self.network().bp_factors(vs)

    def default_message(self, e: NamedEdge):
        return self.network().default_message(e)

    def scalartype(self):
        return self.network().scalartype()

    def vertices(self):
        return self.graph().vertices()

    def edges(self):
        return self.graph().edges()

    def virtualinds(self, e):
        return self.network().virtualinds(e)

    def maxvirtualdim(self):
        return self.network().maxvirtualdim()

    def siteinds(self, v=None):
        return self.network().siteinds(v) if v is not None else self.network().siteinds()

    def is_tree(self):
        return self.graph().is_tree()

    def setindex_preserve(self, t, v):
        self.network().setindex_preserve(t, v)
        return self

    # -- message access ---------------------------------------------------------
    def message(self, e: NamedEdge) -> Tensor:
        ms = self.messages()
        m = ms.get(e)
        if m is None:
            m = self.default_message(e)
        return m

    def messages_list(self, edges) -> list:
        out = []
        for e in edges:
            m = self.message(e)
            if isinstance(m, list):
                out.extend(m)
            else:
                out.append(m)
        return out

    def setmessage(self, e: NamedEdge, m):
        self.messages()[e] = m
        return self

    def deletemessage(self, e: NamedEdge):
        self.messages().pop(e, None)
        return self

    def deletemessages(self, edges=None):
        for e in list(edges if edges is not None else self.messages().keys()):
            self.deletemessage(e)
        return self

    def incoming_messages(self, vertices, ignore_edges=()) -> list:
        """Messages on the boundary edges pointing into a vertex set
        (`abstractbeliefpropagationcache.jl:132-142`)."""
        if not isinstance(vertices, list):
            vertices = [vertices]
        b_edges = self.graph().boundary_edges(vertices, dir="in")
        if ignore_edges:
            ig = set(ignore_edges)
            b_edges = [e for e in b_edges if e not in ig]
        return self.messages_list(b_edges)

    # -- scalars ------------------------------------------------------------------
    def vertex_scalar(self, v):
        tensors = self.bp_factors(v) + self.incoming_messages(v)
        seq = contraction_sequence(tensors, alg="optimal")
        return contract(tensors, seq).scalar()

    def vertex_scalars(self, vertices=None):
        vs = vertices if vertices is not None else self.vertices()
        return [self.vertex_scalar(v) for v in vs]

    def edge_scalar(self, e):
        raise NotImplementedError

    def edge_scalars(self, edges=None):
        es = edges if edges is not None else self.edges()
        return [self.edge_scalar(e) for e in es]

    def scalar_factors_quotient(self):
        return self.vertex_scalars(), self.edge_scalars()

    def freenergy(self):
        """Σ log(vertex scalars) − Σ log(edge scalars) with complex promotion
        and −Inf guard (`abstractbeliefpropagationcache.jl:252-263`)."""
        numer, denom = self.scalar_factors_quotient()
        if any(np.real(t) < 0 for t in numer):
            numer = [complex(t) for t in numer]
        if any(np.real(t) < 0 for t in denom):
            denom = [complex(t) for t in denom]
        if any(t == 0 for t in denom):
            return -math.inf
        return sum(np.log(t) for t in numer) - sum(np.log(t) for t in denom)

    def partitionfunction(self):
        f = self.freenergy()
        if f == -math.inf:
            return 0.0
        z = np.exp(f)
        return complex(z) if np.iscomplexobj(z) else float(z)

    # -- message updates ----------------------------------------------------------
    def updated_message(
        self,
        e: NamedEdge,
        normalize: bool = True,
        enforce_hermiticity: bool = False,
        sequence_alg: str = "optimal",
    ) -> Tensor:
        """Contract source-vertex factors with incoming messages except the
        reverse edge (`abstractbeliefpropagationcache.jl:144-177`)."""
        vertex = e.src
        incoming = self.incoming_messages(vertex, ignore_edges=[e.reverse()])
        tensors = incoming + self.bp_factors(vertex)
        seq = contraction_sequence(tensors, alg=sequence_alg)
        m = contract(tensors, seq)
        if enforce_hermiticity:
            m = make_hermitian(m)
        if normalize:
            n = m.data.sum()
            m = Tensor(m.data / torch.where(n != 0, n, torch.ones_like(n)),
                       m.inds)
        return m

    def update_message_inplace(self, e: NamedEdge, **kwargs):
        return self.setmessage(e, self.updated_message(e, **kwargs))

    def update_iteration_inplace(self, edges, compute_diff=False, **kwargs) -> float:
        """Sequential sweep over a directed-edge schedule
        (`abstractbeliefpropagationcache.jl:182-196`); the summed change is
        read from the device once, at the end."""
        total = None
        for e in edges:
            prev = self.message(e) if compute_diff else None
            self.update_message_inplace(e, **kwargs)
            if compute_diff:
                d = message_diff_tensor(self.message(e), prev)
                total = d if total is None else total + d
        return 0.0 if total is None else float(total)

    def default_bp_maxiter(self) -> int:
        return 1 if self.graph().is_tree() else DEFAULT_BP_MAXITER

    def default_bp_edge_sequence(self) -> list:
        return forest_cover_edge_sequence(self.graph())

    def default_update_kwargs(self) -> dict:
        return dict(
            maxiter=self.default_bp_maxiter(),
            tolerance=default_tolerance(self.scalartype()),
        )

    def update(
        self,
        maxiter: int | None = None,
        tolerance: float | None = "default",
        edge_sequence=None,
        verbose: bool = False,
        normalize: bool = True,
        enforce_hermiticity: bool = False,
        **message_update_kwargs,
    ):
        """Fixed-point BP loop with early exit on the mean per-edge message
        change (`abstractbeliefpropagationcache.jl:198-222`)."""
        if maxiter is None:
            maxiter = self.default_bp_maxiter()
        if tolerance == "default":
            tolerance = default_tolerance(self.scalartype())
        if edge_sequence is None:
            edge_sequence = self.default_bp_edge_sequence()
        bpc = self.copy()
        compute_diff = tolerance is not None
        for i in range(maxiter):
            diff = bpc.update_iteration_inplace(
                edge_sequence,
                compute_diff=compute_diff,
                normalize=normalize,
                enforce_hermiticity=enforce_hermiticity,
                **message_update_kwargs,
            )
            if compute_diff and diff / max(len(edge_sequence), 1) <= tolerance:
                if verbose:
                    print(f"BP converged to desired precision after {i + 1} iterations.")
                break
        return bpc

    # -- rescaling -----------------------------------------------------------------
    def rescale_inplace(self, vertices=None):
        self.rescale_messages_inplace()
        self.rescale_vertices_inplace(vertices)
        return self

    def rescale(self, vertices=None):
        return self.copy().rescale_inplace(vertices)

    def map_messages(self, f):
        bpc = self.copy()
        for e in list(bpc.messages().keys()):
            m = bpc.messages()[e]
            bpc.setmessage(e, [f(x) for x in m] if isinstance(m, list) else f(m))
        return bpc

    def map_factors(self, f):
        bpc = self.copy()
        for v in bpc.vertices():
            bpc.setindex_preserve(f(bpc.network()[v]), v)
        return bpc

    def astype(self, dtype):
        return self.map_messages(lambda t: t.astype(dtype)).map_factors(
            lambda t: t.astype(dtype)
        )


class BeliefPropagationCache(AbstractBeliefPropagationCache):
    """Concrete BP cache (`beliefpropagationcache.jl:9-13`)."""

    def __init__(self, network: AbstractTensorNetwork, messages: dict | None = None):
        self._network = network
        self._messages = {} if messages is None else messages

    def network(self):
        return self._network

    def messages(self):
        return self._messages

    def graph(self):
        return self._network.graph()

    def copy(self):
        return BeliefPropagationCache(self._network.copy(), dict(self._messages))

    def edge_scalar(self, e):
        """⟨m_e, m_ē⟩ (`beliefpropagationcache.jl:38-40`)."""
        return contract_pair(self.message(e), self.message(e.reverse())).scalar()

    def rescale_messages_inplace(self, edges=None):
        """Normalize message pairs so ⟨m_e, m_ē⟩ = 1
        (`beliefpropagationcache.jl:129-142`)."""
        es = edges if edges is not None else self.edges()
        for e in es:
            me = self.message(e).normalize()
            mer = self.message(e.reverse()).normalize()
            n = contract_pair(me, mer).scalar()
            if not isinstance(n, complex) or n.imag == 0:
                s = math.copysign(1.0, np.real(n))
                me = me * s
                n = n * s
            inv_sqrt_n = 1.0 / np.sqrt(n)
            self.setmessage(e, me * inv_sqrt_n)
            self.setmessage(e.reverse(), mer * inv_sqrt_n)
        return self

    def rescale_vertices_inplace(self, vertices=None):
        """Divide each tensor by (√)local-Z so that Z_BP = 1
        (`beliefpropagationcache.jl:87-106`)."""
        vs = vertices if vertices is not None else self.vertices()
        tn = self.network()
        if hasattr(tn, "operator"):
            # Forms: the operator layer enters the sandwich LINEARLY, so
            # scaling it by exactly 1/vn sets the vertex scalar to 1 even
            # for complex/negative scalars — scaling the ket only scales
            # the (ket, derived-bra) pair by |f|², which cannot cancel a
            # phase (needed by the loop expansion, `loopcorrection.jl:7-8`).
            op = tn.operator()
            for v in vs:
                vn = self.vertex_scalar(v)
                if vn != 0:
                    op.setindex_preserve(op[v] * (1 / vn), v)
            return self
        is_state = isinstance(tn, TensorNetworkState)
        for v in vs:
            vn = self.vertex_scalar(v)
            if isinstance(vn, complex) and vn.imag != 0:
                factor = 1 / np.sqrt(vn) if is_state else 1 / vn
            else:
                vnr = np.real(vn)
                s = math.copysign(1.0, vnr)
                factor = s / np.sqrt(abs(vnr)) if is_state else s / vnr
            tn.setindex_preserve(tn[v] * factor, v)
        return self


def default_bp_update_kwargs(tn) -> dict:
    maxiter = 1 if tn.graph().is_tree() else DEFAULT_BP_MAXITER
    return dict(maxiter=maxiter, tolerance=default_tolerance(tn.scalartype()))


# ---------------------------------------------------------------------------
# carry-across as plain data
# ---------------------------------------------------------------------------


def cache_to_numpy(cache: BeliefPropagationCache) -> dict:
    """A cache as plain data: its network (``models.state_to_numpy``) and
    ``messages[(src, dst)] = (array, [(id, dim, tags, plev), ...])``."""
    from ..models.tensornetwork import state_to_numpy
    from ..ops.index import index_to_plain

    return {"network": state_to_numpy(cache.network()),
            "messages": {(e.src, e.dst): (m.numpy(),
                                          [index_to_plain(i) for i in m.inds])
                         for e, m in cache.messages().items()}}


def cache_from_numpy(data: dict, device=None) -> BeliefPropagationCache:
    """The inverse of :func:`cache_to_numpy`, on ``device`` (None: the
    package default); index ids are kept, as ``models.state_from_numpy``
    keeps them."""
    from ..models.tensornetwork import state_from_numpy
    from ..ops.index import index_from_plain, reserve_ids
    from ..ops.tensor import from_array

    network = state_from_numpy(data["network"], device=device)
    msgs = data["messages"]
    reserve_ids(max((p[0] for _, inds in msgs.values() for p in inds),
                    default=0))
    messages = {NamedEdge(src, dst): from_array(
        np.asarray(arr), [index_from_plain(p) for p in inds],
        device=network.device()) for (src, dst), (arr, inds) in msgs.items()}
    return BeliefPropagationCache(network, messages)
