"""Composite sandwich networks: ⟨ϕ|I|ψ⟩ and ⟨ψ|O|ψ⟩.

The counterpart of ``tensornetworkquantumsimulator_tpu.models.forms``
(`src/Forms/bilinearform.jl` and `quadraticform.jl`): lazily stacked
3-layer networks exposing the same `bp_factors` / `virtualinds` /
`default_message` interface as a state, so the BP engine runs on them
unchanged.  The operator layer is made on the ket's device.
"""

from __future__ import annotations

from typing import Callable

from ..ops.tensor import Tensor, contract_pair, delta
from ..utils.graphs import NamedEdge
from . import sites as _sites
from .tensornetwork import AbstractTensorNetwork, TensorNetwork, TensorNetworkState


class BilinearForm(AbstractTensorNetwork):
    """⟨ϕ|I|ψ⟩ as (ket, identity-deltas, bra = dag∘prime ϕ)
    (`bilinearform.jl:1-37`)."""

    def __init__(self, ket: TensorNetworkState, bra: TensorNetworkState):
        if ket.graph() != bra.graph():
            raise ValueError("BilinearForm states must share a graph")
        self._ket = ket
        dtype = ket.scalartype()
        sinds = ket.siteinds()
        op_tensors = {}
        for v in ket.vertices():
            t = None
            for s in sinds[v]:
                d = delta((s, s.prime()), dtype=dtype, device=ket.device())
                t = d if t is None else contract_pair(t, d)
            op_tensors[v] = t
        self._operator = TensorNetworkState(
            TensorNetwork(op_tensors, ket.graph().copy()), sinds
        )
        self._bra = bra.map_tensors(lambda t: t.dag().prime())

    def ket(self) -> TensorNetworkState:
        return self._ket

    def bra(self) -> TensorNetworkState:
        return self._bra

    def operator(self) -> TensorNetworkState:
        return self._operator

    def graph(self):
        return self._ket.graph()

    def tensors(self):
        return self._ket.tensors()

    def copy(self):
        obj = object.__new__(BilinearForm)
        obj._ket = self._ket.copy()
        obj._operator = self._operator.copy()
        obj._bra = self._bra.copy()
        return obj

    def scalartype(self):
        return self._ket.scalartype()

    def virtualinds(self, e: NamedEdge):
        return (
            self._ket.virtualinds(e)
            + self._operator.virtualinds(e)
            + self._bra.virtualinds(e)
        )

    def default_message(self, e: NamedEdge) -> Tensor:
        return delta(self.virtualinds(e), dtype=self.scalartype(),
                     device=self._ket.device())

    def bp_factors(self, vs) -> list:
        if not isinstance(vs, list):
            vs = [vs]
        out = []
        for v in vs:
            out.extend([self._ket[v], self._operator[v], self._bra[v]])
        return out


class QuadraticForm(AbstractTensorNetwork):
    """⟨ψ|O|ψ⟩ with the bra derived lazily as prime(dag(ket))
    (`quadraticform.jl:1-34`)."""

    def __init__(self, ket: TensorNetworkState, f: Callable = None):
        if f is None:
            f = lambda v: "I"  # noqa: E731
        self._ket = ket
        dtype = ket.scalartype()
        sinds = ket.siteinds()
        op_tensors = {}
        for v in ket.vertices():
            t = None
            for s in sinds[v]:
                o = _sites.op_tensor(f(v), s, dtype=dtype,
                                     device=ket.device())
                t = o if t is None else contract_pair(t, o)
            op_tensors[v] = t
        self._operator = TensorNetworkState(
            TensorNetwork(op_tensors, ket.graph().copy()), sinds
        )

    def ket(self) -> TensorNetworkState:
        return self._ket

    def operator(self) -> TensorNetworkState:
        return self._operator

    def bra(self) -> TensorNetworkState:
        return self._ket.map_tensors(lambda t: t.dag().prime())

    def graph(self):
        return self._ket.graph()

    def tensors(self):
        return self._ket.tensors()

    def copy(self):
        obj = object.__new__(QuadraticForm)
        obj._ket = self._ket.copy()
        obj._operator = self._operator.copy()
        return obj

    def scalartype(self):
        return self._ket.scalartype()

    def virtualinds(self, e: NamedEdge):
        ket_linds = self._ket.virtualinds(e)
        return (
            ket_linds
            + self._operator.virtualinds(e)
            + [l.prime() for l in ket_linds]
        )

    def default_message(self, e: NamedEdge) -> Tensor:
        return delta(self.virtualinds(e), dtype=self.scalartype(),
                     device=self._ket.device())

    def bp_factors(self, vs) -> list:
        if not isinstance(vs, list):
            vs = [vs]
        out = []
        for v in vs:
            kv = self._ket[v]
            out.extend([kv, self._operator[v], kv.dag().prime()])
        return out
