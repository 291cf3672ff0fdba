"""Initial states, the carry-across between the JAX and PyTorch states, and
the bridges between the generic and the batched engine.

This system has no weights: the batched state (vertex tensors + BP
messages) is the whole set of parameters, so moving a run between the
two packages is a matter of handing its two arrays across as numpy.  A
stacked ensemble state (``[E, V, ...]``, from either package's
``stack_states``) crosses the same way.

:func:`batched_from_tns`, :func:`batched_to_tns` and
:func:`batched_messages_to_cache` are the counterparts of the JAX
package's bridges (``parallel/convert.py:51-178`` there): a generic
:class:`~..models.tensornetwork.TensorNetworkState` packed into the
static-shape batched state (bonds zero-padded to χ, dummy slots at index
0 with identity messages) and back.  They copy on the devices, never
through the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve_device
from ..engines.beliefpropagation import BeliefPropagationCache
from ..models.sites import pauli_coefficients, state_vector
from ..models.tensornetwork import TensorNetwork, TensorNetworkState
from ..ops.index import Index
from ..ops.tensor import Tensor, as_torch_dtype
from ..utils.graphs import NamedEdge
from .engine import BatchedState
from .structure import BatchedGraphSpec, compile_graph


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def batched_product_state(
    g,
    chi: int,
    state_fn=None,
    dtype: torch.dtype = torch.complex64,
    spec: BatchedGraphSpec | None = None,
    d: int = 2,
    device=None,
) -> tuple:
    """A product-state :class:`BatchedState`, built host-side in numpy and
    copied to ``device`` once.  ``state_fn`` maps a vertex to a state
    string ("↑", "X+", ...) or vector; default is all-up.  ``device=None``
    is the package's default device (CUDA).  With ``d=4`` the
    sites are density-matrix Pauli sites: a string names a one-site state
    ("0", "+", "mixed", ...) and becomes its coefficient vector
    [Tr ρ, Tr ρX, Tr ρY, Tr ρZ], as in the JAX package's
    ``density_matrix_tensornetworkstate``."""
    if spec is None:
        spec = compile_graph(g)
    if state_fn is None:
        state_fn = lambda v: "↑"  # noqa: E731
    npdt = _numpy_dtype(dtype)
    V, D = spec.num_vertices, spec.degree
    tensors = np.zeros((V,) + (chi,) * D + (d,), dtype=npdt)
    for i, v in enumerate(spec.vertices):
        if not g.has_vertex(v):  # inert shard-padding row
            tensors[(i,) + (0,) * D + (0,)] = 1.0
            continue
        local = state_fn(v)
        if not isinstance(local, str):
            vec = np.asarray(local)
        elif d == 4:
            vec = pauli_coefficients(local)
        else:
            vec = state_vector(local, d)
        tensors[(i,) + (0,) * D] = vec.astype(npdt)
    msgs = np.broadcast_to(np.eye(chi, dtype=npdt), (V, D, chi, chi)).copy()
    return spec, state_from_numpy(tensors, msgs, device)


def state_from_numpy(tensors: np.ndarray, messages: np.ndarray,
                     device=None) -> BatchedState:
    """A :class:`BatchedState` from numpy arrays (e.g. a JAX state's
    ``np.asarray(state.tensors)``, ``np.asarray(state.messages)``), single
    or stacked, on ``device`` (None: the package's default, CUDA).  The
    arrays are copied: a JAX array's host view is read-only, and the
    port's layers write into their own buffers."""
    device = resolve_device(device)
    return BatchedState(
        torch.tensor(np.asarray(tensors), device=device),
        torch.tensor(np.asarray(messages), device=device),
    )


def state_to_numpy(state: BatchedState) -> tuple:
    """``(tensors, messages)`` as numpy arrays on the host."""
    return (state.tensors.detach().cpu().resolve_conj().numpy(),
            state.messages.detach().cpu().resolve_conj().numpy())


def batched_from_tns(
    tns: TensorNetworkState,
    chi: int,
    spec: BatchedGraphSpec | None = None,
    dtype=None,
    messages: dict | None = None,
    device=None,
) -> tuple:
    """Pack a TensorNetworkState into a BatchedState on ``device`` (None:
    the package default): bonds zero-padded to χ, dummy slots on index 0
    with identity messages.  ``messages`` (directed edge → message on
    (l, l')) fills the slots of the edges it names.  Returns (spec,
    state)."""
    if spec is None:
        spec = compile_graph(tns.graph())
    device = resolve_device(device)
    V, D = spec.num_vertices, spec.degree
    tg = tns.graph()
    d = tns.siteinds(
        next(v for v in spec.vertices if tg.has_vertex(v))
    )[0].dim
    dtype = as_torch_dtype(tns.scalartype() if dtype is None else dtype)

    nbr = spec.nbr_array()
    mask = spec.mask_array()
    tensors = torch.zeros((V,) + (chi,) * D + (d,), dtype=dtype, device=device)
    msgs = torch.eye(chi, dtype=dtype, device=device).expand(
        V, D, chi, chi).clone()
    for i, v in enumerate(spec.vertices):
        if not tg.has_vertex(v):  # inert shard-padding row
            tensors[(i,) + (0,) * D + (0,)] = 1.0
            continue
        sind = tns.siteinds(v)[0]
        bond_inds = []
        for k in range(D):
            if mask[i, k]:
                w = spec.vertices[nbr[i, k]]
                vinds = tns.virtualinds(NamedEdge(v, w))
                if len(vinds) != 1:
                    raise ValueError("batched engine needs one index per edge")
                bond_inds.append(vinds[0])
            else:
                bond_inds.append(None)
        order = [b for b in bond_inds if b is not None] + [sind]
        arr = tns[v].array(tuple(order)).to(device=device, dtype=dtype)
        # real bonds in slot order then the site; a dummy slot is a unit axis
        idx = [slice(0, 1) if b is None else slice(0, b.dim)
               for b in bond_inds]
        for ax in [k for k in range(D) if bond_inds[k] is None]:
            arr = arr.unsqueeze(ax)
        tensors[(i,) + tuple(idx) + (slice(None),)] = arr

    if messages is not None:
        for i, v in enumerate(spec.vertices):
            for k in range(D):
                if not mask[i, k]:
                    continue
                w = spec.vertices[nbr[i, k]]
                m = messages.get(NamedEdge(w, v))
                if m is None:
                    continue
                l = tns.virtualinds(NamedEdge(v, w))[0]
                msgs[i, k] = 0
                msgs[i, k, : l.dim, : l.dim] = m.array((l, l.prime())).to(
                    device=device, dtype=dtype)

    return spec, BatchedState(tensors, msgs)


def batched_to_tns(
    spec: BatchedGraphSpec,
    state: BatchedState,
    g,
    siteinds: dict,
) -> TensorNetworkState:
    """Unpack a BatchedState into a TensorNetworkState on the state's
    device (full χ bonds kept; dummy slots sliced at index 0).  The
    tensors are copies: the batched state's buffers stay its own."""
    D = spec.degree
    chi = state.chi
    mask = spec.mask_array()
    bond_index: dict = {}
    for (iu, iv, su, sv) in spec.edges:
        l = Index(chi)
        bond_index[(iu, su)] = l
        bond_index[(iv, sv)] = l
    tensors = {}
    for i, v in enumerate(spec.vertices):
        arr = state.tensors[i]
        inds = []
        for k in range(D):
            if mask[i, k]:
                inds.append(bond_index[(i, k)])
            else:
                arr = arr.select(len(inds), 0)
        sind = siteinds[v][0]
        tensors[v] = Tensor(arr.clone(), tuple(inds) + (sind,))
    return TensorNetworkState(TensorNetwork(tensors, g.copy()), siteinds)


def batched_messages_to_cache(
    spec: BatchedGraphSpec, state: BatchedState, tns: TensorNetworkState
) -> BeliefPropagationCache:
    """Wrap an unpacked state in a BP cache carrying the batched messages."""
    cache = BeliefPropagationCache(tns)
    nbr = spec.nbr_array()
    mask = spec.mask_array()
    for i, v in enumerate(spec.vertices):
        for k in range(spec.degree):
            if not mask[i, k]:
                continue
            w = spec.vertices[nbr[i, k]]
            l = tns.virtualinds(NamedEdge(v, w))[0]
            m = Tensor(state.messages[i, k].clone(), (l, l.prime()))
            cache.setmessage(NamedEdge(w, v), m)
    return cache
