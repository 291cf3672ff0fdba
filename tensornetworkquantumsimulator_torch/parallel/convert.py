"""Initial states and the carry-across between the JAX and PyTorch states.

This system has no weights: the batched state (vertex tensors + BP
messages) is the whole set of parameters, so moving a run between the
two packages is a matter of handing its two arrays across as numpy.  A
stacked ensemble state (``[E, V, ...]``, from either package's
``stack_states``) crosses the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve_device
from ..models.sites import pauli_coefficients, state_vector
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
