"""Sandwich BP and Pauli expectations of density-matrix states.

The counterpart of the d=4 readout of
``tensornetworkquantumsimulator_tpu.parallel.overlap``: flooding BP on the
two-layer ψ̄ϕ sandwich (the engine's message update with the bra layer in
place of ``conj(ket)``), and :func:`make_pauli_expectation_fn`, the
per-site ⟨P⟩ of a batched "PauliRho" (d=4) state.  The rest of the
reference module (overlaps, purity, echoes, differentiable sweeps) is not
ported yet.

Sandwich messages are NOT hermitian (the two layers differ), so message
normalization skips the hermitization the norm BP applies.
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import _numpy_dtype
from .engine import (
    _LETTERS,
    _absorb,
    _fixed_point,
    _normalize_messages,
    BatchedState,
    default_batched_tolerance,
    graph_tables,
    identity_messages,
    outgoing_messages_einsum,
)
from .structure import BatchedGraphSpec


def _sandwich_bp(spec, t_ket, t_bra_conj, messages, maxiter, tolerance,
                 damping, tables=None):
    """Sandwich BP to its fixed point, with the norm BP's loop semantics.
    The reference's ``_sandwich_outgoing`` is the engine's message update
    with the (pre-conjugated) bra layer closing the site leg."""
    if tables is None:
        tables = graph_tables(spec, t_ket.device)

    def iterate(m):
        m_out = outgoing_messages_einsum(t_ket, m, t_bra_conj)
        gathered = m_out[tables.nbr, tables.nbr_slot]
        return _normalize_messages(gathered, tables.mask, hermitize_=False)

    return _fixed_point(iterate, messages, tables.mask, maxiter, tolerance,
                        damping)


def make_pauli_expectation_fn(
    spec: BatchedGraphSpec,
    chi: int,
    dtype: torch.dtype,
    ops: tuple = ("Z",),
    *,
    maxiter: int = 50,
    tolerance: float | None = None,
):
    """Per-site ⟨P⟩ = Tr[ρP_v]/Tr[ρ] on a batched density-matrix
    ("PauliRho", d=4) state.

    The linear functional Tr[ρ·⊗X_v] is the sandwich overlap against a
    bond-1 product bra (trace vector [1,0,0,0] per site,
    `measure.pauli_expectation`); one sandwich-BP fixed point serves every
    site and every op: each value is a local-scalar ratio with the bra's
    site vector swapped to the Pauli basis vector (exact on trees, BP
    otherwise).  Returns ``fn(state) -> {op: [V] real tensor}``."""
    basis = {"I": 0, "X": 1, "Y": 2, "Z": 3}
    V, D = spec.num_vertices, spec.degree
    if tolerance is None:
        tolerance = default_batched_tolerance(dtype)
    npdt = _numpy_dtype(dtype)

    def _bra(vec4):
        t = np.zeros((V,) + (chi,) * D + (4,), dtype=npdt)
        t[(slice(None),) + (0,) * D] = np.asarray(vec4, dtype=npdt)
        return torch.from_numpy(np.conj(t))  # the bra enters conjugated

    host = {"trace": _bra([1.0, 0, 0, 0])}
    host.update({op: _bra(np.eye(4)[basis[op.upper()]]) for op in ops})
    on_device: dict = {}  # device -> (bras, graph tables), built once
    lab = "".join(_LETTERS[k] for k in range(D))

    def fn(state: BatchedState):
        t_ket = state.tensors
        dev = t_ket.device
        if dev not in on_device:
            on_device[dev] = ({k: b.to(dev) for k, b in host.items()},
                              graph_tables(spec, dev))
        bras, tables = on_device[dev]
        m0 = identity_messages(V, D, chi, t_ket.dtype, dev)
        m = _sandwich_bp(spec, t_ket, bras["trace"], m0, maxiter, tolerance,
                         0.0, tables)
        acc = t_ket
        for k in range(D):
            acc = _absorb(acc, m[:, k], 1 + k)
        eq = f"v{lab}s,v{lab}s->v"
        zv = torch.einsum(eq, acc, bras["trace"])
        return {op: (torch.einsum(eq, acc, bras[op]) / zv).real for op in ops}

    return fn
