"""Bond truncation on the batched engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.truncate``
(`src/truncate.jl:12-38`, BP flavour): truncation is an identity two-site
gate applied to every edge, grouped by edge colour with a flooding-BP
refresh between groups, so each group is one batched simple update with
the target χ/cutoff.  The environment roots and, with
``TNQS_SVD_ALG=gram``, the split's eigh run on the Jacobi kernels under
``TNQS_EIGH_ALG=jacobi`` exactly as in a Trotter layer."""

from __future__ import annotations

import torch

from .engine import apply_color_group, bp_update, graph_tables
from .structure import BatchedGraphSpec


def batched_truncate(
    spec: BatchedGraphSpec,
    state,
    chi: int,
    cutoff: float = 0.0,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    normalize_tensors: bool = True,
):
    """Truncate every bond to χ/cutoff via identity gates (`truncate.jl:12-38`).

    ``chi`` must equal the state's buffer χ (static shapes); truncation to a
    smaller rank is expressed through ``cutoff``.  Returns (state, errors),
    the errors in colour-group order."""
    d = state.tensors.shape[-1]
    dev = state.tensors.device
    gate = torch.eye(d * d, dtype=state.tensors.dtype,
                     device=dev).reshape(d, d, d, d)
    tables = graph_tables(spec, dev)
    errs = []
    for group in spec.color_groups:
        state = bp_update(spec, state, maxiter=bp_maxiter,
                          tolerance=bp_tolerance, tables=tables)
        state, err = apply_color_group(
            state, group, gate, chi=chi, cutoff=cutoff,
            normalize_tensors=normalize_tensors,
        )
        errs.append(err)
    state = bp_update(spec, state, maxiter=bp_maxiter, tolerance=bp_tolerance,
                      tables=tables)
    return state, torch.cat(errs) if errs else torch.zeros((0,), device=dev)
