"""Whole-network contraction dispatcher (`src/contract.jl`).

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.contract``
for ``alg="exact"`` and ``alg="bp"``.  The boundary-MPS engine of the
generic network is not ported yet: ``alg="boundarymps"`` raises."""

from __future__ import annotations

from ..models.tensornetwork import AbstractTensorNetwork
from ..ops.paths import contraction_sequence
from ..ops.tensor import contract as contract_list
from .beliefpropagation import BeliefPropagationCache, default_bp_update_kwargs

NOT_PORTED = (
    "the generic engine's {alg!r} backend is not ported to the PyTorch "
    "package yet (it comes with engines/boundarymps.py and "
    "engines/loopcorrection.py, the next slice of the port); the batched "
    "engine has it in tensornetworkquantumsimulator_torch.parallel")


def contract_network(tn: AbstractTensorNetwork, alg: str = "exact", **kwargs):
    """Contract a flat network to a scalar with the chosen backend."""
    if alg == "exact":
        tensors = [tn[v] for v in tn.vertices()]
        seq = contraction_sequence(tensors, alg=kwargs.pop("sequence_alg", "einexpr"))
        return contract_list(tensors, seq).scalar()
    if alg == "bp":
        bp_update_kwargs = kwargs.pop("bp_update_kwargs", None) or default_bp_update_kwargs(tn)
        bpc = BeliefPropagationCache(tn).update(**bp_update_kwargs)
        return bpc.partitionfunction()
    if alg in ("boundarymps", "loopcorrections"):
        raise NotImplementedError(NOT_PORTED.format(alg=alg))
    raise ValueError(f"unknown contraction alg {alg!r}")
