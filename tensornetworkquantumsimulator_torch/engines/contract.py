"""Whole-network contraction dispatcher (`src/contract.jl`).

The counterpart of ``tensornetworkquantumsimulator_tpu.engines.contract``."""

from __future__ import annotations

from ..models.tensornetwork import AbstractTensorNetwork
from ..ops.paths import contraction_sequence
from ..ops.tensor import contract as contract_list
from .beliefpropagation import BeliefPropagationCache, default_bp_update_kwargs


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
    if alg == "boundarymps":
        from .boundarymps import BoundaryMPSCache

        mps_bond_dimension = kwargs.pop("mps_bond_dimension")
        bmps_update_kwargs = kwargs.pop("bmps_update_kwargs", {})
        cache = BoundaryMPSCache(tn, mps_bond_dimension)
        cache = cache.update(**bmps_update_kwargs)
        return cache.partitionfunction()
    raise ValueError(f"unknown contraction alg {alg!r}")
