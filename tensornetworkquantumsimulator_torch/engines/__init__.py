"""Contraction engines of the generic network: exact, belief propagation,
boundary MPS, loop corrections."""

from .beliefpropagation import (
    AbstractBeliefPropagationCache,
    BeliefPropagationCache,
    cache_from_numpy,
    cache_to_numpy,
    default_bp_update_kwargs,
    message_diff,
)
from .boundarymps import BoundaryMPSCache, PartitionEdge, path_contract
from .contract import contract_network
from .diagnostics import loop_correlation, loop_correlations
from .loopcorrection import loopcorrected_partitionfunction

__all__ = [
    "AbstractBeliefPropagationCache",
    "BeliefPropagationCache",
    "BoundaryMPSCache",
    "PartitionEdge",
    "cache_from_numpy",
    "cache_to_numpy",
    "contract_network",
    "default_bp_update_kwargs",
    "loop_correlation",
    "loop_correlations",
    "loopcorrected_partitionfunction",
    "message_diff",
    "path_contract",
]
