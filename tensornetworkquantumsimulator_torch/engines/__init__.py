"""Contraction engines of the generic network: exact and belief
propagation (boundary MPS and loop corrections are the next slice)."""

from .beliefpropagation import (
    AbstractBeliefPropagationCache,
    BeliefPropagationCache,
    cache_from_numpy,
    cache_to_numpy,
    default_bp_update_kwargs,
    message_diff,
)
from .contract import contract_network

__all__ = [
    "AbstractBeliefPropagationCache",
    "BeliefPropagationCache",
    "cache_from_numpy",
    "cache_to_numpy",
    "contract_network",
    "default_bp_update_kwargs",
    "message_diff",
]
