"""Batched single-device engine: flooding BP, batched simple update, the
Trotter-layer compiler and the CUDA kernels on that path."""

from .convert import batched_product_state, state_from_numpy, state_to_numpy
from .engine import (
    BatchedState,
    GraphTables,
    apply_color_group,
    apply_one_site,
    bp_iteration,
    bp_update,
    graph_tables,
    identity_messages,
    local_expectations,
    local_rdms,
)
from .structure import BatchedGraphSpec, SlotPairBucket, compile_graph
from .trotter import BatchedCircuit, TrotterLayer, make_expectation_fn, make_layer_fn

__all__ = [
    "BatchedCircuit",
    "BatchedGraphSpec",
    "BatchedState",
    "GraphTables",
    "SlotPairBucket",
    "TrotterLayer",
    "apply_color_group",
    "apply_one_site",
    "batched_product_state",
    "bp_iteration",
    "bp_update",
    "compile_graph",
    "graph_tables",
    "identity_messages",
    "local_expectations",
    "local_rdms",
    "make_expectation_fn",
    "make_layer_fn",
    "state_from_numpy",
    "state_to_numpy",
]
