"""Batched single-device engine: flooding BP, batched simple update, the
Trotter-layer compiler, parametric and ensemble layers, the d=4 Pauli
readout and the CUDA kernels on those paths."""

from .convert import batched_product_state, state_from_numpy, state_to_numpy
from .engine import (
    BatchedState,
    GraphTables,
    apply_color_group,
    apply_one_site,
    bond_expectations,
    bond_rdms,
    bp_iteration,
    bp_update,
    graph_tables,
    identity_messages,
    local_expectations,
    local_rdms,
)
from .ensemble import (
    FieldLayer,
    ensemble_fn,
    make_ensemble_expectation_fn,
    make_field_layer_fn,
    make_noisy_field_layer_fn,
    ptm_channel,
    ptm_rot,
    rot1,
    rot2,
    stack_states,
    unstack_states,
)
from .overlap import make_pauli_expectation_fn
from .structure import BatchedGraphSpec, SlotPairBucket, compile_graph
from .trotter import BatchedCircuit, TrotterLayer, make_expectation_fn, make_layer_fn

__all__ = [
    "BatchedCircuit",
    "FieldLayer",
    "BatchedGraphSpec",
    "BatchedState",
    "GraphTables",
    "SlotPairBucket",
    "TrotterLayer",
    "apply_color_group",
    "apply_one_site",
    "batched_product_state",
    "bond_expectations",
    "bond_rdms",
    "bp_iteration",
    "bp_update",
    "compile_graph",
    "ensemble_fn",
    "graph_tables",
    "identity_messages",
    "local_expectations",
    "local_rdms",
    "make_ensemble_expectation_fn",
    "make_expectation_fn",
    "make_field_layer_fn",
    "make_layer_fn",
    "make_noisy_field_layer_fn",
    "make_pauli_expectation_fn",
    "ptm_channel",
    "ptm_rot",
    "rot1",
    "rot2",
    "stack_states",
    "state_from_numpy",
    "state_to_numpy",
    "unstack_states",
]
