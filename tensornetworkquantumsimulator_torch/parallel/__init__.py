"""Batched single-device engine: flooding BP, batched simple update, the
Trotter-layer compiler, parametric and ensemble layers, the CUDA kernels on
those paths, and the measurement half: Vidal gauge, truncation, sandwich
overlaps and the d=4 Pauli readout, BP and density-matrix sampling, path
correlators, boundary MPS and certified sampling."""

from .boundarymps import (
    GridBMPSSpec,
    PlanarBMPSSpec,
    derive_planar_columns,
    identity_strand,
    make_grid_bmps,
    make_grid_bmps_correlations,
    make_planar_bmps,
    make_planar_bmps_correlations,
)
from .certified_sampling import (
    make_grid_certified_sampler,
    make_planar_certified_sampler,
)

from .convert import batched_product_state, state_from_numpy, state_to_numpy
from .correlations import (
    make_mutual_information_fn,
    make_path_correlation_fn,
    make_path_rdm_fn,
    make_string_expectation_fn,
    path_correlations,
    shortest_path,
    string_expectations,
)
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
from .gauge import batched_symmetric_gauge
from .overlap import (
    batched_inner,
    batched_loschmidt_echo,
    batched_purity,
    make_pauli_expectation_fn,
    sandwich_logz,
    sandwich_sweeps,
)
from .sampling import make_bp_sampler, make_rho_sampler
from .structure import BatchedGraphSpec, SlotPairBucket, compile_graph
from .trotter import BatchedCircuit, TrotterLayer, make_expectation_fn, make_layer_fn
from .truncate import batched_truncate

__all__ = [
    "BatchedCircuit",
    "BatchedGraphSpec",
    "BatchedState",
    "FieldLayer",
    "GraphTables",
    "GridBMPSSpec",
    "PlanarBMPSSpec",
    "SlotPairBucket",
    "TrotterLayer",
    "apply_color_group",
    "apply_one_site",
    "batched_inner",
    "batched_loschmidt_echo",
    "batched_product_state",
    "batched_purity",
    "batched_symmetric_gauge",
    "batched_truncate",
    "bond_expectations",
    "bond_rdms",
    "bp_iteration",
    "bp_update",
    "compile_graph",
    "derive_planar_columns",
    "ensemble_fn",
    "graph_tables",
    "identity_messages",
    "identity_strand",
    "local_expectations",
    "local_rdms",
    "make_bp_sampler",
    "make_ensemble_expectation_fn",
    "make_expectation_fn",
    "make_field_layer_fn",
    "make_grid_bmps",
    "make_grid_bmps_correlations",
    "make_grid_certified_sampler",
    "make_layer_fn",
    "make_mutual_information_fn",
    "make_noisy_field_layer_fn",
    "make_path_correlation_fn",
    "make_path_rdm_fn",
    "make_pauli_expectation_fn",
    "make_planar_bmps",
    "make_planar_bmps_correlations",
    "make_planar_certified_sampler",
    "make_rho_sampler",
    "make_string_expectation_fn",
    "path_correlations",
    "ptm_channel",
    "ptm_rot",
    "rot1",
    "rot2",
    "sandwich_logz",
    "sandwich_sweeps",
    "shortest_path",
    "stack_states",
    "state_from_numpy",
    "state_to_numpy",
    "string_expectations",
    "unstack_states",
]
