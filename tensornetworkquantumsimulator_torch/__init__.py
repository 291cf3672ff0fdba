"""PyTorch + CUDA port of the tensor-network quantum simulator.

The counterpart of ``tensornetworkquantumsimulator_tpu`` (JAX on a TPU),
which stays the reference.  This package covers the single-device batched
path: lattice → slot tables → product state → compiled layer (flooding BP
+ fused colour-group simple update) → BP ⟨Z⟩, and the measurement half
in ``parallel`` (Vidal gauge, truncation, overlaps, samplers, path
correlators, boundary MPS, certified sampling).  Its
Pallas kernels are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use.  It also holds the generic named-index engine
(``ops``, ``models``, ``engines``, ``apply``, ``gauge``, ``measure``):
``TensorNetworkState`` on a ``NamedGraph``, simple update under a
sequential ``BeliefPropagationCache``, and the "exact" and "bp"
measurements, exported here under the JAX package's names.  The package
imports ``torch`` and never ``jax``.  Its entry points run on CUDA unless
asked for another device (``device=``, or :func:`set_default_device`).
"""

from . import engines, models, ops, utils
from .devices import select_device, set_default_device
from .models import (
    AbstractTensorNetwork,
    BilinearForm,
    QuadraticForm,
    TensorNetwork,
    TensorNetworkState,
    channel_kraus,
    channel_ptm,
    density_matrix_tensornetworkstate,
    gate_matrix,
    identitytensornetworkstate,
    imaginary_time_kraus,
    kraus_to_ptm,
    op_matrix,
    paulitensornetworkstate,
    random_tensornetwork,
    random_tensornetworkstate,
    seed,
    siteinds,
    state_vector,
    tensornetworkstate,
    zerostate,
)
from .ops import Index, Tensor, make_hermitian
from .parallel import (
    BatchedCircuit,
    BatchedState,
    batched_product_state,
    bp_update,
    compile_graph,
    local_expectations,
    make_expectation_fn,
    make_layer_fn,
)
from .utils import (
    NamedEdge,
    NamedGraph,
    edge_color,
    heavy_hexagonal_lattice,
    ibm_eagle_lattice,
    named_grid,
)
from .utils.lattices import (
    named_comb_tree,
    named_hexagonal_lattice_graph,
    named_path_graph,
)
from .engines import BeliefPropagationCache, contract_network as contract
from .apply import apply_circuit, apply_gates, full_update, simple_update
from .gauge import (
    entanglement,
    gauge_and_scale,
    normalize,
    symmetric_gauge,
    symmetrize_and_bpnormalize,
    symmetrize_and_normalize,
)
from .measure import (
    expect,
    heisenberg_expectation,
    inner,
    norm,
    norm_sqr,
    pauli_expectation,
    purity,
    rdm,
    reduced_density_matrix,
)


__all__ = [
    "AbstractTensorNetwork",
    "apply_circuit",
    "apply_gates",
    "batched_product_state",
    "BatchedCircuit",
    "BatchedState",
    "BeliefPropagationCache",
    "BilinearForm",
    "bp_update",
    "channel_kraus",
    "channel_ptm",
    "compile_graph",
    "contract",
    "density_matrix_tensornetworkstate",
    "edge_color",
    "entanglement",
    "expect",
    "full_update",
    "gate_matrix",
    "gauge_and_scale",
    "heavy_hexagonal_lattice",
    "heisenberg_expectation",
    "ibm_eagle_lattice",
    "identitytensornetworkstate",
    "imaginary_time_kraus",
    "Index",
    "inner",
    "kraus_to_ptm",
    "local_expectations",
    "make_expectation_fn",
    "make_hermitian",
    "make_layer_fn",
    "named_comb_tree",
    "named_grid",
    "named_hexagonal_lattice_graph",
    "named_path_graph",
    "NamedEdge",
    "NamedGraph",
    "norm",
    "norm_sqr",
    "normalize",
    "op_matrix",
    "pauli_expectation",
    "paulitensornetworkstate",
    "purity",
    "QuadraticForm",
    "random_tensornetwork",
    "random_tensornetworkstate",
    "rdm",
    "reduced_density_matrix",
    "seed",
    "select_device",
    "set_default_device",
    "simple_update",
    "siteinds",
    "state_vector",
    "symmetric_gauge",
    "symmetrize_and_bpnormalize",
    "symmetrize_and_normalize",
    "Tensor",
    "TensorNetwork",
    "TensorNetworkState",
    "tensornetworkstate",
    "zerostate",
]
