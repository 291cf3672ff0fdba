"""PyTorch + CUDA port of the batched tensor-network quantum simulator.

The counterpart of ``tensornetworkquantumsimulator_tpu`` (JAX on a TPU),
which stays the reference.  This package covers the single-device batched
path: lattice → slot tables → product state → compiled layer (flooding BP
+ fused colour-group simple update) → BP ⟨Z⟩, and the measurement half
in ``parallel`` (Vidal gauge, truncation, overlaps, samplers, path
correlators, boundary MPS, certified sampling).  Its
Pallas kernels are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use.  The package imports ``torch`` and never ``jax``.
Its entry points run on CUDA unless asked for another device
(``device=``, or :func:`set_default_device`).
"""

from .devices import select_device, set_default_device
from .models import gate_matrix, op_matrix, state_vector
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


__all__ = [
    "BatchedCircuit",
    "BatchedState",
    "NamedEdge",
    "NamedGraph",
    "batched_product_state",
    "bp_update",
    "compile_graph",
    "edge_color",
    "gate_matrix",
    "heavy_hexagonal_lattice",
    "ibm_eagle_lattice",
    "local_expectations",
    "make_expectation_fn",
    "make_layer_fn",
    "named_grid",
    "op_matrix",
    "select_device",
    "set_default_device",
    "state_vector",
]
