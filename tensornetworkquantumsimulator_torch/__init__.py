"""PyTorch + CUDA port of the batched tensor-network quantum simulator.

The counterpart of ``tensornetworkquantumsimulator_tpu`` (JAX on a TPU),
which stays the reference.  This package covers the single-device batched
Trotter-layer path: lattice → slot tables → product state → compiled
layer (flooding BP + fused colour-group simple update) → BP ⟨Z⟩.  Its
Pallas kernels are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use.  The package imports ``torch`` and never ``jax``.
"""

import torch

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


def select_device(name: str = "cuda") -> torch.device:
    """The device to run on, with float32 matmuls at full precision: no
    TF32 in cuBLAS (complex GEMM included) or cuDNN, as the reference runs
    every einsum at ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device(name)


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
    "state_vector",
]
