"""PyTorch port, the public surface: the names of the port's root,
``utils`` and ``parallel`` equal the JAX package's, less only
``shard_map_novma`` (a switch of JAX's own checker, not ported) and plus a
stated list of the port's own; the reference's export list resolves; and
the ``api.py`` delegates behave as the JAX package's do."""

import types

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import utils as tu
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu import utils as ju

torch.set_num_threads(1)

# JAX's names with no counterpart in the port
_NOT_PORTED = {"shard_map_novma"}
# the port's own names: device selection, names the batched port
# re-exports one level up, and the sharded engine's device mesh, sharded
# state and traffic counter
_PORT_ONLY = {
    "root": {"BatchedCircuit", "BatchedState", "batched_product_state",
             "bp_update", "compile_graph", "gate_matrix",
             "ibm_eagle_lattice", "local_expectations",
             "make_expectation_fn", "make_layer_fn", "op_matrix",
             "select_device", "set_default_device", "state_vector"},
    "utils": set(),
    "parallel": {"FieldLayer", "GraphTables", "GridBMPSSpec", "TrotterLayer",
                 "bond_rdms", "edge_scalars",
                 "energy", "graph_tables", "identity_strand", "loop_weights",
                 "loopcorrected_partitionfunction", "rescale",
                 "sandwich_logz", "sandwich_sweeps", "ShardMesh",
                 "ShardedState", "state_from_numpy", "state_to_numpy",
                 "Traffic", "vertex_scalars"},
}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _names(m):
    """Public names, less submodules (which of those show depends on what
    the process has imported)."""
    return {n for n in dir(m) if not n.startswith("_")
            and not isinstance(getattr(m, n), types.ModuleType)}


@pytest.mark.parametrize("where,jm,tm", [("root", tnqs, tt),
                                         ("utils", ju, tu),
                                         ("parallel", jp, tp)])
def test_public_names_equal_jax_less_sharded(where, jm, tm):
    want = _names(jm) - _NOT_PORTED
    assert _names(tm) - _PORT_ONLY[where] == want
    assert _PORT_ONLY[where] <= _names(tm)
    assert not _NOT_PORTED & _names(tm)


def test_all_lists_jax_names():
    assert set(tnqs.__all__) <= set(tt.__all__)
    assert all(hasattr(tt, n) for n in tt.__all__)


def test_reference_export_list_resolves():
    """Every symbol the reference exports
    (`src/TensorNetworkQuantumSimulator.jl:36-113`) has a top-level
    counterpart (as ``tests/test_api_surface.py`` checks for JAX)."""
    reference_exports = """
        vertices edges add_edge degree apply_gates apply_circuit rem_vertex
        truncate expect is_tree expect_boundarymps expect_loopcorrect
        make_hermitian ket_network maxvirtualdim siteinds edge_color
        zerostate named_grid sample TensorNetworkState tensornetworkstate
        random_tensornetworkstate BeliefPropagationCache rescale message
        network update symmetric_gauge messages gauge_and_scale
        paulitensornetworkstate identitytensornetworkstate
        random_tensornetwork inner named_comb_tree
        named_hexagonal_lattice_graph named_path_graph neighbors center
        NamedGraph graph datatype scalartype BoundaryMPSCache TensorNetwork
        AbstractTensorNetwork partitionfunction contract norm_sqr
        map_virtualinds map_tensors normalize QuadraticForm BilinearForm
        sample_certified sample_directly_certified vertextype virtualind
        virtualinds nv heavy_hexagonal_lattice entanglement
        build_graph_from_circuit reduced_density_matrix rdm
    """.split()
    assert [s for s in reference_exports if not hasattr(tt, s)] == []


def test_free_function_delegates():
    g = tt.named_grid((3, 2))
    psi = tt.random_tensornetworkstate(torch.float64, g, bond_dimension=2)
    assert set(tt.vertices(psi)) == set(psi.vertices())
    assert tt.nv(g) == 6 and tt.degree(g, (1, 1)) == 2
    assert not tt.is_tree(g) and tt.vertextype(g) is tuple
    assert tt.scalartype(psi) == tt.datatype(psi) == torch.float64
    assert set(tt.neighbors(g, (1, 1))) == set(g.neighbors((1, 1)))
    assert tt.center(tt.named_path_graph(5)) == [3]
    cache = tt.update(tt.BeliefPropagationCache(psi), maxiter=30,
                      tolerance=1e-12)
    np.testing.assert_allclose(complex(tt.partitionfunction(cache)),
                               complex(tt.norm_sqr(psi, alg="bp")), rtol=1e-8)
    e = tt.edges(psi)[0]
    assert tt.message(cache, e) is not None and len(tt.messages(cache)) > 0
    assert tt.network(cache) is not None
    np.testing.assert_allclose(
        complex(tt.partitionfunction(tt.rescale(cache))), 1.0, rtol=1e-8)
    g2 = tt.rem_vertex(g, (1, 1))
    assert g.nv() == 6 and g2.nv() == 5
    g3 = tt.add_edge(tt.named_path_graph(3), tt.NamedEdge(1, 3))
    assert g3.ne() == 3
    np.testing.assert_allclose(
        np.real(tt.expect_boundarymps(psi, ("Z", [(2, 1)]),
                                      mps_bond_dimension=8)),
        np.real(tt.expect(psi, ("Z", [(2, 1)]), alg="exact")), atol=1e-10)
    psi2 = tt.map_tensors(lambda t: t * 2.0, psi)
    np.testing.assert_allclose(tt.norm_sqr(psi2, alg="exact"),
                               tt.norm_sqr(psi, alg="exact") * 2.0 ** 12,
                               rtol=1e-9)
    psi3 = tt.map_virtualinds(lambda i: i.prime(), psi)
    assert all(i.plev == 1 for ee in psi3.edges()
               for i in psi3.virtualinds(ee))
    assert tt.maxvirtualdim(psi) == 2 and tt.virtualind(psi, e).dim == 2
    assert len(tt.virtualinds(psi, e)) == 1
    qf = tt.QuadraticForm(psi)
    assert tt.ket_network(qf) is qf.ket() and tt.graph(qf) == psi.graph()
