"""PyTorch port, whole slice: the compiled Trotter layer + BP ⟨Z⟩ against
the JAX package's `make_layer_fn` on the same circuits, and against the
independent dense-statevector oracle.

Both packages run LAPACK in double on the CPU for complex128, so only the
routines and the order of sums differ: per-site ⟨Z⟩ and the truncation
errors agree to 1e-8.  In complex64 the port runs the gram split and
CholeskyQR2 knobs (with TNQS_EIGH_ALG=jacobi its Jacobi wrappers take
their plain versions on the CPU) against the JAX default-eigh path: 1e-4,
the reference's band for the fast stack."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.models.sites import op_matrix
from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

from dense_oracle import dense_z_trajectory

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


_Z = op_matrix("Z", 2)
_KNOBS = ("TNQS_EIGH_ALG", "TNQS_SVD_ALG", "TNQS_QR_ALG", "TNQS_BP_KERNEL",
          "TNQS_ROOTS_FUSED", "TNQS_FUSE_BUCKETS")


def _tfim_layer(graphs, g, dt=0.25, hx=1.0, hz=0.8, J=0.5):
    """The bench's chi10/chi32 layer (bench.py:273-279)."""
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for ce in graphs.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in ce]
    return layer


def _kicked_ising_layer(graphs, g):
    """The bench's heavy-hex kicked-Ising layer (bench.py:264-271)."""
    layer = [("Rx", [v], 0.4) for v in g.vertices()]
    for group in graphs.edge_color(g, 3):
        layer += [("Rzz", pair, 2 * (3.14159 / 4)) for pair in group]
    return layer


_CASES = {
    "tfim_grid3x3": (lambda lat: lat.named_grid((3, 3)), _tfim_layer),
    "kicked_heavyhex2x2": (lambda lat: lat.heavy_hexagonal_lattice(2, 2),
                           _kicked_ising_layer),
}
_LAYER_KW = dict(chi=4, cutoff=1e-10, normalize_tensors=True, bp_maxiter=50)


def _run_jax(case, dtype, nlayers, bp_tol):
    make_graph, make_layer = _CASES[case]
    g = make_graph(j_lat)
    spec, state = jp.batched_product_state(g, chi=4, dtype=dtype)
    layer_fn = jp.make_layer_fn(
        jp.BatchedCircuit(make_layer(j_graphs, g), g, spec=spec),
        bp_tolerance=bp_tol, **_LAYER_KW,
    )
    zs, errs = [], []
    for _ in range(nlayers):
        state, err = layer_fn(state)
        errs.append(np.asarray(err))
        zs.append(np.real(np.asarray(jp.local_expectations(spec, state, _Z))))
    return np.array(zs), np.array(errs)


def _run_torch(case, dtype, nlayers, bp_tol):
    make_graph, make_layer = _CASES[case]
    g = make_graph(tt)
    spec, state = tt.batched_product_state(g, chi=4, dtype=dtype)
    layer_fn = tt.make_layer_fn(
        tt.BatchedCircuit(make_layer(tt, g), g, spec=spec),
        bp_tolerance=bp_tol, **_LAYER_KW,
    )
    zs, errs = [], []
    for _ in range(nlayers):
        state, err = layer_fn(state)
        errs.append(err.numpy())
        zs.append(tt.local_expectations(spec, state, _Z).real.numpy())
    return np.array(zs), np.array(errs)


@pytest.fixture
def default_knobs(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("case", sorted(_CASES))
def test_layers_match_jax_complex128(case, default_knobs):
    z_j, e_j = _run_jax(case, np.complex128, 3, 1e-12)
    z_t, e_t = _run_torch(case, torch.complex128, 3, 1e-12)
    assert np.abs(e_j).max() > 1e-11  # the χ=4 cap really truncates
    np.testing.assert_allclose(z_t, z_j, atol=1e-8)
    np.testing.assert_allclose(e_t, e_j, atol=1e-8)
    # the errors are small, so also hold them relatively: a double-precision
    # σ² of size s carries ~ε·σ²max/s relative rounding
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4, atol=1e-13)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fast_stack_matches_jax_complex64(case, default_knobs):
    z_j, _ = _run_jax(case, np.complex64, 3, None)
    default_knobs.setenv("TNQS_EIGH_ALG", "jacobi")
    default_knobs.setenv("TNQS_SVD_ALG", "gram")
    default_knobs.setenv("TNQS_QR_ALG", "cholqr2")
    default_knobs.setenv("TNQS_BP_KERNEL", "1")
    z_t, e_t = _run_torch(case, torch.complex64, 3, None)
    assert np.isfinite(z_t).all() and np.isfinite(e_t).all()
    np.testing.assert_allclose(z_t, z_j, atol=1e-4)


def test_tfim_3x3_vs_dense_oracle(default_knobs):
    """`tests/test_golden.py::test_tfim_3x3_batched_vs_dense` on the port:
    3 layers at χ=8, cutoff 0 (no truncation), BP ⟨Z⟩ within the loopy
    graph's physical BP error of the exact trajectory."""
    g = tt.named_grid((3, 3))
    layer = _tfim_layer(tt, g)
    golden = dense_z_trajectory(g, layer, 3, (2, 2))
    spec, state = tt.batched_product_state(g, chi=8, dtype=torch.complex128)
    layer_fn = tt.make_layer_fn(
        tt.BatchedCircuit(layer, g, spec=spec), chi=8, cutoff=0.0,
        normalize_tensors=False, bp_maxiter=100, bp_tolerance=1e-14,
    )
    z_fn = tt.make_expectation_fn(spec, _Z, real_output=True)
    pos = spec.vertex_position((2, 2))
    traj = []
    for _ in range(3):
        state, errs = layer_fn(state)
        assert float(errs.max()) < 1e-12
        traj.append(float(z_fn(state)[pos]))
    np.testing.assert_allclose(traj, golden, atol=5e-5)


_BOND_CASES = {
    # (lattice, dtype): the reference test's float64 grid, and a degree-3
    # lattice whose edges fall into several (slot_u, slot_v) buckets
    "grid3x3_float64": (lambda lat: lat.named_grid((3, 3)), np.float64),
    "heavyhex1x1_complex128": (lambda lat: lat.heavy_hexagonal_lattice(1, 1),
                               np.complex128),
}


@pytest.mark.parametrize("case", sorted(_BOND_CASES))
def test_bond_observables_match_jax(case):
    """`tests/test_batched.py::test_batched_bond_expectations` on the port:
    a random χ=3 state carried across, BP run by each package, then
    ⟨Z⊗Z⟩ on every edge and the bond RDMs, in ``spec.edges`` order."""
    from tensornetworkquantumsimulator_tpu import random_tensornetworkstate

    make_graph, dtype = _BOND_CASES[case]
    g = make_graph(j_lat)
    psi = random_tensornetworkstate(dtype, g, bond_dimension=3)
    spec_j, st_j = jp.batched_from_tns(psi, chi=3)
    spec_t = tt.compile_graph(make_graph(tt))
    st_t = tt.parallel.state_from_numpy(np.asarray(st_j.tensors),
                                        np.asarray(st_j.messages))
    st_j = jp.bp_update(spec_j, st_j, maxiter=150, tolerance=1e-14)
    st_t = tt.bp_update(spec_t, st_t, maxiter=150, tolerance=1e-14)

    zz_j = np.asarray(jp.bond_expectations(spec_j, st_j, _Z, _Z))
    zz_t = tt.parallel.bond_expectations(spec_t, st_t, _Z, _Z).numpy()
    assert zz_t.shape == (len(spec_t.edges),)
    np.testing.assert_allclose(zz_t, zz_j, atol=1e-8)

    rho_j = np.asarray(jp.engine.bond_rdms(spec_j, st_j))
    rho_t = tt.parallel.bond_rdms(spec_t, st_t).numpy()
    np.testing.assert_allclose(rho_t, rho_j, atol=1e-8)
    # the RDMs and the expectations are one contraction read two ways
    zz = np.einsum("esxcy,xs,yc->e", rho_t, _Z, _Z)
    np.testing.assert_allclose(zz, zz_t, atol=1e-10)
