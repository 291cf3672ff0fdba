"""PyTorch port, BP path correlators, string expectations, path RDMs and
mutual information against the JAX package (``parallel/correlations.py``)
on the same numpy inputs: complex128 at 1e-8, complex64 against complex128
at 1e-4.  Every output is a ratio of contractions, so nothing here depends
on a gauge."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_tpu.parallel import correlations as j_corr

import measure_states as ms

torch.set_num_threads(1)
_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Z = np.diag([1.0, -1.0])


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _pairs_from_first(spec):
    a = spec.vertices[len(spec.vertices) // 3]
    return [(a, v) for v in spec.vertices if v != a]


def _both(lattice, chi=3):
    jspec, jstate, tspec, tensors, messages = ms.converged(lattice, chi)
    return jspec, jstate, tspec, tp.state_from_numpy(tensors, messages)


@pytest.mark.parametrize("lattice", ["grid3x4", "heavyhex2x2"])
def test_shortest_paths_match_jax(lattice):
    jspec, _, tspec, _ = _both(lattice)
    for a, b in _pairs_from_first(tspec):
        assert tp.shortest_path(tspec, a, b) == j_corr.shortest_path(
            jspec, a, b)
    with pytest.raises(ValueError):
        tp.shortest_path(tspec, tspec.vertices[0], tspec.vertices[0])


@pytest.mark.parametrize("lattice", ["grid3x4", "heavyhex2x2"])
@pytest.mark.parametrize("connected", [False, True])
def test_path_correlations_match_jax(lattice, connected):
    jspec, jstate, tspec, state = _both(lattice)
    pairs = _pairs_from_first(tspec)
    ref = j_corr.make_path_correlation_fn(
        jspec, pairs, _Z, _X, connected=connected, jit=False)(jstate)
    got = tp.make_path_correlation_fn(
        tspec, pairs, _Z, _X, connected=connected)(state)
    assert got.shape == (len(pairs),) and got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)
    # the one-shot form and the real output
    one = tp.path_correlations(tspec, state, pairs, _Z, _X,
                               connected=connected, real_output=True)
    assert one.dtype == torch.float64
    np.testing.assert_allclose(one.numpy(), np.asarray(ref).real, atol=1e-8)


def test_distance_one_pairs_equal_bond_expectations():
    _, _, tspec, state = _both("grid3x4")
    pairs = [(tspec.vertices[iu], tspec.vertices[iv])
             for iu, iv, _, _ in tspec.edges]
    got = tp.make_path_correlation_fn(tspec, pairs, _Z, _X)(state)
    ref = tp.bond_expectations(tspec, state, _Z, _X)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-10)
    rdm = tp.make_path_rdm_fn(tspec, pairs)(state)
    np.testing.assert_allclose(rdm.numpy(), tp.bond_rdms(tspec, state).numpy(),
                               atol=1e-10)


def test_explicit_paths_are_honoured():
    """On a loopy graph the BP value depends on the path: the two ways round
    a plaquette differ, and each equals JAX's along the same path."""
    jspec, jstate, tspec, state = _both("grid3x4")
    pair = [((1, 1), (2, 2))]
    pos = tspec.vertex_position
    routes = []
    for mid in ((1, 2), (2, 1)):
        verts = [pos((1, 1)), pos(mid), pos((2, 2))]
        slots = [tspec.nbr[verts[i]].index(verts[i + 1]) for i in range(2)]
        routes.append((verts, slots))
    vals = []
    for route in routes:
        got = tp.make_path_correlation_fn(tspec, pair, _Z, paths=[route])(
            state)
        ref = j_corr.make_path_correlation_fn(
            jspec, pair, _Z, paths=[route], jit=False)(jstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)
        vals.append(complex(got[0]))
    assert abs(vals[0] - vals[1]) > 1e-6


@pytest.mark.parametrize("lattice", ["grid3x4", "heavyhex2x2"])
def test_string_expectations_match_jax(lattice):
    jspec, jstate, tspec, state = _both(lattice)
    vs = tspec.vertices
    far = tp.shortest_path(tspec, vs[0], vs[-1])[0]
    walk = [vs[i] for i in far]
    strings = [
        ("ZZ", [walk[0], walk[-1]]),
        ("ZXZ", [walk[0], walk[len(walk) // 2], walk[-1]]),
        ("XY" + "Z" * (len(walk) - 2), walk),
        ((_Z, _X), [walk[1], walk[2]]),
    ]
    ref = j_corr.make_string_expectation_fn(jspec, strings, jit=False)(jstate)
    got = tp.make_string_expectation_fn(tspec, strings)(state)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)
    one = tp.string_expectations(tspec, state, strings, real_output=True)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref).real, atol=1e-8)
    # a two-site string is the path correlator
    two = tp.path_correlations(tspec, state, [(walk[0], walk[-1])], _Z)
    np.testing.assert_allclose(got[0].numpy(), two[0].numpy(), atol=1e-10)
    with pytest.raises(ValueError):
        tp.make_string_expectation_fn(tspec, [("ZZZ", [walk[0], walk[1],
                                                       walk[0]])])


@pytest.mark.parametrize("lattice", ["grid3x4", "heavyhex2x2"])
def test_path_rdms_and_mutual_information_match_jax(lattice):
    jspec, jstate, tspec, state = _both(lattice)
    pairs = _pairs_from_first(tspec)
    rho = tp.make_path_rdm_fn(tspec, pairs)(state)
    rho_j = j_corr.make_path_rdm_fn(jspec, pairs, jit=False)(jstate)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), atol=1e-8)
    tr = torch.einsum("paabb->p", rho)
    np.testing.assert_allclose(tr.numpy(), 1.0, atol=1e-12)
    mi = tp.make_mutual_information_fn(tspec, pairs)(state)
    mi_j = j_corr.make_mutual_information_fn(jspec, pairs, jit=False)(jstate)
    assert mi.dtype == torch.float64
    np.testing.assert_allclose(mi.numpy(), np.asarray(mi_j), atol=1e-8)
    assert (mi.numpy() >= -1e-10).all()


def test_ghz_and_product_state_oracles():
    """GHZ: ⟨Z_a Z_b⟩ = 1 and I(a:b) = ln 2 at any distance; a product
    state: the correlator factorizes and I(a:b) = 0 (its marginals are
    pure, i.e. rank-deficient RDMs)."""
    tspec = ms.port_state("grid3x3", 2)[0]
    V, D = tspec.num_vertices, tspec.degree
    eye = np.broadcast_to(np.eye(2), (V, D, 2, 2)).astype(np.complex128)
    pairs = _pairs_from_first(tspec)
    ghz = tp.bp_update(tspec, tp.state_from_numpy(ms.ghz_peps(tspec), eye),
                       maxiter=100, tolerance=1e-14)
    zz = tp.path_correlations(tspec, ghz, pairs, _Z, real_output=True)
    np.testing.assert_allclose(zz.numpy(), 1.0, atol=1e-10)
    mi = tp.make_mutual_information_fn(tspec, pairs)(ghz)
    np.testing.assert_allclose(mi.numpy(), np.log(2.0), atol=1e-10)
    prod = tp.state_from_numpy(ms.product_peps(tspec, [0.8, 0.6j]), eye)
    zx = tp.path_correlations(tspec, prod, pairs, _Z, _X, connected=True)
    np.testing.assert_allclose(zx.numpy(), 0.0, atol=1e-12)
    for dtype in (np.complex128, np.complex64):
        st = tp.state_from_numpy(
            ms.product_peps(tspec, [0.8, 0.6j], dtype=dtype),
            eye.astype(dtype))
        mi = tp.make_mutual_information_fn(tspec, pairs)(st)
        np.testing.assert_allclose(mi.numpy(), 0.0, atol=1e-5)


def test_correlations_complex64_within_band():
    _, _, tspec, tensors, messages = ms.converged("grid3x4", 3)
    ref_state = tp.state_from_numpy(tensors, messages)
    state = tp.state_from_numpy(tensors.astype(np.complex64),
                                messages.astype(np.complex64))
    pairs = _pairs_from_first(tspec)
    fn = tp.make_path_correlation_fn(tspec, pairs, _Z, connected=True)
    got = fn(state)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), fn(ref_state).numpy(), atol=1e-4)
    mi_fn = tp.make_mutual_information_fn(tspec, pairs)
    np.testing.assert_allclose(mi_fn(state).numpy(), mi_fn(ref_state).numpy(),
                               atol=1e-4)
