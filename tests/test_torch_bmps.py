"""PyTorch port, boundary MPS against the JAX package
(``parallel/boundarymps.py``) on the same numpy inputs.

The fitted strands carry the QR's column phases, so they differ between the
two packages by a gauge; compared are the gauge-free outputs: ``log_z`` and
``exp(i·phase)`` of the norm, ⟨op⟩, correlators and the extracted scales λ,
complex128 at 1e-8 with ``tolerance=None`` (a fixed number of sweeps: a
sweep count decided on a threshold may differ by one between the packages);
complex64 against complex128 at 1e-4.  At an MPS rank that holds the whole
interface the contraction is exact and is held against a dense oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch.parallel import boundarymps as t_bmps
from tensornetworkquantumsimulator_tpu.parallel import boundarymps as j_bmps

import measure_states as ms

torch.set_num_threads(1)
_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Z = np.diag([1.0, -1.0])
_FIXED = dict(niters=4, tolerance=None)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _unit(phase):
    return np.exp(1j * float(phase))


def _grid(lattice, chi):
    jspec, jstate, tspec, tensors, _ = ms.converged(lattice, chi)
    nx, ny = (int(c) for c in lattice[4:].split("x"))
    return jspec, jstate.tensors, tspec, torch.from_numpy(tensors), nx, ny


def test_role_tables_and_row_tensors_match_jax():
    jspec, jt, tspec, t, nx, ny = _grid("grid3x4", 3)
    jg, tg = j_bmps.GridBMPSSpec(jspec, nx, ny), tp.GridBMPSSpec(tspec, nx, ny)
    np.testing.assert_array_equal(tg.perm, jg.perm)
    for r in range(nx):
        np.testing.assert_array_equal(tg.row_tensors(t, r).numpy(),
                                      np.asarray(jg.row_tensors(jt, r)))
    with pytest.raises(ValueError):
        tp.GridBMPSSpec(tspec, 4, 4)


@pytest.mark.parametrize("lattice", ["heavyhex1x1", "heavyhex2x2"])
def test_planar_tables_and_row_tensors_match_jax(lattice):
    jspec, jstate, tspec, tensors, _ = ms.converged(lattice, 2)
    jp_, tp_ = j_bmps.PlanarBMPSSpec(jspec), tp.PlanarBMPSSpec(tspec)
    assert (tp_.nrows, tp_.W) == (jp_.nrows, jp_.W)
    np.testing.assert_array_equal(tp_.vid, jp_.vid)
    assert tp_.rowcol == jp_.rowcol and tp_.role_slot == jp_.role_slot
    assert (tp_.vid < 0).any()  # the lattice really has wire positions
    t = torch.from_numpy(tensors)
    for r in range(tp_.nrows):
        np.testing.assert_array_equal(
            tp_.row_tensors(t, r).numpy(),
            np.asarray(jp_.row_tensors(jstate.tensors, r)))
    # columns derived from the graph alone: the same assignment, and a
    # feasible one
    cols = tp.derive_planar_columns(tspec)
    assert cols == j_bmps.derive_planar_columns(jspec)
    derived = tp.PlanarBMPSSpec(tspec, col_of=lambda v: cols[v])
    assert derived.nrows == tp_.nrows


def test_identity_strand_and_fit_scale_match_jax():
    """One strand fit of the first row: λ and the fitted strand's overlap
    with itself are gauge-free."""
    jspec, jt, tspec, t, nx, ny = _grid("grid3x3", 3)
    K = 5
    m0 = tp.identity_strand(ny, K, 3, torch.complex128, "cpu")
    jm0 = j_bmps.identity_strand(ny, K, 3, np.complex128)
    np.testing.assert_array_equal(m0.numpy(), np.asarray(jm0))
    row = tp.GridBMPSSpec(tspec, nx, ny).row_tensors(t, 0)
    jrow = j_bmps.GridBMPSSpec(jspec, nx, ny).row_tensors(jt, 0)
    n, lam = t_bmps._fit_strand(row, m0, m0, 3, None, return_scale=True)
    jn, jlam = j_bmps._fit_strand(jrow, jm0, jm0, 3, None, return_scale=True)
    np.testing.assert_allclose(float(lam), float(jlam), rtol=1e-10)
    np.testing.assert_allclose(
        complex(t_bmps._edge_scalar(n, n.conj())),
        complex(j_bmps._edge_scalar(jn, jnp.conj(jn))), atol=1e-8)
    # left-canonical with a normalized centre: ⟨N|N⟩ = 1
    np.testing.assert_allclose(complex(t_bmps._edge_scalar(n, n.conj())),
                               1.0, atol=1e-10)


@pytest.mark.parametrize("lattice,kmps", [("grid3x3", 4), ("grid3x4", 6)])
def test_grid_bmps_matches_jax(lattice, kmps):
    jspec, jt, tspec, t, nx, ny = _grid(lattice, 3)
    j_norm, j_expect = j_bmps.make_grid_bmps(jspec, nx, ny, kmps, **_FIXED)
    norm, expect = tp.make_grid_bmps(tspec, nx, ny, kmps, **_FIXED)
    log_z, phase = norm(t)
    j_log_z, j_phase = j_norm(jt)
    np.testing.assert_allclose(float(log_z), float(j_log_z), atol=1e-8)
    np.testing.assert_allclose(_unit(phase), _unit(j_phase), atol=1e-8)
    z = expect(t, _Z)
    assert z.shape == (nx * ny,) and z.dtype == torch.float64
    np.testing.assert_allclose(z.numpy(), np.asarray(j_expect(jt, jnp.asarray(
        _Z, jnp.complex128))), atol=1e-8)


@pytest.mark.parametrize("tolerance", [None, "auto"])
def test_grid_bmps_exact_at_full_rank(tolerance):
    """χ=2 on 3×3: an MPS bond of χ² = 4 holds the interface, so the
    boundary MPS is the exact contraction."""
    _, _, tspec, t, nx, ny = _grid("grid3x3", 2)
    psi = ms.dense_statevector(tspec, t.numpy())
    norm, expect = tp.make_grid_bmps(tspec, nx, ny, 4, niters=8,
                                     tolerance=tolerance)
    log_z, phase = norm(t)
    np.testing.assert_allclose(float(log_z), np.log(np.vdot(psi, psi).real),
                               atol=1e-8)
    np.testing.assert_allclose(_unit(phase), 1.0, atol=1e-8)
    np.testing.assert_allclose(expect(t, _Z).numpy(),
                               ms.dense_site_expectations(psi, _Z), atol=1e-8)


def test_planar_bmps_matches_jax_and_the_dense_state():
    jspec, jstate, tspec, tensors, _ = ms.converged("heavyhex1x1", 2)
    t = torch.from_numpy(tensors)
    kw = dict(niters=6, tolerance=None)
    j_norm, j_expect = j_bmps.make_planar_bmps(jspec, 4, **kw)
    norm, expect = tp.make_planar_bmps(tspec, 4, **kw)
    log_z, phase = norm(t)
    j_log_z, j_phase = j_norm(jstate.tensors)
    np.testing.assert_allclose(float(log_z), float(j_log_z), atol=1e-8)
    np.testing.assert_allclose(_unit(phase), _unit(j_phase), atol=1e-8)
    x = expect(t, _X)
    np.testing.assert_allclose(
        x.numpy(), np.asarray(j_expect(jstate.tensors, jnp.asarray(
            _X, jnp.complex128))), atol=1e-8)
    # a ring of 12 qubits at χ=2: two bonds cross each interface, so rank
    # (χ²)² = 16 is exact
    norm, expect = tp.make_planar_bmps(tspec, 16, **kw)
    psi = ms.dense_statevector(tspec, tensors)
    np.testing.assert_allclose(float(norm(t)[0]),
                               np.log(np.vdot(psi, psi).real), atol=1e-10)
    np.testing.assert_allclose(expect(t, _X).numpy(),
                               ms.dense_site_expectations(psi, _X), atol=1e-8)


_PAIRS = [((1, 1), (1, 3)), ((2, 1), (2, 2)), ((1, 2), (3, 2)),
          ((1, 1), (3, 3)), ((3, 1), (1, 2)), ((2, 2), (3, 3))]


def test_grid_bmps_correlations_match_jax_and_the_dense_state():
    jspec, jt, tspec, t, nx, ny = _grid("grid3x3", 2)
    kw = dict(niters=6, tolerance=None)
    ref = j_bmps.make_grid_bmps_correlations(jspec, nx, ny, 4, _PAIRS, **kw)(
        jt, jnp.asarray(_Z, jnp.complex128), jnp.asarray(_X, jnp.complex128))
    fn = tp.make_grid_bmps_correlations(tspec, nx, ny, 4, _PAIRS, **kw)
    got = fn(t, _Z, _X)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)
    psi = ms.dense_statevector(tspec, t.numpy())
    pos = tspec.vertex_position
    dense = [ms.dense_pair_expectation(psi, _Z, pos(a), _X, pos(b))
             for a, b in _PAIRS]
    np.testing.assert_allclose(got.numpy(), dense, atol=1e-8)
    real = tp.make_grid_bmps_correlations(tspec, nx, ny, 4, _PAIRS,
                                          real_output=True, **kw)(t, _Z, _X)
    assert real.dtype == torch.float64
    with pytest.raises(ValueError):
        tp.make_grid_bmps_correlations(tspec, nx, ny, 4, [((1, 1), (1, 1))])


def test_planar_bmps_correlations_match_jax():
    jspec, jstate, tspec, tensors, _ = ms.converged("heavyhex1x1", 2)
    vs = tspec.vertices
    pairs = [(vs[0], vs[-1]), (vs[0], vs[1]), (vs[2], vs[7]), (vs[-1], vs[3])]
    kw = dict(niters=5, tolerance=None)
    ref = j_bmps.make_planar_bmps_correlations(jspec, 4, pairs, **kw)(
        jstate.tensors, jnp.asarray(_Z, jnp.complex128),
        jnp.asarray(_Z, jnp.complex128))
    got = tp.make_planar_bmps_correlations(tspec, 4, pairs, **kw)(
        torch.from_numpy(tensors), _Z, _Z)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)


def test_grid_bmps_complex64_within_band():
    _, _, tspec, t, nx, ny = _grid("grid3x3", 3)
    fns = tp.make_grid_bmps(tspec, nx, ny, 6, niters=6)
    t32 = t.to(torch.complex64)
    log_z, phase = fns[0](t32)
    ref_log_z, ref_phase = fns[0](t)
    assert log_z.dtype == torch.float32
    np.testing.assert_allclose(float(log_z), float(ref_log_z), atol=1e-4)
    np.testing.assert_allclose(_unit(phase), _unit(ref_phase), atol=1e-4)
    z = fns[1](t32, _Z)
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), fns[1](t, _Z).numpy(), atol=1e-4)


def test_bmps_is_closer_to_the_dense_state_than_bp():
    """The reason to run it: on a loopy state the boundary MPS recovers what
    BP's tree approximation loses."""
    _, _, tspec, tensors, messages = ms.converged("grid3x3", 3)
    psi = ms.dense_statevector(tspec, tensors)
    exact = ms.dense_site_expectations(psi, _Z)
    state = tp.state_from_numpy(tensors, messages)
    bp = tp.local_expectations(tspec, state, _Z).real.numpy()
    bmps = tp.make_grid_bmps(tspec, 3, 3, 9, niters=8)[1](state.tensors, _Z)
    assert np.abs(bp - exact).max() > 1e-3
    np.testing.assert_allclose(bmps.numpy(), exact, atol=1e-8)


def test_long_rows_stay_finite_in_complex64():
    """A state whose double-layer environments underflow 32 bits (the
    converged 3×4 χ=3 grid, every tensor scaled by 1e-6, so a row's
    environment spans 1e-48): the port keeps each environment and row
    carry at unit norm with its scale as a float64 logarithm, so its
    complex64 ⟨Z⟩ and log|Z| are the JAX package's complex128 ones on the
    same tensors, at the complex64 band, and ⟨Z⟩ is the unscaled state's
    while log|Z| moves by exactly 2·V·log(1e-6).  The JAX package's
    complex64 evaluators read NaN here (their environments reach zero),
    as they do on the 164-qubit heavy-hex state of
    examples/heavyhex_ising_dynamics.py at its defaults."""
    jspec, jt, tspec, t, nx, ny = _grid("grid3x4", 3)
    scale = 1e-6
    small = t * scale
    small64 = small.to(torch.complex64)
    norm, expect = tp.make_grid_bmps(tspec, nx, ny, 6, **_FIXED)
    log_z_small, _ = norm(small64)
    z_small = expect(small64, _Z)
    assert torch.isfinite(z_small).all() and torch.isfinite(log_z_small)
    j_norm, j_expect = j_bmps.make_grid_bmps(jspec, nx, ny, 6, **_FIXED)
    j_small = jnp.asarray(small.numpy())
    np.testing.assert_allclose(
        z_small.numpy(), np.asarray(j_expect(j_small, jnp.asarray(_Z))),
        atol=1e-4)
    np.testing.assert_allclose(float(log_z_small), float(j_norm(j_small)[0]),
                               atol=1e-3)
    np.testing.assert_allclose(z_small.numpy(), expect(t, _Z).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(
        float(log_z_small) - 2 * tspec.num_vertices * np.log(scale),
        float(norm(t)[0]), atol=1e-3)
    assert np.isnan(np.asarray(j_expect(j_small.astype(jnp.complex64),
                                        jnp.asarray(_Z, jnp.complex64)))).all()
