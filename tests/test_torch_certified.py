"""PyTorch port, certified boundary-MPS sampling against the JAX package
(``parallel/certified_sampling.py``) on the same numpy inputs.

The random streams of the two packages cannot match, so the bitstrings the
JAX sampler drew are forced through the port's draw hook and ``logq`` and
``log_poverq`` are compared.  The JAX sampler accumulates both in float32
whatever the state's dtype, so that comparison holds to 5e-5 on values of
order 10; what the port computes in complex128 is held to 1e-8 against a
dense oracle instead (at ranks that hold the whole interface q(x) is the
exact Born probability and p/q = ⟨ψ|ψ⟩).  The fitted and truncated strands
differ between the packages by a gauge; only these scalars compare."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch.parallel import (
    certified_sampling as t_cert,
)
from tensornetworkquantumsimulator_tpu.parallel import (
    certified_sampling as j_cert,
)

import measure_states as ms

torch.set_num_threads(1)
_F32_ACCUMULATION = 5e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _log_born(psi, bits):
    """log(|⟨x|ψ⟩|²) for bitstrings [S, V] of a dense state."""
    return np.log(np.abs(np.array([psi[tuple(b)] for b in bits])) ** 2)


def test_grid_sampler_matches_jax_on_its_bitstrings(monkeypatch):
    jspec, jstate, tspec, tensors, _ = ms.converged("grid3x3", 2)
    kw = dict(norm_rank=4, projected_rank=4, niters=8)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    bits_j, logq_j, lpq_j = j_cert.make_grid_certified_sampler(
        jspec, 3, 3, **kw)(jstate.tensors, keys)
    bits_j = np.asarray(bits_j)
    forced = ms.ForcedDraws(bits_j.reshape(4, -1))  # row-major = call order
    monkeypatch.setattr(t_cert, "_draw", forced)
    bits, logq, lpq = tp.make_grid_certified_sampler(tspec, 3, 3, **kw)(
        torch.from_numpy(tensors), 4)
    assert bits.shape == (4, 3, 3) and bits.dtype == torch.int64
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    assert logq.dtype == torch.float64 and lpq.dtype == torch.float64
    np.testing.assert_allclose(logq.numpy(), np.asarray(logq_j),
                               atol=_F32_ACCUMULATION)
    np.testing.assert_allclose(lpq.numpy(), np.asarray(lpq_j),
                               atol=_F32_ACCUMULATION)
    # logq telescopes the conditionals that were offered
    probs = torch.stack(forced.probs, dim=1).numpy()  # [S, nx·W, d]
    taken = np.take_along_axis(probs, bits_j.reshape(4, -1, 1), -1)[..., 0]
    np.testing.assert_allclose(np.log(taken).sum(-1), logq.numpy(),
                               atol=1e-10)
    # ranks (χ²=4 double layer, 4 single layer) hold a 3-wide interface:
    # the certificate is exact
    psi = ms.dense_statevector(tspec, tensors)
    log_norm = np.log(np.vdot(psi, psi).real)
    flat = bits_j.reshape(4, -1)
    np.testing.assert_allclose((lpq + logq).numpy(), _log_born(psi, flat),
                               atol=1e-8)
    np.testing.assert_allclose(lpq.numpy(), log_norm, atol=1e-8)


def test_planar_sampler_matches_jax_on_its_bitstrings(monkeypatch):
    jspec, jstate, tspec, tensors, _ = ms.converged("heavyhex1x1", 2)
    kw = dict(norm_rank=16, projected_rank=4, niters=8)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    bits_j, logq_j, lpq_j = j_cert.make_planar_certified_sampler(
        jspec, **kw)(jstate.tensors, keys)
    bits_j = np.asarray(bits_j)  # [S, V], spec.vertices order
    # the chain draws at every grid position, wires included (bit 0)
    pspec = tp.PlanarBMPSSpec(tspec)
    grid = np.zeros((3, pspec.nrows, pspec.W), np.int64)
    for i, (r, c) in pspec.rowcol.items():
        grid[:, r, c] = bits_j[:, i]
    forced = ms.ForcedDraws(grid.reshape(3, -1))
    monkeypatch.setattr(t_cert, "_draw", forced)
    bits, logq, lpq = tp.make_planar_certified_sampler(tspec, **kw)(
        torch.from_numpy(tensors), 3)
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    np.testing.assert_allclose(logq.numpy(), np.asarray(logq_j),
                               atol=_F32_ACCUMULATION)
    np.testing.assert_allclose(lpq.numpy(), np.asarray(lpq_j),
                               atol=_F32_ACCUMULATION)
    # a wire offers bit 0 with probability 1
    probs = torch.stack(forced.probs, dim=1).numpy().reshape(
        3, pspec.nrows, pspec.W, -1)
    wires = pspec.vid < 0
    np.testing.assert_allclose(probs[:, wires, 0], 1.0, atol=1e-12)
    # the ring at these ranks is contracted exactly
    psi = ms.dense_statevector(tspec, tensors)
    np.testing.assert_allclose((lpq + logq).numpy(), _log_born(psi, bits_j),
                               atol=1e-8)
    np.testing.assert_allclose(lpq.numpy(), np.log(np.vdot(psi, psi).real),
                               atol=1e-8)


@pytest.mark.parametrize("dtype,atol", [(np.complex128, 1e-10),
                                        (np.complex64, 1e-5)])
def test_product_state_certified(dtype, atol):
    tspec = ms.port_state("grid3x3", 2)[0]
    want = (np.arange(9) % 2).reshape(3, 3)
    tensors = ms.product_peps(tspec, np.eye(2)[want.reshape(-1)], dtype=dtype)
    sampler = tp.make_grid_certified_sampler(tspec, 3, 3, norm_rank=4,
                                             projected_rank=4)
    bits, logq, lpq = sampler(torch.from_numpy(tensors), 3, _gen(0))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.broadcast_to(want, (3, 3, 3)))
    # q(x) = 1 for a product state, and p/q = |⟨x|ψ⟩|² = 1
    np.testing.assert_allclose(logq.numpy(), 0.0, atol=atol)
    np.testing.assert_allclose(lpq.numpy(), 0.0, atol=atol)


def test_ghz_certified():
    tspec = ms.port_state("grid3x3", 2)[0]
    sampler = tp.make_grid_certified_sampler(tspec, 3, 3, norm_rank=4,
                                             projected_rank=4)
    bits, logq, lpq = sampler(torch.from_numpy(ms.ghz_peps(tspec)), 8,
                              _gen(1))
    for row in bits.numpy().reshape(8, -1):
        assert (row == row[0]).all()
    # each branch has Born probability 1/2; p/q is ⟨ψ|ψ⟩ = 2 throughout
    np.testing.assert_allclose(logq.numpy(), np.log(0.5), atol=1e-10)
    np.testing.assert_allclose(np.exp(lpq.numpy()), 2.0, rtol=1e-10)


def test_one_seed_gives_the_same_samples_twice():
    _, _, tspec, tensors, _ = ms.converged("grid3x3", 2)
    t = torch.from_numpy(tensors)
    sampler = tp.make_grid_certified_sampler(tspec, 3, 3, norm_rank=4,
                                             projected_rank=4, niters=6)
    a = sampler(t, 6, _gen(11))
    b = sampler(t, 6, _gen(11))
    c = sampler(t, 6, _gen(12))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert not np.array_equal(a[0].numpy(), c[0].numpy())
    assert set(np.unique(a[0].numpy())) <= {0, 1}


def test_truncated_ranks_spread_the_certificate_in_complex64():
    """Ranks below the interface's: q is approximate, p/q spreads but stays
    finite and near ⟨ψ|ψ⟩; complex64 throughout."""
    _, _, tspec, tensors, _ = ms.converged("grid3x4", 3)
    psi = ms.dense_statevector(tspec, tensors)
    t = torch.from_numpy(tensors.astype(np.complex64))
    bits, logq, lpq = tp.make_grid_certified_sampler(
        tspec, 3, 4, norm_rank=6, projected_rank=6, niters=6)(t, 8, _gen(3))
    assert logq.dtype == torch.float32 and lpq.dtype == torch.float32
    assert torch.isfinite(logq).all() and torch.isfinite(lpq).all()
    assert float(lpq.std()) > 1e-6
    np.testing.assert_allclose(lpq.numpy(), np.log(np.vdot(psi, psi).real),
                               atol=0.5)


def _contract_strand(ts):
    """A single-layer strand [W, A, p, B] with pinned end bonds as a dense
    tensor [p]*W."""
    out = ts[0][0]  # [p, B]
    for t in ts[1:]:
        out = np.tensordot(out, t, axes=(-1, 0))
    return out[..., 0]


@pytest.mark.parametrize("dtype,atol", [(np.complex128, 1e-8),
                                        (np.complex64, 1e-4)])
def test_single_truncate_of_padded_strands(dtype, atol):
    """Strands narrower than the target rank are zero-padded to it, and one
    of them has exactly equal columns (every entry 1): the inputs on which
    a batched QR of small complex matrices returns NaN on CUDA.  The result
    is finite, unit-normalized, reproduces the input strand at rank K ≥ its
    own, and its logged norm is the JAX function's."""
    rng = np.random.default_rng(4)
    S, W, A, p, K = 3, 4, 2, 2, 4
    strand = (rng.standard_normal((S, W, A, p, A))
              + 1j * rng.standard_normal((S, W, A, p, A)))
    strand[1] = 1.0  # equal columns throughout
    strand[2, :, 1:] = 0.0  # a bond-1 strand inside the buffer
    strand[2, :, :, :, 1:] = 0.0
    strand = strand.astype(dtype)
    out, log_norm = t_cert._single_truncate(torch.from_numpy(strand), K)
    assert out.shape == (S, W, K, p, K)
    assert torch.isfinite(torch.view_as_real(out)).all()
    assert torch.isfinite(log_norm).all()
    for s in range(S):
        _, j_ln = j_cert._single_truncate(
            jnp.asarray(strand[s].astype(np.complex128)), K)
        np.testing.assert_allclose(float(log_norm[s]), float(j_ln), atol=atol)
        dense_in = _contract_strand(strand[s].astype(np.complex128))
        dense_out = _contract_strand(out[s].numpy().astype(np.complex128))
        np.testing.assert_allclose(
            np.linalg.norm(dense_out), 1.0, atol=atol)
        np.testing.assert_allclose(
            dense_out * np.exp(float(log_norm[s])) / np.abs(dense_in).max(),
            dense_in / np.abs(dense_in).max(), atol=atol)


def test_long_rows_stay_finite_in_complex64(monkeypatch):
    """The converged 3×4 χ=3 grid with every tensor scaled by 1e-6, so its
    double-layer environments span 1e-48 and underflow 32 bits: with the
    JAX package's complex128 draws forced, the port's complex64 sampler
    keeps every environment, R factor and carry at unit norm with its scale
    logged, and reads the JAX complex128 run's conditionals (logq) and p/q
    on the same tensors.  The JAX package's complex64 sampler reads NaN
    here."""
    jspec, _, tspec, tensors, _ = ms.converged("grid3x4", 3)
    small = tensors * 1e-6
    kw = dict(norm_rank=6, projected_rank=6, niters=6)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    j_sampler = j_cert.make_grid_certified_sampler(jspec, 3, 4, **kw)
    bits_j, logq_j, lpq_j = j_sampler(jnp.asarray(small), keys)
    bits_j = np.asarray(bits_j)
    assert np.isfinite(logq_j).all() and np.isfinite(lpq_j).all()
    monkeypatch.setattr(t_cert, "_draw", ms.ForcedDraws(bits_j.reshape(4, -1)))
    bits, logq, lpq = tp.make_grid_certified_sampler(tspec, 3, 4, **kw)(
        torch.from_numpy(small).to(torch.complex64), 4)
    assert torch.isfinite(logq).all() and torch.isfinite(lpq).all()
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    np.testing.assert_allclose(logq.numpy(), np.asarray(logq_j), atol=1e-4)
    np.testing.assert_allclose(lpq.numpy(), np.asarray(lpq_j), atol=1e-3)
    _, logq_j64, lpq_j64 = j_sampler(jnp.asarray(small, jnp.complex64), keys)
    assert np.isnan(np.asarray(logq_j64)).all()
    assert np.isnan(np.asarray(lpq_j64)).all()
