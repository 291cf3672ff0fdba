"""PyTorch port, BP and density-matrix samplers against the JAX package
(``parallel/sampling.py``) on the same numpy inputs.

The two packages' random streams cannot match, so the bitstrings the JAX
sampler drew are forced through the port's draw hook (``sampling._draw``)
and what is compared is what the chain computed on the way: every
conditional probability and ``logps``, 1e-8 in complex128.  With the port's
own ``torch.Generator``: a product state gives its one bitstring, a GHZ
state only 0…0 and 1…1, and one seed gives the same bitstrings twice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch.parallel import sampling as t_smp
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import sampling as j_smp

import measure_states as ms

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _jax_bp_chain_probs(jspec, jstate, bits, refresh_iters):
    """The conditional probabilities the JAX sampler's chain offers along the
    given bitstrings [S, V]: its own step (``_local_rdm_at``, projection,
    ``bp_iteration`` refreshes) with the draw replaced by the given bit."""
    sweep = jax.jit(lambda t, m: jp.bp_iteration(jspec, jp.BatchedState(t, m)))
    out = []
    for row in np.asarray(bits):
        tensors, messages = jstate.tensors, jstate.messages
        probs = []
        for v, bit in enumerate(row):
            rho = j_smp._local_rdm_at(jspec, tensors, messages, v)
            p = jnp.clip(jnp.real(jnp.diagonal(rho)), 0.0, None)
            probs.append(np.asarray(p / jnp.sum(p)))
            proj = jax.nn.one_hot(int(bit), tensors.shape[-1],
                                  dtype=tensors.dtype)
            tensors = tensors.at[v].set(tensors[v] * proj)
            for _ in range(refresh_iters):
                messages = sweep(tensors, messages)
        out.append(probs)
    return np.asarray(out)  # [S, V, d]


@pytest.mark.parametrize("lattice", ["grid3x3", "heavyhex1x1"])
def test_bp_sampler_conditionals_match_jax_on_its_bitstrings(lattice,
                                                             monkeypatch):
    jspec, jstate, tspec, tensors, messages = ms.converged(lattice, 3)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    bits_j = np.asarray(j_smp.make_bp_sampler(jspec, refresh_iters=3)(
        jstate, keys))
    probs_j = _jax_bp_chain_probs(jspec, jstate, bits_j, 3)
    forced = ms.ForcedDraws(bits_j)
    monkeypatch.setattr(t_smp, "_draw", forced)
    bits = tp.make_bp_sampler(tspec, refresh_iters=3)(
        tp.state_from_numpy(tensors, messages), 3)
    assert bits.dtype == torch.int64
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    probs = torch.stack(forced.probs, dim=1).numpy()  # [S, V, d]
    np.testing.assert_allclose(probs, probs_j, atol=1e-8)
    # the JAX sampler drew from these very conditionals: none it took is 0
    taken = np.take_along_axis(probs, bits_j[..., None], axis=-1)
    assert (taken > 1e-6).all()


def _d4_state():
    return ms.converged("grid3x3", 2, 0, d=4, amp=0.1)


def test_rho_sampler_logps_match_jax_on_its_bitstrings(monkeypatch):
    jspec, jstate, tspec, tensors, messages = _d4_state()
    kw = dict(refresh_iters=4, init_maxiter=300, tolerance=1e-14)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    bits_j, logps_j = j_smp.make_rho_sampler(
        jspec, 2, jnp.complex128, jit=False, **kw)(jstate, keys)
    bits_j = np.asarray(bits_j)
    forced = ms.ForcedDraws(bits_j)
    monkeypatch.setattr(t_smp, "_draw", forced)
    bits, logps = tp.make_rho_sampler(tspec, 2, torch.complex128, **kw)(
        tp.state_from_numpy(tensors, messages), 4)
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    assert logps.dtype == torch.float64
    np.testing.assert_allclose(logps.numpy(), np.asarray(logps_j), atol=1e-8)
    # logps telescopes the conditionals that were offered
    probs = torch.stack(forced.probs, dim=1).numpy()
    taken = np.take_along_axis(probs, bits_j[..., None], axis=-1)[..., 0]
    np.testing.assert_allclose(np.log(taken).sum(-1), logps.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-12)


def _bp_state(spec, tensors):
    V, D, chi = spec.num_vertices, spec.degree, tensors.shape[1]
    state = tp.state_from_numpy(
        tensors, np.broadcast_to(np.eye(chi), (V, D, chi, chi)).astype(
            tensors.dtype))
    return tp.bp_update(spec, state, maxiter=100)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_product_state_samples_its_one_bitstring(dtype):
    tspec = ms.port_state("grid3x3", 2)[0]
    V = tspec.num_vertices
    want = np.arange(V) % 2  # a checkerboard-like basis state
    state = _bp_state(tspec, ms.product_peps(tspec, np.eye(2)[want],
                                             dtype=dtype))
    bits = tp.make_bp_sampler(tspec, refresh_iters=2)(state, 4, _gen(0))
    assert bits.shape == (4, V)
    np.testing.assert_array_equal(bits.numpy(), np.broadcast_to(want, (4, V)))


def test_ghz_state_samples_only_all_equal_bitstrings():
    tspec = ms.port_state("grid3x3", 2)[0]
    state = _bp_state(tspec, ms.ghz_peps(tspec))
    bits = tp.make_bp_sampler(tspec, refresh_iters=6)(state, 12, _gen(1))
    bits = bits.numpy()
    assert set(np.unique(bits)) <= {0, 1}
    for row in bits:
        assert (row == row[0]).all()


def test_one_seed_gives_the_same_bitstrings_twice():
    tspec, state = ms.port_state("grid3x3", 3)
    sampler = tp.make_bp_sampler(tspec, refresh_iters=2)
    a = sampler(state, 5, _gen(7))
    b = sampler(state, 5, _gen(7))
    c = sampler(state, 5, _gen(8))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    # the sampler leaves the state it was handed untouched
    np.testing.assert_array_equal(state.tensors.numpy(),
                                  ms.port_state("grid3x3", 3)[1].tensors.numpy())


def test_rho_sampler_on_a_pure_basis_state():
    """ρ = |x⟩⟨x| as Pauli coefficients (I ± Z)/2 per site: the sampler
    returns x with logp = 0, and one seed gives the same draw twice."""
    tspec = ms.port_state("grid3x3", 2)[0]
    V = tspec.num_vertices
    want = (np.arange(V) // 2) % 2
    site = np.stack([[0.5, 0, 0, 0.5 * (1 - 2 * b)] for b in want])
    tensors = ms.product_peps(tspec, site)
    state = tp.state_from_numpy(
        tensors, np.broadcast_to(np.eye(2), (V, tspec.degree, 2, 2)).astype(
            np.complex128))
    sampler = tp.make_rho_sampler(tspec, 2, torch.complex128)
    bits, logps = sampler(state, 3, _gen(0))
    np.testing.assert_array_equal(bits.numpy(), np.broadcast_to(want, (3, V)))
    np.testing.assert_allclose(logps.numpy(), 0.0, atol=1e-12)


def test_rho_sampler_is_reproducible_and_finite_in_complex64():
    _, _, tspec, tensors, messages = _d4_state()
    state = tp.state_from_numpy(tensors.astype(np.complex64),
                                messages.astype(np.complex64))
    sampler = tp.make_rho_sampler(tspec, 2, torch.complex64, refresh_iters=3)
    bits, logps = sampler(state, 6, _gen(2))
    bits2, logps2 = sampler(state, 6, _gen(2))
    np.testing.assert_array_equal(bits.numpy(), bits2.numpy())
    np.testing.assert_array_equal(logps.numpy(), logps2.numpy())
    assert logps.dtype == torch.float32
    assert set(np.unique(bits.numpy())) <= {0, 1}
    assert torch.isfinite(logps).all() and (logps <= 0).all()
