"""PyTorch port, sandwich-BP overlaps against the JAX package
(``parallel/overlap.py``) on the same numpy inputs.

Compared, complex128 at 1e-8: the messages after a fixed number of sandwich
sweeps, ``log_abs`` and ``exp(i·phase)`` of Z_BP (the raw phase is a sum of
principal values, comparable only modulo 2π), overlaps, echoes and the
purity of a d=4 state.  complex64 against complex128 at 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch.parallel import overlap as t_ov
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import overlap as j_ov

import measure_states as ms

torch.set_num_threads(1)
_BP = dict(maxiter=300, tolerance=1e-14)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _pair(lattice, chi, dtype=None, **kw):
    """Two different states on one lattice, in both packages."""
    jspec, ja, tspec, ta, ma = ms.converged(lattice, chi, 0, **kw)
    _, jb, _, tb, mb = ms.converged(lattice, chi, 1, **kw)
    if dtype is not None:
        ta, ma, tb, mb = (x.astype(dtype) for x in (ta, ma, tb, mb))
    return (jspec, ja, jb, tspec, tp.state_from_numpy(ta, ma),
            tp.state_from_numpy(tb, mb))


def _unit(phase):
    return np.exp(1j * float(phase))


def _assert_logz(got, ref, atol):
    np.testing.assert_allclose(float(got[0]), float(ref[0]), atol=atol)
    np.testing.assert_allclose(_unit(got[1]), _unit(ref[1]), atol=atol)


@pytest.mark.parametrize("lattice", ["grid3x3", "heavyhex1x1"])
@pytest.mark.parametrize("damping", [0.0, 0.3])
def test_sandwich_sweeps_and_logz_match_jax(lattice, damping):
    jspec, ja, jb, tspec, a, b = _pair(lattice, 3)
    V, D = tspec.num_vertices, tspec.degree
    jm = j_ov.sandwich_sweeps(
        jspec, ja.tensors, jnp.conj(jb.tensors),
        jp.identity_messages(V, D, 3, np.complex128), 6, damping=damping)
    m = t_ov.sandwich_sweeps(
        tspec, a.tensors, b.tensors.conj(),
        tp.identity_messages(V, D, 3, torch.complex128, "cpu"), 6,
        damping=damping)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-10)
    _assert_logz(t_ov.sandwich_logz(tspec, a.tensors, b.tensors.conj(), m),
                 j_ov.sandwich_logz(jspec, ja.tensors, jnp.conj(jb.tensors),
                                    jm), 1e-8)


@pytest.mark.parametrize("lattice", ["grid3x3", "heavyhex2x2"])
def test_inner_matches_jax(lattice):
    jspec, ja, jb, tspec, a, b = _pair(lattice, 3)
    got = tp.batched_inner(tspec, a, b, **_BP)
    ref = j_ov.batched_inner(jspec, ja, jb, **_BP)
    _assert_logz(got, ref, 1e-8)
    # the second argument is the conjugated one: swapping conjugates
    swapped = tp.batched_inner(tspec, b, a, **_BP)
    np.testing.assert_allclose(float(swapped[0]), float(got[0]), atol=1e-8)
    np.testing.assert_allclose(_unit(swapped[1]), np.conj(_unit(got[1])),
                               atol=1e-8)


def test_self_inner_is_the_bp_norm():
    """⟨ψ|ψ⟩ by the sandwich equals the norm network's Z_BP at the state's
    own (hermitian) messages, and its phase vanishes."""
    _, _, _, tspec, a, _ = _pair("grid3x3", 3)
    la, ph = tp.batched_inner(tspec, a, a, **_BP)
    ref = t_ov.sandwich_logz(tspec, a.tensors, a.tensors.conj(), a.messages)
    np.testing.assert_allclose(float(la), float(ref[0]), atol=1e-8)
    np.testing.assert_allclose(_unit(ph), 1.0, atol=1e-8)


def test_inner_of_product_states_is_exact():
    """BP is exact on bond-1 content: the overlap of two product states is
    the product of the site overlaps."""
    tspec = ms.port_state("grid3x3", 2)[0]
    rng = np.random.default_rng(5)
    V, D = tspec.num_vertices, tspec.degree
    sites = rng.standard_normal((2, V, 2)) + 1j * rng.standard_normal((2, V, 2))
    states = []
    for s in sites:
        t = np.zeros((V,) + (2,) * D + (2,), np.complex128)
        t[(slice(None),) + (0,) * D] = s
        states.append(tp.state_from_numpy(
            t, np.broadcast_to(np.eye(2), (V, D, 2, 2)).astype(np.complex128)))
    la, ph = tp.batched_inner(tspec, states[0], states[1])
    exact = np.prod(np.einsum("vs,vs->v", sites[0], np.conj(sites[1])))
    np.testing.assert_allclose(np.exp(float(la)) * _unit(ph), exact,
                               rtol=1e-10)


def test_echo_is_one_on_itself_and_matches_jax():
    jspec, ja, jb, tspec, a, b = _pair("grid3x3", 3)
    la, ph = tp.batched_loschmidt_echo(tspec, a, a, **_BP)
    np.testing.assert_allclose(float(la), 0.0, atol=1e-8)
    np.testing.assert_allclose(_unit(ph), 1.0, atol=1e-8)
    got = tp.batched_loschmidt_echo(tspec, a, b, **_BP)
    ref = j_ov.batched_loschmidt_echo(jspec, ja, jb, **_BP)
    _assert_logz(got, ref, 1e-8)
    assert float(got[0]) < 0.0  # two different normalized states
    # a precomputed log⟨ψ₀|ψ₀⟩ gives the same echo
    ln0, _ = tp.batched_inner(tspec, a, a, **_BP)
    again = tp.batched_loschmidt_echo(tspec, a, b, log_norm0=ln0, **_BP)
    _assert_logz(again, got, 1e-12)


@pytest.mark.parametrize("log2", [False, True])
def test_purity_of_a_d4_state_matches_jax(log2):
    jspec, jstate, tspec, tensors, messages = ms.converged(
        "grid3x3", 2, 0, d=4, amp=0.1)
    state = tp.state_from_numpy(tensors, messages)
    got = tp.batched_purity(tspec, state, log2=log2, **_BP)
    ref = j_ov.batched_purity(jspec, jstate, log2=log2, **_BP)
    np.testing.assert_allclose(float(got), float(ref), atol=1e-8)
    if not log2:
        assert float(got) > 0.0


def test_inner_complex64_within_band():
    _, _, _, tspec, a, b = _pair("grid3x3", 3)
    _, _, _, _, a32, b32 = _pair("grid3x3", 3, dtype=np.complex64)
    ref = tp.batched_inner(tspec, a, b, **_BP)
    got = tp.batched_inner(tspec, a32, b32, maxiter=300)
    assert got[0].dtype == torch.float32
    _assert_logz(got, ref, 1e-4)


def test_autograd_crosses_sandwich_sweeps():
    """d log|Z| / dx through 5 sweeps, by autograd and by a central
    difference, along a real line t_ket = t0 + x·dt (relative 1e-6)."""
    _, _, _, tspec, a, b = _pair("grid3x3", 2)
    V, D = tspec.num_vertices, tspec.degree
    rng = np.random.default_rng(9)
    dt = torch.from_numpy(rng.standard_normal(tuple(a.tensors.shape))
                          * (a.tensors.abs() > 0).numpy()).to(a.tensors.dtype)
    bra = b.tensors.conj()
    m0 = tp.identity_messages(V, D, 2, torch.complex128, "cpu")

    def log_abs(x):
        t = a.tensors + x * dt
        m = t_ov.sandwich_sweeps(tspec, t, bra, m0, 5)
        return t_ov.sandwich_logz(tspec, t, bra, m)[0]

    x = torch.zeros((), dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(log_abs(x), x)
    h = 1e-5
    with torch.no_grad():
        fd = (log_abs(torch.tensor(h, dtype=torch.float64))
              - log_abs(torch.tensor(-h, dtype=torch.float64))) / (2 * h)
    assert abs(float(grad)) > 1e-3
    np.testing.assert_allclose(float(grad), float(fd), rtol=1e-6)
