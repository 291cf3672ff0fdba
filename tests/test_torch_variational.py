"""PyTorch port, variational ground and excited states
(``parallel/variational.py``) against the JAX package on the same numpy
inputs.

The energy and its gradient are compared in complex128 to 1e-8: autograd's
gradient of a real loss in a complex tensor is ∂E/∂re + i·∂E/∂im, the pair
``jax.value_and_grad`` returns over the reference's (re, im) leaves.  Adam
trajectories (torch's defaults equal optax's: β = (0.9, 0.999), ε = 1e-8)
are compared in float64 to 1e-6.  With ``TNQS_BP_KERNEL=1`` a degree-3
state must not reach K3 while autograd records, and must reach it under
``torch.no_grad()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import cuda_bp
from tensornetworkquantumsimulator_torch.parallel import variational as tv
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import variational as jv

import measure_states as ms

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _hams(kind):
    if kind == "tfim":
        return tv.tfim_hamiltonian(1.0, 2.5), jv.tfim_hamiltonian(1.0, 2.5)
    return (tv.heisenberg_hamiltonian(1.0, 0.7, 0.4),
            jv.heisenberg_hamiltonian(1.0, 0.7, 0.4))


def _noised(spec, tensors, eps, seed):
    """Noise on the valid block of numpy vertex tensors (dummy slots keep
    bond dimension 1), as the reference tests' ``_noised``."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=tensors.shape)
    if np.iscomplexobj(tensors):
        noise = noise + 1j * rng.normal(size=tensors.shape)
    mask = spec.mask_array()
    for k in range(spec.degree):
        idx = [slice(None)] * tensors.ndim
        idx[1 + k] = slice(1, None)
        noise[tuple(idx)] *= mask[:, k][
            (slice(None),) + (None,) * (tensors.ndim - 1)]
    return (tensors + eps * noise).astype(tensors.dtype)


@pytest.mark.parametrize("lattice, kind, sweeps, damping", [
    ("grid3x3", "heisenberg", 3, 0.1),
    ("grid3x3", "tfim", 8, 0.0),
    ("heavyhex1x1", "heisenberg", 5, 0.0),
])
def test_torch_energy_and_gradient_match_jax(lattice, kind, sweeps, damping):
    jspec, _, tspec, tensors, messages = ms.converged(lattice, 2)
    tensors = _noised(tspec, tensors, 0.05, seed=3)
    ham_t, ham_j = _hams(kind)
    efj = jv.make_energy_fn(jspec, ham_j, sweeps, damping)

    def loss(re, im):
        return efj(re + 1j * im, jnp.asarray(messages))[0]

    e_j, (g_re, g_im) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(tensors.real), jnp.asarray(tensors.imag))
    g_j = np.asarray(g_re) + 1j * np.asarray(g_im)

    params = torch.tensor(tensors, requires_grad=True)
    e_t, m_t = tv.make_energy_fn(tspec, ham_t, sweeps, damping)(
        params, torch.tensor(messages))
    e_t.backward()
    assert e_t.dtype == torch.float64 and m_t.grad_fn is not None
    e_t = float(e_t.detach())
    assert abs(e_t - float(e_j)) <= 1e-8 * abs(float(e_j))
    scale = np.abs(g_j).max()
    assert np.abs(params.grad.numpy() - g_j).max() <= 1e-8 * scale
    # the plain energy of a state at its messages, no sweeps
    st = tt.parallel.state_from_numpy(tensors, messages)
    jst = jp.BatchedState(jnp.asarray(tensors), jnp.asarray(messages))
    np.testing.assert_allclose(float(tv.energy(tspec, ham_t, st)),
                               float(jv.energy(jspec, ham_j, jst)),
                               rtol=1e-10)


@pytest.mark.parametrize("lattice, dtype", [("grid3x3", np.float64),
                                            ("heavyhex1x1", np.complex128)])
def test_torch_ground_state_trajectory_matches_jax(lattice, dtype):
    """The first 20 Adam steps from the same noised state."""
    jspec, _, tspec, tensors, messages = ms.converged(lattice, 2)
    t0 = _noised(tspec, tensors, 0.1, seed=5)
    if dtype == np.float64:
        t0, messages = t0.real.copy(), messages.real.copy()
    ham_t, ham_j = _hams("tfim")
    kw = dict(steps=20, learning_rate=3e-2, bp_sweeps_per_eval=6,
              damping=0.1)
    js, ej = jv.ground_state(
        jspec, jp.BatchedState(jnp.asarray(t0), jnp.asarray(messages)),
        ham_j, **kw)
    ts, et = tv.ground_state(
        tspec, tt.parallel.state_from_numpy(t0, messages), ham_t, **kw)
    assert et.shape == (20,) and et.dtype == torch.float64
    assert float(et[-1]) < float(et[0])
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6)
    np.testing.assert_allclose(ts.tensors.numpy(), np.asarray(js.tensors),
                               atol=1e-6)
    np.testing.assert_allclose(ts.messages.numpy(), np.asarray(js.messages),
                               atol=1e-6)
    # an optimizer passed as a callable takes the same steps
    ts2, et2 = tv.ground_state(
        tspec, tt.parallel.state_from_numpy(t0, messages), ham_t,
        optimizer=lambda p: torch.optim.Adam(p, lr=3e-2), **{
            k: v for k, v in kw.items() if k != "learning_rate"})
    assert torch.equal(et2, et) and torch.equal(ts2.tensors, ts.tensors)


def _ensemble_inputs(E):
    jspec, _, tspec, tensors, messages = ms.converged("grid3x3", 2)
    t0 = _noised(tspec, tensors, 0.1, seed=2).real.copy()
    m0 = messages.real.copy()
    rng = np.random.default_rng(5)
    hx = rng.uniform(1.5, 3.0, (E, tspec.num_vertices))
    return jspec, tspec, t0, m0, hx


def test_torch_ensemble_ground_state_equals_single_runs():
    """E=3 per-site disorder in one folded program: each member equals its
    own single run of the port (the fold shares launches, not arithmetic)
    and the JAX package's vmapped ensemble."""
    E = 3
    jspec, tspec, t0, m0, hx = _ensemble_inputs(E)
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    kw = dict(steps=20, learning_rate=5e-2, bp_sweeps_per_eval=6)
    st = tt.parallel.state_from_numpy(t0, m0)
    est = tp.stack_states([st] * E)
    ham = tv.Hamiltonian(((X, -hx),), ((Z, Z, -1.0),))
    out, energies = tv.ensemble_ground_state(tspec, est, ham, **kw)
    assert energies.shape == (E, 20) and out.tensors.shape == est.tensors.shape
    for e in range(E):
        ham_e = tv.Hamiltonian(((X, -hx[e]),), ((Z, Z, -1.0),))
        se, en_e = tv.ground_state(tspec, st, ham_e, **kw)
        np.testing.assert_allclose(energies[e].numpy(), en_e.numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(out.tensors[e].numpy(),
                                   se.tensors.numpy(), atol=1e-12)
    jest = jp.BatchedState(jnp.asarray(np.stack([t0] * E)),
                           jnp.asarray(np.stack([m0] * E)))
    _, ej = jv.ensemble_ground_state(
        jspec, jest, jv.Hamiltonian(((X, -hx),), ((Z, Z, -1.0),)), **kw)
    np.testing.assert_allclose(energies.numpy(), np.asarray(ej), rtol=1e-6)
    assert abs(float(energies[0, -1]) - float(energies[1, -1])) > 1e-3


def test_torch_ensemble_ground_state_shared_and_ambiguous_coeffs():
    """A shared [V] field tiles across the members and equals the explicit
    [E, V] one; the 1-D length-E coefficient with E == V raises."""
    _, tspec, t0, m0, _ = _ensemble_inputs(2)
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    kw = dict(steps=5, learning_rate=5e-2, bp_sweeps_per_eval=4)
    V = tspec.num_vertices
    hx = np.linspace(1.5, 2.5, V)
    st = tt.parallel.state_from_numpy(t0, m0)
    est = tp.stack_states([st] * 2)
    _, en_s = tv.ensemble_ground_state(
        tspec, est, tv.Hamiltonian(((X, -hx),), ((Z, Z, -1.0),)), **kw)
    _, en_e = tv.ensemble_ground_state(
        tspec, est, tv.Hamiltonian(((X, -np.stack([hx, hx])),),
                                   ((Z, Z, -np.ones((2, 1))),)), **kw)
    assert torch.equal(en_s, en_e)
    est_v = tp.stack_states([st] * V)
    with pytest.raises(ValueError, match="ambiguous"):
        tv.ensemble_ground_state(
            tspec, est_v, tv.Hamiltonian(((X, -hx),), ((Z, Z, -1.0),)), **kw)


def test_torch_excited_state_matches_jax():
    """10 penalized steps against a 6-step ground state, complex128, on the
    4-site path (a tree)."""
    from tensornetworkquantumsimulator_torch.utils.lattices import (
        named_path_graph,
    )
    from tensornetworkquantumsimulator_tpu.utils.lattices import (
        named_path_graph as j_named_path_graph,
    )

    g_t, g_j = named_path_graph(4), j_named_path_graph(4)
    tspec, ts0 = tt.batched_product_state(g_t, chi=2, dtype=torch.complex128)
    jspec, js0 = jp.batched_product_state(g_j, chi=2, dtype=np.complex128)
    assert tspec.edges == jspec.edges
    ham_t, ham_j = _hams("tfim")
    kw = dict(learning_rate=3e-2, bp_sweeps_per_eval=6)
    t_a = _noised(tspec, ts0.tensors.numpy(), 0.3, seed=1)
    t_b = _noised(tspec, ts0.tensors.numpy(), 0.3, seed=7)
    m0 = ts0.messages.numpy()

    def both(t):
        return (tt.parallel.state_from_numpy(t, m0),
                jp.BatchedState(jnp.asarray(t), jnp.asarray(m0)))

    (ta, ja), (tb, jb) = both(t_a), both(t_b)
    tgs, _ = tv.ground_state(tspec, ta, ham_t, steps=6, **kw)
    jgs, _ = jv.ground_state(jspec, ja, ham_j, steps=6, **kw)
    tex, te, tpen = tv.excited_state(tspec, tb, ham_t, below=[tgs],
                                     weight=20.0, steps=10, **kw)
    jex, je, jpen = jv.excited_state(jspec, jb, ham_j, below=[jgs],
                                     weight=20.0, steps=10, **kw)
    assert te.shape == tpen.shape == (10,)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-8)
    np.testing.assert_allclose(tpen.numpy(), np.asarray(jpen), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(tex.tensors.numpy(), np.asarray(jex.tensors),
                               atol=1e-8)


def test_torch_k3_not_reached_under_grad(monkeypatch):
    """With ``TNQS_BP_KERNEL=1`` on a degree-3 complex64 state, a stand-in
    for K3 that returns a detached result (as the ctypes launch does) is
    never reached while autograd records, so the gradient equals the
    kernel-off one; under ``torch.no_grad()`` it is reached and the energy
    is the same."""
    calls = []
    plain = cuda_bp.bp_outgoing_plain

    def detached_k3(t, messages):
        calls.append(tuple(t.shape))
        return plain(t.detach(), messages.detach())

    monkeypatch.setattr(cuda_bp, "bp_outgoing_d3", detached_k3)
    _, _, tspec, tensors, messages = ms.converged("heavyhex2x2", 2)
    assert tspec.degree == 3
    t0 = _noised(tspec, tensors, 0.05, seed=9).astype(np.complex64)
    m0 = torch.tensor(messages.astype(np.complex64))
    efn = tv.make_energy_fn(tspec, tv.heisenberg_hamiltonian(), 4)

    def grad(env):
        monkeypatch.setenv("TNQS_BP_KERNEL", env)
        params = torch.tensor(t0, requires_grad=True)
        e, _ = efn(params, m0)
        e.backward()
        return float(e.detach()), params.grad

    e_on, g_on = grad("1")
    assert calls == []
    e_off, g_off = grad("0")
    assert e_on == e_off and torch.equal(g_on, g_off)
    monkeypatch.setenv("TNQS_BP_KERNEL", "1")
    with torch.no_grad():
        e_ng, _ = efn(torch.tensor(t0), m0)
    assert len(calls) == 4  # one per sweep
    assert abs(float(e_ng) - e_on) <= 1e-5 * abs(e_on)
