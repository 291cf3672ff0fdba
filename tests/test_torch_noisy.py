"""PyTorch port, the d=4 density-matrix path: the vendored channels and
Pauli-transfer matrices, `BatchedCircuit`'s pictures, the parametric noisy
layer and its rate sweep, and the sandwich-BP Pauli readout, each against
the JAX package on the same inputs (tests/test_noisy_ensemble.py).

Everything runs in complex128 / float64 on both sides, so transfer
matrices agree to 1e-12 and the BP readouts to the reference tests' own
rtol 1e-6 / atol 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch.models import channels as t_ch
from tensornetworkquantumsimulator_torch.models import gates as t_gates
from tensornetworkquantumsimulator_torch.parallel import ensemble as te
from tensornetworkquantumsimulator_tpu import density_matrix_tensornetworkstate
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.models import channels as j_ch
from tensornetworkquantumsimulator_tpu.models import gates as j_gates
from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


_TOL = dict(rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("heis", [False, True])
def test_torch_traceable_ptms_match_reference_builders(heis):
    for name, gen in [("Rx", "X"), ("Rz", "Z"), ("Rzz", "ZZ"), ("Rxx", "XX")]:
        th = 0.437
        ref = j_gates.pauli_transfer_matrix(j_gates.gate_matrix(name, th),
                                            heisenberg=heis)
        np.testing.assert_allclose(
            t_gates.pauli_transfer_matrix(t_gates.gate_matrix(name, th),
                                          heisenberg=heis), ref, atol=1e-12)
        got = te.ptm_rot(gen, th, heisenberg=heis)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jp.ptm_rot(gen, th, heisenberg=heis)),
            atol=1e-12)
    for cn, par in [("depolarizing", 0.23), ("dephasing", 0.19),
                    ("dephasing:X", 0.11), ("bitflip", 0.3),
                    ("amplitude_damping", 0.37), ("reset", 0.21)]:
        ref = j_ch.channel_ptm(cn, par, nsites=1, heisenberg=heis)
        np.testing.assert_allclose(
            t_ch.channel_ptm(cn, par, nsites=1, heisenberg=heis), ref,
            atol=1e-12)
        np.testing.assert_allclose(
            te.ptm_channel(cn, par, heisenberg=heis).numpy(), ref, atol=1e-12)
    # batched rates broadcast
    out = te.ptm_channel("depolarizing", torch.tensor([0.0, 0.5]))
    assert out.shape == (2, 4, 4)
    np.testing.assert_allclose(out[0].numpy(), np.eye(4), atol=1e-14)
    with pytest.raises(ValueError, match="single-site"):
        te.ptm_channel("dephasing:ZZ", 0.1)


@pytest.mark.parametrize("name,param,nsites", [
    ("depolarizing", 0.3, 2), ("dephasing:ZZ", 0.2, 2), ("gad", (0.3, 0.6), 1),
    ("pauli_channel", (0.7, 0.1, 0.1, 0.1), 1),
    ("kraus", [np.sqrt(0.6) * np.eye(2),
               np.sqrt(0.4) * np.array([[0, 1], [1, 0]])], 1),
])
def test_torch_vendored_channels_match_jax(name, param, nsites):
    assert t_ch.is_channel(name) and j_ch.is_channel(name)
    for heis in (False, True):
        np.testing.assert_allclose(
            t_ch.channel_ptm(name, param, nsites=nsites, heisenberg=heis),
            j_ch.channel_ptm(name, param, nsites=nsites, heisenberg=heis),
            atol=1e-12)
    assert not t_ch.is_channel("Rzz")


def _setup(chi):
    """The JAX spec and |0…0⟩⟨0…0| Pauli state on the 3x3 grid, and the
    port's, built by its own d=4 product state."""
    g = j_lat.named_grid((3, 3))
    rho0 = density_matrix_tensornetworkstate(jnp.complex128, lambda v: "0", g)
    spec_j, s_j = jp.batched_from_tns(rho0, chi=chi)
    g_t = tt.named_grid((3, 3))
    spec_t, s_t = tt.batched_product_state(
        g_t, chi=chi, state_fn=lambda v: "0", dtype=torch.complex128, d=4)
    return (g, spec_j, s_j), (g_t, spec_t, s_t)


def test_torch_d4_product_state_matches_jax():
    (_, spec_j, s_j), (_, spec_t, s_t) = _setup(3)
    np.testing.assert_array_equal(s_t.tensors.numpy(), np.asarray(s_j.tensors))
    np.testing.assert_array_equal(s_t.messages.numpy(),
                                  np.asarray(s_j.messages))


def _rho_circuit(graphs, g, th, phi, p_dep, gam):
    circuit = [("Rx", [v], th) for v in g.vertices()]
    for grp in graphs.edge_color(g, 4):
        circuit += [("Rzz", pair, phi) for pair in grp]
    circuit += [("depolarizing", [v], p_dep) for v in g.vertices()]
    circuit += [("amplitude_damping", [v], gam) for v in g.vertices()]
    return circuit


_ANGLES = dict(th=0.31, phi=0.22, p_dep=0.05, gam=0.08)
_LAYER_KW = dict(cutoff=1e-13, normalize_tensors=False, bp_maxiter=80,
                 bp_tolerance=1e-13)


def _readout(pkg_fn, spec, chi, dtype):
    return pkg_fn(spec, chi, dtype, ops=("Z", "X"), maxiter=80,
                  tolerance=1e-13)


def test_torch_rho_circuit_and_pauli_readout_match_jax():
    """`BatchedCircuit(picture="rho")` + `make_layer_fn` and
    `make_pauli_expectation_fn`, port against JAX, from the same state."""
    chi = 4
    (g_j, spec_j, s_j), (g_t, spec_t, s_t) = _setup(chi)
    circ_j = _rho_circuit(j_graphs, g_j, **_ANGLES)
    circ_t = _rho_circuit(tt, g_t, **_ANGLES)
    layer_j = jp.make_layer_fn(
        jp.BatchedCircuit(circ_j, g_j, spec=spec_j, d=4, picture="rho"),
        chi=chi, **_LAYER_KW)
    layer_t = tt.make_layer_fn(
        tt.BatchedCircuit(circ_t, g_t, spec=spec_t, d=4, picture="rho"),
        chi=chi, **_LAYER_KW)
    s_j, _ = layer_j(s_j)
    s_t, _ = layer_t(s_t)
    va = _readout(jp.make_pauli_expectation_fn, spec_j, chi, jnp.complex128)(
        s_j)
    vb = _readout(tt.parallel.make_pauli_expectation_fn, spec_t, chi,
                  torch.complex128)(s_t)
    for op in ("Z", "X"):
        np.testing.assert_allclose(vb[op].numpy(), np.asarray(va[op]), **_TOL)
    # both pictures compile to the JAX package's segments, gate for gate
    for kw in (dict(picture="rho"), dict(heisenberg=True)):
        segs_t = tt.BatchedCircuit(circ_t, g_t, spec=spec_t, d=4,
                                   **kw).segments
        segs_j = jp.BatchedCircuit(circ_j, g_j, spec=spec_j, d=4,
                                   **kw).segments
        assert len(segs_t) == len(segs_j)
        for a, b in zip(segs_t, segs_j):
            np.testing.assert_allclose(a.gate, b.gate, atol=1e-12)
    with pytest.raises(ValueError, match="d=4"):
        tt.BatchedCircuit(circ_t, g_t, spec=spec_t, picture="rho")


def test_torch_noisy_field_layer_matches_compiled_circuit():
    """At fixed angles and rates the port's noisy field layer equals the
    port's `BatchedCircuit(picture="rho")` layer, and the JAX noisy layer."""
    chi, a = 4, _ANGLES
    (g_j, spec_j, s_j), (g_t, spec_t, s_t) = _setup(chi)
    noise = ("depolarizing", "amplitude_damping")
    kw = dict(site_pauli="X", bond_pauli="ZZ", noise=noise, cutoff=1e-13,
              bp_maxiter=80, bp_tolerance=1e-13)
    _, nl_t = tt.parallel.make_noisy_field_layer_fn(g_t, chi, spec=spec_t,
                                                    **kw)
    _, nl_j = jp.make_noisy_field_layer_fn(g_j, chi, spec=spec_j, **kw)
    rates = np.array([a["p_dep"], a["gam"]])
    state_a, err_a = nl_t(s_t, a["th"], a["phi"], torch.from_numpy(rates))
    state_j, err_j = nl_j(s_j, a["th"], a["phi"], jnp.asarray(rates))

    ref_layer = tt.make_layer_fn(
        tt.BatchedCircuit(_rho_circuit(tt, g_t, **a), g_t, spec=spec_t, d=4,
                          picture="rho"), chi=chi, **_LAYER_KW)
    state_b, _ = ref_layer(s_t)

    fn = _readout(tt.parallel.make_pauli_expectation_fn, spec_t, chi,
                  torch.complex128)
    fn_j = _readout(jp.make_pauli_expectation_fn, spec_j, chi, jnp.complex128)
    va, vb, vj = fn(state_a), fn(state_b), fn_j(state_j)
    for op in ("Z", "X"):
        np.testing.assert_allclose(va[op].numpy(), vb[op].numpy(), **_TOL)
        np.testing.assert_allclose(va[op].numpy(), np.asarray(vj[op]), **_TOL)
    np.testing.assert_allclose(err_a.numpy(), np.asarray(err_j), atol=1e-8)


def test_torch_noise_rate_sweep_one_program():
    """Rates on the ensemble axis: E noise strengths advance in one folded
    program; rows match per-rate runs and the JAX vmapped sweep, and noise
    strictly reduces |⟨Z⟩| site-wise on this workload."""
    chi, th, phi = 4, 0.31, 0.22
    (g_j, spec_j, s_j), (g_t, spec_t, s_t) = _setup(chi)
    kw = dict(noise=("depolarizing",), cutoff=1e-13, bp_maxiter=60,
              bp_tolerance=1e-13)
    _, layer = tt.parallel.make_noisy_field_layer_fn(g_t, chi, spec=spec_t,
                                                     **kw)
    _, layer_j = jp.make_noisy_field_layer_fn(g_j, chi, spec=spec_j,
                                              jit=False, **kw)
    rates = np.array([0.0, 0.06, 0.12])
    sweep = te.ensemble_fn(layer, in_axes=(0, None, None, 0))
    sweep_j = jp.ensemble_fn(layer_j, in_axes=(0, None, None, 0))
    estate = te.stack_states([s_t] * len(rates))
    estate_j = jp.stack_states([s_j] * len(rates))
    for _ in range(2):
        estate, _ = sweep(estate, th, phi, torch.from_numpy(rates))
        estate_j, _ = sweep_j(estate_j, th, phi, jnp.asarray(rates))

    fn = tt.parallel.make_pauli_expectation_fn(
        spec_t, chi, torch.complex128, maxiter=60, tolerance=1e-13)
    fn_j = jp.make_pauli_expectation_fn(spec_j, chi, jnp.complex128,
                                        maxiter=60, tolerance=1e-13)
    z = np.stack([fn(s)["Z"].numpy() for s in te.unstack_states(estate)])
    z_j = np.stack([np.asarray(fn_j(s)["Z"])
                    for s in jp.unstack_states(estate_j)])
    np.testing.assert_allclose(z, z_j, **_TOL)
    for i, p in enumerate(rates):
        s, _ = layer(s_t, th, phi, p)
        s, _ = layer(s, th, phi, p)
        np.testing.assert_allclose(z[i], fn(s)["Z"].numpy(), rtol=1e-7,
                                   atol=1e-9)
    za = np.abs(z)
    assert np.all(za[0] > za[1]) and np.all(za[1] > za[2])
