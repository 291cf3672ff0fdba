"""PyTorch port, parametric and ensemble layers (`parallel/ensemble.py`):
the port's field layer against the JAX package's on the same carried-across
states and angles, and the port's ensemble (the members folded into the
vertex axis) against single runs and against JAX's vmapped layer.

Both packages run LAPACK in double on the CPU for complex128, so per-site
⟨Z⟩ and truncation errors agree to 1e-8; the angles are float64, since
float32 angles build complex64 gates by the reference's dtype rule.  An
ensemble reproduces single runs of the same module to 1e-10 (the batched
factorizations may take other LAPACK blockings than the single ones)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch.parallel import engine as t_engine
from tensornetworkquantumsimulator_torch.parallel import ensemble as te
from tensornetworkquantumsimulator_tpu.models.gates import gate_matrix
from tensornetworkquantumsimulator_tpu.models.sites import op_matrix
from tensornetworkquantumsimulator_tpu.models.tensornetwork import (
    tensornetworkstate,
)
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


_Z = op_matrix("Z", 2)
_REPO = Path(__file__).resolve().parents[1]


def _start(make_graph, chi):
    """The JAX spec and |↑…↑⟩ state, and the port's spec and the same state
    carried across."""
    g = make_graph(j_lat)
    psi0 = tensornetworkstate(jnp.complex128, lambda v: "↑", g, "S=1/2")
    spec_j, s_j = jp.batched_from_tns(psi0, chi=chi)
    spec_t = tt.compile_graph(make_graph(tt))
    s_t = tt.parallel.state_from_numpy(np.asarray(s_j.tensors),
                                       np.asarray(s_j.messages))
    return (g, spec_j, s_j), (make_graph(tt), spec_t, s_t)


@pytest.mark.parametrize(
    "pauli,theta", [("X", 0.37), ("Y", -1.2), ("Z", 2.9), ("XX", 0.61),
                    ("YY", -0.8), ("ZZ", 1.7)])
def test_torch_rotation_builders_match_jax(pauli, theta):
    rot_t, rot_j = (te.rot1, jp.rot1) if len(pauli) == 1 else (te.rot2,
                                                               jp.rot2)
    got = rot_t(pauli, torch.tensor(theta, dtype=torch.float64))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), gate_matrix("R" + pauli.lower(),
                                                         theta), atol=1e-12)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(rot_j(pauli, jnp.float64(theta))),
                               atol=1e-12)
    # the dtype rule: float32 angles give complex64 gates
    batch = rot_t(pauli, torch.tensor([theta, 0.5], dtype=torch.float32))
    assert batch.dtype == torch.complex64 and batch.shape[0] == 2


_FIELD_CASES = {
    # (lattice, chi, site paulis, seed, layers): the disorder test, the
    # heavy-hex test (several slot pairs per colour group) and the
    # kicked-Ising ("X", "Z") test of tests/test_ensemble.py
    "grid3x3_disorder": (lambda lat: lat.named_grid((3, 3)), 4, "X", 7, 2),
    "heavyhex1x1": (lambda lat: lat.heavy_hexagonal_lattice(1, 1), 3, "X",
                    13, 1),
    "grid3x3_multi_pauli": (lambda lat: lat.named_grid((3, 3)), 3,
                            ("X", "Z"), 23, 1),
}


@pytest.mark.parametrize("case", sorted(_FIELD_CASES))
def test_torch_field_layer_matches_jax(case):
    make_graph, chi, site_pauli, seed, nlayers = _FIELD_CASES[case]
    (g_j, spec_j, s_j), (g_t, spec_t, s_t) = _start(make_graph, chi)
    kw = dict(site_pauli=site_pauli, bp_maxiter=60, bp_tolerance=1e-12)
    _, layer_j = jp.make_field_layer_fn(g_j, chi=chi, spec=spec_j, **kw)
    _, layer_t = tt.parallel.make_field_layer_fn(g_t, chi=chi, spec=spec_t,
                                                 **kw)
    rng = np.random.default_rng(seed)
    S = 1 if isinstance(site_pauli, str) else len(site_pauli)
    V, E = spec_t.num_vertices, len(spec_t.edges)
    site = rng.uniform(0.2, 1.1, size=(S, V) if S > 1 else V)
    bond = rng.uniform(0.3, 0.9, size=E)
    for _ in range(nlayers):
        s_j, e_j = layer_j(s_j, jnp.asarray(site), jnp.asarray(bond))
        s_t, e_t = layer_t(s_t, torch.from_numpy(site),
                           torch.from_numpy(bond))
    z_j = np.real(np.asarray(jp.local_expectations(spec_j, s_j,
                                                   jnp.asarray(_Z))))
    z_t = tt.local_expectations(spec_t, s_t, _Z).real.numpy()
    np.testing.assert_allclose(z_t, z_j, atol=1e-8)
    assert e_t.shape == e_j.shape
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-8)


def test_torch_multi_pauli_ambiguous_site_thetas_raises():
    """S rotations on S vertices: a 1-D length-S theta vector is ambiguous
    and must be rejected (it would broadcast into wrong gates)."""
    g = tt.named_grid((2, 1))  # V = 2
    spec, s0 = tt.batched_product_state(g, chi=2, dtype=torch.complex128)
    _, layer = tt.parallel.make_field_layer_fn(
        g, chi=2, spec=spec, site_pauli=("X", "Z"), bp_maxiter=5)
    with pytest.raises(ValueError, match="ambiguous"):
        layer(s0, torch.tensor([0.3, 0.4], dtype=torch.float64), 0.5)
    # and the same inside an ensemble, per member
    ens = te.ensemble_fn(layer)
    with pytest.raises(ValueError, match="ambiguous"):
        ens(te.stack_states([s0, s0]),
            torch.tensor([[0.3, 0.4], [0.1, 0.2]], dtype=torch.float64),
            torch.tensor([0.5, 0.5], dtype=torch.float64))


def test_torch_ensemble_matches_single_runs():
    """E realizations in one folded program == E independent runs
    (tests/test_ensemble.py::test_ensemble_vmap_matches_single_runs)."""
    g = tt.named_grid((3, 3))
    chi, E = 3, 3
    spec, s0 = tt.batched_product_state(g, chi=chi, dtype=torch.complex128)
    # tolerance 0: fixed-trip BP, the same sweep count in every member
    _, layer = tt.parallel.make_field_layer_fn(
        g, chi=chi, spec=spec, bp_maxiter=25, bp_tolerance=0.0)
    rng = np.random.default_rng(11)
    V, Eb = spec.num_vertices, len(spec.edges)
    site = torch.from_numpy(rng.uniform(0.1, 1.0, size=(E, V)))
    bond = torch.from_numpy(rng.uniform(0.2, 0.8, size=(E, Eb)))

    estate, eerrs = te.ensemble_fn(layer)(te.stack_states([s0] * E), site,
                                          bond)
    assert eerrs.shape[0] == E
    z_ens = te.make_ensemble_expectation_fn(spec, _Z)(estate)
    assert z_ens.shape == (E, V)
    for i in range(E):
        si, errs_i = layer(s0, site[i], bond[i])
        z_i = tt.local_expectations(spec, si, _Z)
        np.testing.assert_allclose(z_ens[i].real.numpy(), z_i.real.numpy(),
                                   atol=1e-10)
        np.testing.assert_allclose(eerrs[i].numpy(), errs_i.numpy(),
                                   atol=1e-10)
    singles = te.unstack_states(estate)
    assert len(singles) == E
    np.testing.assert_array_equal(singles[1].tensors.numpy(),
                                  estate.tensors[1].numpy())


def test_torch_ensemble_broadcast_shared_angles():
    """in_axes broadcasting: angles shared across the ensemble axis."""
    g = tt.named_grid((2, 2))
    chi, E = 2, 2
    spec, s0 = tt.batched_product_state(g, chi=chi, dtype=torch.complex128)
    _, layer = tt.parallel.make_field_layer_fn(
        g, chi=chi, spec=spec, bp_maxiter=20, bp_tolerance=0.0)
    elayer = te.ensemble_fn(layer, in_axes=(0, None, None))
    estate, _ = elayer(te.stack_states([s0] * E), 0.4, 0.7)
    z = te.make_ensemble_expectation_fn(spec, _Z, real_output=True)(estate)
    # identical initial states + shared angles → identical realizations
    np.testing.assert_allclose(z[0].numpy(), z[1].numpy(), atol=1e-12)
    single, _ = layer(s0, 0.4, 0.7)
    np.testing.assert_allclose(
        z[0].numpy(), tt.local_expectations(spec, single, _Z).real.numpy(),
        atol=1e-12)


def test_torch_ensemble_per_member_bp_stopping_matches_jax(monkeypatch):
    """A nonzero BP tolerance: the members' refreshes converge after
    different numbers of sweeps, and each member must stop at its own
    sweep, as ``jax.vmap`` of the reference's while loop does.  The port's
    folded ensemble against JAX's ``ensemble_fn`` on the same carried-across
    states and per-member angles."""
    chi, E, tol = 3, 3, 1e-7
    (g_j, spec_j, s_j), (g_t, spec_t, s_t) = _start(
        lambda lat: lat.named_grid((3, 3)), chi)
    kw = dict(bp_maxiter=40, bp_tolerance=tol)
    _, layer_j = jp.make_field_layer_fn(g_j, chi=chi, spec=spec_j, **kw)
    _, layer_t = tt.parallel.make_field_layer_fn(g_t, chi=chi, spec=spec_t,
                                                 **kw)
    V, Eb = spec_t.num_vertices, len(spec_t.edges)
    rng = np.random.default_rng(5)
    # weak, medium and strong fields: BP needs more sweeps as they grow
    scale = np.array([0.05, 0.4, 1.2])[:, None]
    site = scale * rng.uniform(0.5, 1.0, size=(E, V))
    bond = scale * rng.uniform(0.5, 1.0, size=(E, Eb))

    refreshes = []  # per BP refresh, the per-member distance of each sweep
    measure, refresh = t_engine._message_distance, te.bp_update

    def recorded_distance(a, b, mask, members=1):
        out = measure(a, b, mask, members)
        refreshes[-1].append(out.clone())
        return out

    def recorded_refresh(*args, **kwargs):
        refreshes.append([])
        return refresh(*args, **kwargs)

    monkeypatch.setattr(t_engine, "_message_distance", recorded_distance)
    monkeypatch.setattr(te, "bp_update", recorded_refresh)
    est_t, est_j = te.stack_states([s_t] * E), jp.stack_states([s_j] * E)
    for _ in range(3):  # the first layer's refreshes are exact at once
        est_t, err_t = te.ensemble_fn(layer_t)(
            est_t, torch.from_numpy(site), torch.from_numpy(bond))
        est_j, err_j = jp.ensemble_fn(layer_j)(
            est_j, jnp.asarray(site), jnp.asarray(bond))
    monkeypatch.undo()

    # the sweep at which each member stopped, per refresh: the first sweep
    # whose distance fell to the tolerance (the loop ends with the last)
    stops = [tuple(next((i for i, d in enumerate(sweeps) if float(d[e]) <= tol),
                        None) for e in range(E))
             for sweeps in refreshes]
    assert any(len(set(s)) > 1 for s in stops), stops

    # observables and truncation errors (raw tensors and messages carry the
    # bond-gauge freedom of the splits, so they are not compared)
    for op in (_Z, op_matrix("X", 2)):
        z_j = np.real(np.asarray(jp.make_ensemble_expectation_fn(spec_j, op)(
            est_j)))
        z_t = te.make_ensemble_expectation_fn(spec_t, op, real_output=True)(
            est_t).numpy()
        np.testing.assert_allclose(z_t, z_j, atol=1e-8)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), atol=1e-8)


@pytest.mark.parametrize("uniform", [True, False])
def test_torch_ensemble_of_compiled_layer_matches_jax(uniform):
    """``ensemble_fn`` over a `make_layer_fn` layer: distinct initial states
    per member, BP at a nonzero tolerance, against JAX's vmapped layer and
    the port's single runs.  ``uniform=False`` gives every edge its own
    gate (the per-bucket gate path)."""
    from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs

    chi, starts = 3, ("↑", "X+", "y-")
    rng = np.random.default_rng(29)

    def circuit(graphs, g):
        layer = [("Rx", [v], 0.6) for v in g.vertices()]
        for grp in graphs.edge_color(g, 4):
            layer += [("Rzz", pair, 0.5 if uniform else
                       float(rng.uniform(0.3, 1.2))) for pair in grp]
        return layer

    kw = dict(chi=chi, cutoff=1e-12, bp_maxiter=40, bp_tolerance=1e-9)
    g_j = j_lat.named_grid((3, 3))
    states_j = [jp.batched_product_state(g_j, chi=chi, dtype=np.complex128,
                                         state_fn=lambda v, s=s: s)
                for s in starts]
    spec_j = states_j[0][0]
    layer_j = jp.make_layer_fn(jp.BatchedCircuit(circuit(j_graphs, g_j), g_j,
                                                 spec=spec_j), **kw)
    rng = np.random.default_rng(29)  # the same per-edge angles for the port
    g_t = tt.named_grid((3, 3))
    states_t = [tt.batched_product_state(g_t, chi=chi, dtype=torch.complex128,
                                         state_fn=lambda v, s=s: s)
                for s in starts]
    spec_t = states_t[0][0]
    layer_t = tt.make_layer_fn(tt.BatchedCircuit(circuit(tt, g_t), g_t,
                                                 spec=spec_t), **kw)

    est_j = jp.stack_states([st for _, st in states_j])
    est_t = te.stack_states([st for _, st in states_t])
    for _ in range(2):
        est_j, err_j = jp.ensemble_fn(layer_j)(est_j)
        est_t, err_t = te.ensemble_fn(layer_t)(est_t)
    z_j = np.real(np.asarray(jp.make_ensemble_expectation_fn(spec_j, _Z)(
        est_j)))
    z_t = te.make_ensemble_expectation_fn(spec_t, _Z, True)(est_t).numpy()
    np.testing.assert_allclose(z_t, z_j, atol=1e-8)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), atol=1e-8)
    for e, (_, st) in enumerate(states_t):
        for _ in range(2):
            st, errs = layer_t(st)
        np.testing.assert_allclose(
            z_t[e], tt.local_expectations(spec_t, st, _Z).real.numpy(),
            atol=1e-10)
        np.testing.assert_allclose(err_t[e].numpy(), errs.numpy(), atol=1e-10)


def test_torch_stacked_states_cross_both_ways():
    """A JAX ``stack_states`` ensemble crosses into the port and back."""
    (_, spec_j, s_j), _ = _start(lambda lat: lat.named_grid((2, 2)), 2)
    rng = np.random.default_rng(1)
    members = [s_j._replace(tensors=s_j.tensors + 0.1 * i
                            * rng.standard_normal(s_j.tensors.shape))
               for i in range(3)]
    est_j = jp.stack_states(members)
    est_t = tt.parallel.state_from_numpy(np.asarray(est_j.tensors),
                                         np.asarray(est_j.messages))
    assert est_t.tensors.shape == tuple(est_j.tensors.shape)
    for i, single in enumerate(te.unstack_states(est_t)):
        np.testing.assert_array_equal(single.tensors.numpy(),
                                      np.asarray(members[i].tensors))
    back_t, back_m = tt.parallel.state_to_numpy(
        te.stack_states(te.unstack_states(est_t)))
    for i, single in enumerate(jp.unstack_states(
            jp.BatchedState(jnp.asarray(back_t), jnp.asarray(back_m)))):
        np.testing.assert_array_equal(np.asarray(single.tensors),
                                      np.asarray(members[i].tensors))


@pytest.mark.parametrize("module", [
    "tensornetworkquantumsimulator_torch.microbench",
    "tensornetworkquantumsimulator_torch.models.channels",
    "tensornetworkquantumsimulator_torch.parallel.cuda_matmul",
    "tensornetworkquantumsimulator_torch.parallel.ensemble",
    "tensornetworkquantumsimulator_torch.parallel.overlap",
])
def test_torch_new_modules_import_without_jax(module):
    code = (f"import sys, importlib; importlib.import_module({module!r})\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
