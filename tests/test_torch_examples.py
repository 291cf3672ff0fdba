"""The examples that loop corrections and the variational module unlock,
driven through the PyTorch port and held against the example's own
``main()`` run through the JAX package at the same arguments.

Each test writes the example's program with the port's names (same lattice,
χ, dtype, noise and optimizer settings, fewer steps where the example runs
many) and compares what ``main()`` returns, or the numbers it prints.  Both
sides run the example's single precision (complex64 or float32), so the
bars are those of two equivalent 32-bit programs."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.utils.lattices import named_comb_tree

torch.set_num_threads(1)
_EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", _EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noised(spec, state, eps, seed, complex_noise):
    """The examples' symmetry-breaking noise on the valid block (dummy
    slots keep bond dimension 1), as numpy on the port's state."""
    rng = np.random.default_rng(seed)
    t = state.tensors.numpy()
    noise = rng.normal(size=t.shape)
    if complex_noise:
        noise = noise + 1j * rng.normal(size=t.shape)
    else:
        noise = noise.astype(t.dtype)
    mask = np.asarray(spec.mask_array())
    for k in range(spec.degree):
        idx = [slice(None)] * t.ndim
        idx[1 + k] = slice(1, None)
        noise[tuple(idx)] *= mask[:, k][(slice(None),) + (None,) * (t.ndim - 1)]
    return state._replace(
        tensors=torch.from_numpy((t + eps * noise).astype(t.dtype)))


def test_torch_example_batched_gauge_loopcorrections(capsys):
    """examples/batched_gauge_loopcorrections.py at its defaults (4×4 TFIM,
    5 layers, χ=4, complex64): plaquette count, relative loop correction to
    Z_BP and the range of bond entanglement entropies."""
    nl, nx, ny, chi = 5, 4, 4, 4
    _example("batched_gauge_loopcorrections").main(nl=nl, nx=nx, ny=ny,
                                                   chi=chi)
    out = capsys.readouterr().out
    n_ref = int(re.search(r"chi=\d+: (\d+) plaquettes", out).group(1))
    rel_ref = float(re.search(r"to Z_BP: (\S+)", out).group(1))
    lo_ref, hi_ref = map(float, re.search(
        r"bonds: min (\S+), max (\S+)", out).groups())

    g = tt.named_grid((nx, ny))
    dt, hx, hz, J = 0.25, 1.0, 0.8, 0.5
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    spec, state = tt.batched_product_state(g, chi=chi, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec),
                                chi=chi, cutoff=1e-10, jit=True)
    for _ in range(nl):
        state, _errs = layer_fn(state)
    state = tt.bp_update(spec, state, maxiter=50)
    plaquettes = tp.find_plaquettes(spec, g)
    zbp = tp.batched_partitionfunction(spec, state)
    zlc = tp.batched_loopcorrected_partitionfunction(spec, state, g,
                                                     plaquettes)
    rel = float(torch.abs(zlc / zbp - 1.0))
    _, spectra = tp.batched_symmetric_gauge(spec, state)
    s = spectra.numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.sum(np.where(s > 1e-12, s**2 * np.log(s**2), 0.0),
                      axis=-1) / np.maximum(np.sum(s**2, axis=-1), 1e-30)

    assert sum(b[1].shape[0] for b in plaquettes) == n_ref == 9
    assert rel > 1e-4  # the loops matter after five layers
    np.testing.assert_allclose(rel, rel_ref, rtol=2e-3)
    np.testing.assert_allclose([ent.min(), ent.max()], [lo_ref, hi_ref],
                               atol=2e-4)


def test_torch_example_variational_ground_state():
    """examples/variational_ground_state.py (3×3 TFIM, χ=4, float32,
    12 damped sweeps per evaluation) for 10 Adam steps."""
    steps = 10
    e_ref = _example("variational_ground_state").main(steps=steps)

    g = tt.named_grid((3, 3))
    spec, state = tt.batched_product_state(g, chi=4, dtype=torch.float32)
    state = _noised(spec, state, 0.1, seed=0, complex_noise=False)
    state, energies = tp.ground_state(
        spec, state, tp.tfim_hamiltonian(J=1.0, hx=3.0), steps=steps,
        learning_rate=3e-2, bp_sweeps_per_eval=12, damping=0.1)
    assert energies.shape == (steps,) and torch.isfinite(energies).all()
    assert float(energies[-1]) < float(energies[0])
    np.testing.assert_allclose(float(energies[-1]), e_ref, rtol=1e-4)


def test_torch_example_excited_states():
    """examples/excited_states.py (6-site comb tree, χ=4, complex64):
    ground state then the penalized first excited state, 10 and 20 steps."""
    steps = 10
    e0_ref, e1_ref, pen_ref, levels = _example("excited_states").main(
        steps=steps)

    g = named_comb_tree((2, 3))
    ham = tp.tfim_hamiltonian(J=1.0, hx=2.0)
    spec, s0 = tt.batched_product_state(g, chi=4, dtype=torch.complex64)
    gs, e_traj = tp.ground_state(
        spec, _noised(spec, s0, 0.3, 1, True), ham, steps=steps,
        learning_rate=3e-2, bp_sweeps_per_eval=12)
    _, e1_traj, pen_traj = tp.excited_state(
        spec, _noised(spec, s0, 0.3, 7, True), ham, below=[gs], weight=20.0,
        steps=2 * steps, learning_rate=2e-2, bp_sweeps_per_eval=12)
    e0, e1, pen = (float(x[-1]) for x in (e_traj, e1_traj, pen_traj))
    assert levels[0] < e0 and levels[0] < e1  # variational bounds
    np.testing.assert_allclose([e0, e1], [e0_ref, e1_ref], rtol=1e-4)
    np.testing.assert_allclose(pen, pen_ref, rtol=1e-2, atol=1e-5)


# ---------------------------------------------------------------------------
# examples of the generic engine
# ---------------------------------------------------------------------------


def _numbers(pattern, out):
    return [complex(m) for m in re.findall(pattern, out)]


def test_torch_example_ising_2d_heisenberg(capsys):
    """examples/ising_2d_heisenberg.py (4×4, χ=4, complex64, Pauli basis)
    for 2 of its 5 Trotter steps: per step the Frobenius norm, both traces
    and the largest gate error."""
    steps, chi = 2, 4
    _example("ising_2d_heisenberg").main(no_trotter_steps=steps, chi=chi)
    out = capsys.readouterr().out
    norm_ref = _numbers(r"Frobenius norm of O\(t\): (\S+)", out)
    tr_ref = _numbers(r"Trace\(O\(t\)\):\s+(\S+)", out)
    tr0_ref = _numbers(r"Trace\(O\(t\)O\(0\)\):\s+(\S+)", out)
    err_ref = _numbers(r"Max gate error:\s+(\S+)", out)

    g = tt.named_grid((4, 4))
    vz = g.center()[0]
    psi0 = tt.paulitensornetworkstate(
        torch.complex64, lambda v: "Z" if v == vz else "I", g)
    h, J, dt = -1.0, -1.0, 0.04
    layer = [("Rz", [v], h * dt) for v in g.vertices()]
    for colored_edges in tt.edge_color(g, 4):
        layer += [("Rxx", pair, 2 * J * dt) for pair in colored_edges]
    layer += [("Rz", [v], h * dt) for v in g.vertices()]
    layer = list(reversed(layer))
    psi_bpc = tt.BeliefPropagationCache(psi0.copy()).update()
    norms, trs, tr0s, errs = [], [], [], []
    for _ in range(steps):
        psi_bpc, e = tt.apply_gates(
            layer, psi_bpc,
            apply_kwargs=dict(maxdim=chi, cutoff=1e-12,
                              normalize_tensors=False))
        psi_bpc = psi_bpc.rescale()
        norms.append(psi_bpc.partitionfunction())
        psi = psi_bpc.network()
        trs.append(tt.inner(psi, tt.identitytensornetworkstate(
            g, psi.siteinds()), alg="bp"))
        tr0s.append(tt.inner(psi, psi0, alg="bp"))
        errs.append(np.max(e))
    assert len(norm_ref) == steps
    np.testing.assert_allclose(norms, norm_ref, atol=2e-6)  # printed .6f
    np.testing.assert_allclose(trs, tr_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr0s, tr0_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(errs, err_ref, rtol=1e-2, atol=1e-9)


def _table(out, ncols):
    rows = []
    for line in out.splitlines():
        parts = line.split()
        try:
            rows.append([float(p) for p in parts])
        except ValueError:
            continue
    return np.array([r for r in rows if len(r) == ncols])


def _lindblad_layer(g, dt, h=1.0, J=1.0, gamma=0.15, kappa=0.05):
    layer = [("Rx", [v], 2 * h * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    layer += [("amplitude_damping", [v], 1 - np.exp(-gamma * dt))
              for v in g.vertices()]
    layer += [("dephasing", [v], (1 - np.exp(-2 * kappa * dt)) / 2)
              for v in g.vertices()]
    return layer


def test_torch_example_lindblad_dynamics(capsys):
    """examples/lindblad_dynamics.py (4×4, χ=8, float64, d=4 channels) for
    3 of its 20 steps: ⟨Z⟩ mean, purity and truncation error per step."""
    dt, steps, chi = 0.05, 3, 8
    _example("lindblad_dynamics").main(t_final=steps * dt, dt=dt, chi=chi)
    ref = _table(capsys.readouterr().out, 4)

    g = tt.named_grid((4, 4))
    layer = _lindblad_layer(g, dt)
    rho = tt.density_matrix_tensornetworkstate(torch.float64, lambda v: "0", g)
    obs = [("Z", [v]) for v in g.vertices()]
    rows = []
    for s in range(steps):
        rho, errs = tt.apply_circuit(
            layer, rho, apply_kwargs=dict(maxdim=chi, cutoff=1e-12,
                                          normalize_tensors=False))
        z = np.real(tt.pauli_expectation(rho, obs, alg="bp"))
        rows.append([(s + 1) * dt, np.mean(z), tt.purity(rho, alg="bp"),
                     max(float(e) for e in errs)])
    rows = np.array(rows)
    assert ref.shape == rows.shape == (steps, 4)
    np.testing.assert_allclose(rows[:, :3], ref[:, :3], atol=2e-6)
    np.testing.assert_allclose(rows[:, 3], ref[:, 3], rtol=1e-2, atol=1e-12)


def test_torch_example_thermal_states(capsys):
    """examples/thermal_states.py (4×4, χ=8, float64, imaginary-time
    ``"map"`` gates) for 2 of its 16 Strang steps: E/site, ⟨X⟩, S2/site and
    truncation error per step."""
    dtau, steps, chi, h, J = 0.05, 2, 8, 1.0, 1.0
    _example("thermal_states").main(beta_max=2 * dtau * steps, dtau=dtau,
                                    chi=chi)
    ref = _table(capsys.readouterr().out, 5)

    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    g = tt.named_grid((4, 4))
    verts = list(g.vertices())
    half = [("map", [v], tt.imaginary_time_kraus(-h * X, dtau / 2))
            for v in verts]
    layer = list(half)
    for group in tt.edge_color(g, 4):
        layer += [("map", pair, tt.imaginary_time_kraus(-J * np.kron(Z, Z),
                                                        dtau))
                  for pair in group]
    layer += half
    rho = tt.density_matrix_tensornetworkstate(torch.float64,
                                               lambda v: "mixed", g)
    obs_x = [("X", [v]) for v in verts]
    obs_zz = [("ZZ", [e.src, e.dst]) for e in g.edges()]
    rows = []
    for s in range(steps):
        rho, errs = tt.apply_circuit(
            layer, rho, apply_kwargs=dict(maxdim=chi, cutoff=1e-12,
                                          normalize_tensors=True))
        xs = np.real(tt.pauli_expectation(rho, obs_x, alg="bp"))
        zzs = np.real(tt.pauli_expectation(rho, obs_zz, alg="bp"))
        energy = (-J * np.sum(zzs) - h * np.sum(xs)) / len(verts)
        s2 = -np.log2(tt.purity(rho, alg="bp")) / len(verts)
        rows.append([2 * dtau * (s + 1), energy, np.mean(xs), s2,
                     max((float(e) for e in errs), default=0.0)])
    rows = np.array(rows)
    assert ref.shape == rows.shape == (steps, 5)
    np.testing.assert_allclose(rows[:, :4], ref[:, :4], atol=2e-6)
    np.testing.assert_allclose(rows[:, 4], ref[:, 4], rtol=1e-2, atol=1e-12)
