"""The port's examples (``tensornetworkquantumsimulator_torch.examples``),
each run on the CPU and held against the JAX example's ``main()`` at the
same reduced arguments.

Each test calls both ``main()``s, reads both printed outputs with the same
regular expressions (the port module's ``read``), and compares the numbers
(and what ``main()`` returns) against the test's bars.  Where the printed digits are as coarse
as a bar, the port's value is recorded unrounded at the call that makes
it and held to the JAX example's printed one.  Both sides run the
example's single precision (complex64 or float32), so the bars are those
of two equivalent 32-bit programs.  Random states and random samples
cannot match JAX's streams: the JAX example's random states are carried
into the port through its ``random_tensornetworkstate``, and the port's
samples are checked for shape and sign only."""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device

torch.set_num_threads(1)
_EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _example(name):
    """The JAX example, loaded from ``examples/``."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", _EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return importlib.import_module(
        f"tensornetworkquantumsimulator_torch.examples.{name}")


def _run(capsys, name, **kw):
    """(what the JAX ``main`` returns, its output, what the port's returns,
    its output), both at arguments ``kw``, the port on the CPU."""
    ref = _example(name).main(**kw)
    out_ref = capsys.readouterr().out
    got = _port(name).main(**kw, device="cpu")
    return ref, out_ref, got, capsys.readouterr().out


def _record(monkeypatch, mod, name, factory=False):
    """Replace ``mod.name`` by a wrapper that records what each call
    returns (with ``factory``: what each call of each function it builds
    returns); yields the list of records."""
    seen = []
    fn = getattr(mod, name)

    def made(*a, **k):
        out = fn(*a, **k)
        if not factory:
            seen.append(out)
            return out

        def inner(*a2, **k2):
            res = out(*a2, **k2)
            seen.append(res)
            return res
        return inner

    monkeypatch.setattr(mod, name, made)
    return seen


def _read(name, *texts):
    """Each output read by the port module's ``read`` (the JAX example
    prints the same lines)."""
    return [_port(name).read(t) for t in texts]


def test_torch_example_batched_gauge_loopcorrections(capsys):
    """examples/batched_gauge_loopcorrections.py at its defaults (4×4 TFIM,
    5 layers, χ=4, complex64): plaquette count, relative loop correction to
    Z_BP and the range of bond entanglement entropies."""
    name = "batched_gauge_loopcorrections"
    _, out_ref, _, out = _run(capsys, name, nl=5, nx=4, ny=4, chi=4)
    ref, got = _read(name, out_ref, out)
    assert got["plaquettes"] == ref["plaquettes"] == [9]
    assert got["rel"] > 1e-4  # the loops matter after five layers
    np.testing.assert_allclose(got["rel"], ref["rel"], rtol=2e-3)
    assert len(got["ent"]) == len(ref["ent"]) == 2
    np.testing.assert_allclose(got["ent"], ref["ent"], atol=2e-4)


def test_torch_example_variational_ground_state(capsys):
    """examples/variational_ground_state.py (3×3 TFIM, χ=4, float32,
    12 damped sweeps per evaluation) for 10 Adam steps."""
    steps = 10
    e_ref, _, e, out = _run(capsys, "variational_ground_state", steps=steps)
    (got,) = _read("variational_ground_state", out)
    energies = got["energy"]
    assert isinstance(e, float) and list(got["final"]) == [float(f"{e:.6f}")]
    assert energies.shape == (steps,) and np.isfinite(energies).all()
    assert energies[-1] < energies[0]
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)


def test_torch_example_excited_states(capsys):
    """examples/excited_states.py (6-site comb tree, χ=4, complex64):
    ground state then the penalized first excited state, 10 and 20 steps."""
    (e0_ref, e1_ref, pen_ref, levels_ref), out_ref, got, out = _run(
        capsys, "excited_states", steps=10)
    e0, e1, pen, levels = got
    printed_ref, printed = _read("excited_states", out_ref, out)
    assert printed["exact"] == printed_ref["exact"]
    assert printed["variational"] == [float(f"{x:+.5f}") for x in (e0, e1)]
    np.testing.assert_allclose(levels.numpy(), levels_ref, rtol=1e-12)
    assert levels[0] < e0 and levels[0] < e1  # variational bounds
    np.testing.assert_allclose([e0, e1], [e0_ref, e1_ref], rtol=1e-4)
    np.testing.assert_allclose(pen, pen_ref, rtol=1e-2, atol=1e-5)


# ---------------------------------------------------------------------------
# examples of the generic engine
# ---------------------------------------------------------------------------


def test_torch_example_ising_2d_heisenberg(capsys):
    """examples/ising_2d_heisenberg.py (4×4, χ=4, complex64, Pauli basis)
    for 2 of its 5 Trotter steps: per step the Frobenius norm, both traces
    and the largest gate error."""
    steps = 2
    _, out_ref, _, out = _run(capsys, "ising_2d_heisenberg",
                              no_trotter_steps=steps, chi=4)
    ref, got = _read("ising_2d_heisenberg", out_ref, out)
    assert len(ref["norm"]) == len(got["norm"]) == steps
    np.testing.assert_allclose(got["norm"], ref["norm"], atol=2e-6)  # .6f
    np.testing.assert_allclose(got["trace"], ref["trace"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["trace0"], ref["trace0"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["err"], ref["err"], rtol=1e-2, atol=1e-9)


def test_torch_example_lindblad_dynamics(capsys):
    """examples/lindblad_dynamics.py (4×4, χ=8, float64, d=4 channels) for
    3 of its 20 steps: ⟨Z⟩ mean, purity and truncation error per step."""
    dt, steps = 0.05, 3
    _, out_ref, rho, out = _run(capsys, "lindblad_dynamics",
                                t_final=steps * dt, dt=dt, chi=8)
    ref, rows = (r["table"] for r in _read("lindblad_dynamics", out_ref, out))
    assert ref.shape == rows.shape == (steps, 4)
    assert rho.maxvirtualdim() <= 8
    np.testing.assert_allclose(rows[:, :3], ref[:, :3], atol=2e-6)
    np.testing.assert_allclose(rows[:, 3], ref[:, 3], rtol=1e-2, atol=1e-12)


def test_torch_example_thermal_states(capsys):
    """examples/thermal_states.py (4×4, χ=8, float64, imaginary-time
    ``"map"`` gates) for 2 of its 16 Strang steps: E/site, ⟨X⟩, S2/site and
    truncation error per step."""
    dtau, steps = 0.05, 2
    _, out_ref, rho, out = _run(capsys, "thermal_states",
                                beta_max=2 * dtau * steps, dtau=dtau, chi=8)
    ref, rows = (r["table"] for r in _read("thermal_states", out_ref, out))
    assert ref.shape == rows.shape == (steps, 5)
    assert rho.maxvirtualdim() <= 8
    np.testing.assert_allclose(rows[:, :4], ref[:, :4], atol=2e-6)
    np.testing.assert_allclose(rows[:, 4], ref[:, 4], rtol=1e-2, atol=1e-12)


# ---------------------------------------------------------------------------
# the examples of the generic engine's second half, and the batched-engine
# examples (at the reduced arguments of tests/test_examples.py)
# ---------------------------------------------------------------------------


def test_torch_example_ising_2d_dynamics(capsys):
    """examples/ising_2d_dynamics.py at 4×4, χ=3, 2 layers, boundary-MPS
    rank 3: each layer's largest gate error and BP ⟨Z⟩ at (3, 3), then the
    generic engine's boundary-MPS ⟨Z⟩ on the unpacked state."""
    _, out_ref, _, out = _run(capsys, "ising_2d_dynamics", nl=2, nx=4, ny=4,
                              chi=3, mps_bond_dimension=3)
    ref, got = _read("ising_2d_dynamics", out_ref, out)
    assert len(got["z"]) == len(ref["z"]) == 2
    assert len(got["bmps"]) == len(ref["bmps"]) == 1
    np.testing.assert_allclose(got["z"], ref["z"], atol=1e-4)
    np.testing.assert_allclose(got["err"], ref["err"], rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(got["bmps"], ref["bmps"], atol=1e-4)
    assert abs(got["bmps"][0] - got["z"][-1]) < 1e-2  # BP and BMPS agree


def test_torch_example_ising_3d_dynamics(capsys):
    """examples/ising_3d_dynamics.py (3×3×3 torus, 7 colours, χ=2) for one
    step: the centre's ⟨Z⟩ before and after, and the gate error."""
    _, out_ref, _, out = _run(capsys, "ising_3d_dynamics",
                              no_trotter_steps=1, chi=2)
    ref, got = _read("ising_3d_dynamics", out_ref, out)
    assert len(got["z0"]) == len(got["z"]) == len(got["err"]) == 1
    np.testing.assert_allclose([got["z0"], got["z"]], [ref["z0"], ref["z"]],
                               atol=1e-4)
    np.testing.assert_allclose(got["err"], ref["err"], rtol=2e-2, atol=1e-7)


def test_torch_example_heavyhex_ising_dynamics(capsys, monkeypatch):
    """examples/heavyhex_ising_dynamics.py on the 2×2 heavy-hex at χ=3 for
    2 steps: layer fidelities, BP and boundary-MPS magnetisation; the
    certified sampler's 2 samples are drawn from the port's own generator
    (the bits differ from JAX's keys), so only their p/q are checked
    finite and positive."""
    name = "heavyhex_ising_dynamics"
    sampled = _record(monkeypatch, _port(name),
                      "make_planar_certified_sampler", factory=True)
    _, out_ref, _, out = _run(capsys, name, hx=2, hy=2, no_trotter_steps=2,
                              chi=3, nsamples=2)
    ref, got = _read(name, out_ref, out)
    assert len(got["fid"]) == 2 and len(got["bp"]) == len(got["bmps"]) == 1
    np.testing.assert_allclose(got["fid"], ref["fid"], atol=2e-5)
    np.testing.assert_allclose(got["bp"], ref["bp"], atol=1e-4)
    np.testing.assert_allclose(got["bmps"], ref["bmps"], atol=1e-4)
    ((bits, logq, log_poverq),) = sampled
    assert bits.shape == (2, 35)
    assert torch.isfinite(log_poverq).all() and (logq < 0).all()
    assert np.isfinite(got["pq_std"]).all() and abs(got["sampled"][0]) <= 1.0


def _random_states_of(example, dtype_j):
    """The random states an example draws after ``tnqs.seed(1634)``, in its
    order, carried into the port."""
    import tensornetworkquantumsimulator_tpu as tnqs
    from tensornetworkquantumsimulator_torch.models import state_from_numpy

    from generic_carry import plain

    tnqs.seed(1634)
    return [state_from_numpy(plain(tnqs.random_tensornetworkstate(
        dtype_j, g, "S=1/2", bond_dimension=bond))) for g, bond in example]


def _carried(monkeypatch, name, states):
    """The port example ``name`` with its random states replaced by
    ``states``, handed out in order (each checked against the graph and
    bond dimension the example asks for); returns the states not yet
    handed out."""
    mod = _port(name)
    queue = list(states)

    def drawn(dtype, g, siteinds, bond_dimension, device=None):
        psi = queue.pop(0)
        assert set(psi.vertices()) == set(g.vertices())
        assert psi.maxvirtualdim() == bond_dimension
        assert psi[next(iter(psi.vertices()))].dtype == dtype
        return psi

    monkeypatch.setattr(mod, "random_tensornetworkstate", drawn)
    return queue


def test_torch_example_boundarymps_convergence(capsys, monkeypatch):
    """examples/boundarymps_convergence.py (complex64, χ=2; line, 3×3
    hexagonal and 5×5 square): BP, ranks 1-16 and exact ⟨Z⟩ at the
    centre, and ⟨ZZ⟩ at rank 16, on the same random states."""
    import jax.numpy as jnp
    from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

    name = "boundarymps_convergence"
    graphs = [j_lat.named_grid((5, 1)),
              j_lat.named_hexagonal_lattice_graph(3, 3),
              j_lat.named_grid((5, 5))]
    left = _carried(monkeypatch, name, _random_states_of(
        [(g, 2) for g in graphs], jnp.complex64))
    _, out_ref, _, out = _run(capsys, name)
    assert not left
    ref, got = _read(name, out_ref, out)
    assert got["lattice"] == ref["lattice"] and len(got["z"]) == 3
    for g, z_ref, z, zz_ref, zz in zip(graphs, ref["z"], got["z"], ref["zz"],
                                       got["zz"]):
        assert len(z) == len(z_ref) == 7
        np.testing.assert_allclose(z, z_ref, atol=1e-4)
        assert len(zz) == len(zz_ref) == (0 if g.is_tree() else 2)
        if len(zz):
            np.testing.assert_allclose(zz[1], zz_ref[1], atol=1e-4)
            np.testing.assert_allclose(zz_ref[1], zz_ref[0], atol=1e-4)


def test_torch_example_loopcorrections(capsys, monkeypatch):
    """examples/loopcorrections.py (complex64, χ=3; line, 2×2 hexagonal,
    4×4 square): BP, loop-corrected and exact norms on the same random
    states; then ⟨Z⟩ at the 3×3 centre by "exact", "bp" and
    "loopcorrections" (size 6) and by the batched loop series."""
    import jax.numpy as jnp
    from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

    name = "loopcorrections"
    graphs = [j_lat.named_grid((4, 1)),
              j_lat.named_hexagonal_lattice_graph(2, 2),
              j_lat.named_grid((4, 4))]
    left = _carried(monkeypatch, name, _random_states_of(
        [(g, 3) for g in graphs] + [(j_lat.named_grid((3, 3)), 2)],
        jnp.complex64))
    _, out_ref, _, out = _run(capsys, name)
    assert not left
    ref, got = _read(name, out_ref, out)
    assert len(got["norm"]) == len(ref["norm"]) == 9
    np.testing.assert_allclose(got["norm"], ref["norm"], rtol=1e-4)
    assert len(got["centre"]) == len(ref["centre"]) == 4
    np.testing.assert_allclose(got["centre"], ref["centre"], atol=2e-6 + 1e-4)


def test_torch_example_noisy_circuit(capsys, monkeypatch):
    """examples/noisy_circuit.py at 3×3, 2 layers: the generic engine's
    ⟨Z⟩ mean and purity per layer (float64), then the batched engine's
    ⟨Z⟩ mean and purity (complex64) and the noise-rate sweep; samples are
    checked for shape and log-probabilities ≤ 0 (the draws are the port's
    own).  The sweep prints to 1e-4, as coarse as its bar, so the port's
    batched ⟨Z⟩ means are also recorded unrounded."""
    mod = _port("noisy_circuit")
    generic = _record(monkeypatch, mod, "sample_density_matrix")
    batched = _record(monkeypatch, mod, "make_rho_sampler", factory=True)
    expects = _record(monkeypatch, mod, "make_pauli_expectation_fn",
                      factory=True)
    _, out_ref, rho, out = _run(capsys, "noisy_circuit", nx=3, ny=3, layers=2)
    ref, got = _read("noisy_circuit", out_ref, out)
    assert got["table"].shape == ref["table"].shape == (2, 3)
    np.testing.assert_allclose(got["table"], ref["table"], atol=2e-6)
    (samples,) = generic
    assert len(samples) == 5 and all(s["logp"] <= 1e-12 for s in samples)
    assert got["samples"].shape == got["batched_samples"].shape == (5, 2)
    assert rho.maxvirtualdim() <= 8
    np.testing.assert_allclose(got["zb"], ref["zb"], atol=1e-4)
    np.testing.assert_allclose(got["pb"], ref["pb"], atol=1e-4)
    ((bits, logps),) = batched
    assert bits.shape == (5, 9) and (logps <= 1e-5).all()
    zb, *sweep = (float(e["Z"].mean()) for e in expects)
    assert list(got["zb"]) == [float(f"{zb:+.6f}")]
    np.testing.assert_allclose(zb, ref["zb"], atol=1e-4)
    assert len(sweep) == len(got["sweep"]) == len(ref["sweep"]) == 4
    assert list(got["sweep"]) == [float(f"{z:+.4f}") for z in sweep]
    np.testing.assert_allclose(sweep, ref["sweep"], atol=1e-4 + 5e-5)


def test_torch_example_tfim_ground_state(capsys):
    """examples/tfim_ground_state.py (3×3, χ=4, complex64, imaginary time)
    for 50 steps: the energy printed every 25 steps and returned."""
    e_ref, out_ref, e, out = _run(capsys, "tfim_ground_state", nsteps=50)
    ref, got = _read("tfim_ground_state", out_ref, out)
    assert len(got["energy"]) == len(ref["energy"]) == 2
    assert isinstance(e, float)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-4)
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)


def test_torch_example_loschmidt_echo(capsys, monkeypatch):
    """examples/loschmidt_echo.py (4×4, χ=3, complex64) for 2 steps:
    log|echo| and the rate function per step.  log|echo| prints to 1e-4,
    the bar, so the port's is also held unrounded."""
    echoes = _record(monkeypatch, _port("loschmidt_echo"),
                     "batched_loschmidt_echo")
    _, out_ref, _, out = _run(capsys, "loschmidt_echo", steps=2, chi=3)
    ref, printed = _read("loschmidt_echo", out_ref, out)
    got = [float(log_abs) for log_abs, _ in echoes]
    assert len(got) == len(printed["log_echo"]) == len(ref["log_echo"]) == 2
    assert list(printed["log_echo"]) == [float(f"{x:+.4f}") for x in got]
    np.testing.assert_allclose(got, ref["log_echo"], atol=1e-4)
    np.testing.assert_allclose(printed["rate"], ref["rate"], atol=1e-4)


def test_torch_example_correlation_functions(capsys):
    """examples/correlation_functions.py (5×5, χ=3, complex64) for 2
    layers: the connected correlators along row 3 per layer, then the
    boundary-MPS ⟨ZZ⟩ of the same and two cross-row pairs."""
    _, out_ref, _, out = _run(capsys, "correlation_functions", steps=2, chi=3)
    ref, got = _read("correlation_functions", out_ref, out)
    assert got["corr"].shape == ref["corr"].shape == (2, 4)
    assert got["bmps"].shape == ref["bmps"].shape == (6,)
    np.testing.assert_allclose(got["corr"], ref["corr"], atol=1e-4)
    np.testing.assert_allclose(got["bmps"], ref["bmps"], atol=1e-4)


def test_torch_example_disorder_ensemble(capsys):
    """examples/disorder_ensemble.py (3×3, χ=2, 2 layers, 3 realizations):
    the disorder-averaged ⟨Z⟩ per layer, from the example's own numpy
    draws of fields and couplings."""
    zbar_ref, out_ref, zbar, out = _run(capsys, "disorder_ensemble", nx=3,
                                        ny=3, chi=2, n_layers=2, n_ensemble=3)
    ref, got = _read("disorder_ensemble", out_ref, out)
    assert isinstance(zbar, torch.Tensor) and zbar.shape == (2,)
    np.testing.assert_allclose(zbar.numpy(), zbar_ref, atol=1e-4)
    assert got["zbar"].shape == ref["zbar"].shape == (2,)
    for k in ("zbar", "zstd"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4)


def test_torch_example_sharded_dynamics(capsys, monkeypatch):
    """examples/sharded_dynamics.py on 4 shards (JAX: 4 of its virtual CPU
    devices; the port: a ``ShardMesh`` of 4 ``cpu`` shards), 2 layers at
    χ=2, complex64: per-layer truncation error and centre ⟨Z⟩, mean ⟨ZZ⟩,
    the largest bond entropy (printed to 1e-4, the bar, so the port's is
    also read from the spectra it printed it from), the truncation error,
    the sharded boundary-MPS log|Z|, the loop-correction factor and the
    padded Eagle-127 ⟨Z⟩."""
    import jax

    S = 4
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:S])
    port = _port("sharded_dynamics")
    monkeypatch.setattr(port, "SHARDS", S)
    gauged = _record(monkeypatch, port, "make_sharded_gauge", factory=True)
    _, out_ref, _, out = _run(capsys, "sharded_dynamics", n_layers=2, chi=2)
    ref, got = _read("sharded_dynamics", out_ref, out)
    assert "4x4 grid over 4 devices" in out
    assert len(got["err"]) == len(ref["err"]) == len(got["z"]) == 2
    np.testing.assert_allclose(got["err"], ref["err"], atol=1e-6)
    np.testing.assert_allclose(got["z"], ref["z"], atol=1e-5)
    np.testing.assert_allclose(got["zz"], ref["zz"], atol=1e-5)
    ((_, spectra),) = gauged
    ent = spectra.numpy()
    ent = ent / ent.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        sv = -np.nansum(np.where(ent > 0, ent * np.log(ent), 0.0), axis=1)
    assert list(got["ent"]) == [float(f"{sv.max():.4f}")]
    np.testing.assert_allclose(sv.max(), ref["ent"], atol=1e-4)
    np.testing.assert_allclose(got["trunc"], ref["trunc"], atol=1e-6)
    np.testing.assert_allclose(got["lz"], ref["lz"], atol=1e-4)
    assert len(got["lc"]) == 1 and abs(got["lc"][0] - ref["lc"][0]) < 1e-6
    np.testing.assert_allclose(got["eagle"], ref["eagle"], atol=1e-5)
