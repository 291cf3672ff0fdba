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


# ---------------------------------------------------------------------------
# the examples of the generic engine's second half, and the batched-engine
# examples whose parts the port already had (at the reduced arguments of
# tests/test_examples.py)
# ---------------------------------------------------------------------------

_Z = np.diag([1.0, -1.0]).astype(np.complex64)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex64)
_F = r"[-+]?[0-9.]+(?:e[-+]?[0-9]+)?"
_C = r"\(?(" + _F + r"(?:[-+][0-9.]+(?:e[-+]?[0-9]+)?j)?)\)?"  # real or complex


def _tfim_layer(g, dt=0.25, hx=1.0, hz=0.8, J=0.5):
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    return layer


def test_torch_example_ising_2d_dynamics(capsys):
    """examples/ising_2d_dynamics.py at 4×4, χ=3, 2 layers, boundary-MPS
    rank 3: each layer's largest gate error and BP ⟨Z⟩ at (3, 3), then the
    generic engine's boundary-MPS ⟨Z⟩ on the unpacked state."""
    nl, chi, rank = 2, 3, 3
    _example("ising_2d_dynamics").main(nl=nl, nx=4, ny=4, chi=chi,
                                       mps_bond_dimension=rank)
    out = capsys.readouterr().out
    err_ref = _numbers(r"Maximum Gate error for layer was (\S+)", out)
    z_ref = _numbers(r"BP Measured Sigmaz is (\S+)", out)
    (bmps_ref,) = _numbers(r"Boundary MPS Measured Sigmaz is " + _C, out)

    g = tt.named_grid((4, 4))
    spec, state = tt.batched_product_state(g, chi=chi, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(_tfim_layer(g), g,
                                                  spec=spec),
                                chi=chi, cutoff=1e-10)
    z_fn = tt.make_expectation_fn(spec, tt.op_matrix("Z", 2),
                                  real_output=True)
    pos = spec.vertex_position((3, 3))
    errs, zs = [], []
    for _ in range(nl):
        state, e = layer_fn(state)
        errs.append(float(e.max()))
        zs.append(float(z_fn(state)[pos]))
    psi = tp.batched_to_tns(spec, state, g, tt.siteinds("S=1/2", g))
    bmps = tt.expect(psi, ("Z", [(3, 3)]), alg="boundarymps",
                     mps_bond_dimension=rank)
    np.testing.assert_allclose(zs, np.real(z_ref), atol=1e-4)
    np.testing.assert_allclose(errs, np.real(err_ref), rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(complex(bmps), bmps_ref, atol=1e-4)
    assert abs(complex(bmps) - zs[-1]) < 1e-2  # BP and BMPS agree here


def test_torch_example_ising_3d_dynamics(capsys):
    """examples/ising_3d_dynamics.py (3×3×3 torus, 7 colours, χ=2) for one
    step: the centre's ⟨Z⟩ before and after, and the gate error."""
    _example("ising_3d_dynamics").main(no_trotter_steps=1, chi=2)
    out = capsys.readouterr().out
    (z0_ref,) = _numbers(r"Initial Sigma Z on centre site: (\S+)", out)
    (err_ref,) = _numbers(r"max gate error (\S+),", out)
    (z1_ref,) = _numbers(r"Sigma z = (\S+)", out)

    g = tt.named_grid((3, 3, 3), periodic=True)
    h, J, dt = -1.0, -1.0, 0.04
    layer = [("Rz", [v], h * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 7):
        layer += [("Rxx", pair, 2 * J * dt) for pair in group]
    layer += [("Rz", [v], h * dt) for v in g.vertices()]
    spec, state = tt.batched_product_state(g, chi=2, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec),
                                chi=2, cutoff=1e-10)
    z_fn = tt.make_expectation_fn(spec, tt.op_matrix("Z", 2),
                                  real_output=True)
    pos = spec.vertex_position(g.center()[0])
    z0 = float(z_fn(state)[pos])
    state, e = layer_fn(state)
    np.testing.assert_allclose([z0, float(z_fn(state)[pos])],
                               np.real([z0_ref, z1_ref]), atol=1e-4)
    np.testing.assert_allclose(float(e.max()), np.real(err_ref), rtol=2e-2,
                               atol=1e-7)


def test_torch_example_heavyhex_ising_dynamics(capsys):
    """examples/heavyhex_ising_dynamics.py on the 2×2 heavy-hex at χ=3 for
    2 steps: layer fidelities, BP and boundary-MPS magnetisation; the
    certified sampler's 2 samples are drawn from the port's own generator
    (the bits differ from JAX's keys), so only their p/q are checked
    finite and positive."""
    _example("heavyhex_ising_dynamics").main(hx=2, hy=2, no_trotter_steps=2,
                                             chi=3, nsamples=2)
    out = capsys.readouterr().out
    fid_ref = _numbers(r"layer fidelity (\S+)", out)
    (bp_ref,) = _numbers(r"BP magnetisation on .*: (\S+)", out)
    (bmps_ref,) = _numbers(r"Boundary-MPS magnetisation on .*: (\S+)", out)

    g = tt.heavy_hexagonal_lattice(2, 2)
    J, theta = 3.14159 / 4, 0.4
    layer = [("Rx", [v], theta) for v in g.vertices()]
    for group in tt.edge_color(g, 3):
        layer += [("Rzz", pair, 2 * J) for pair in group]
    spec, state = tt.batched_product_state(g, chi=3, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec),
                                chi=3, cutoff=1e-12)
    fids = []
    for _ in range(2):
        state, errs = layer_fn(state)
        fids.append(float(np.prod(1.0 - errs.numpy())))
    c = spec.vertex_position(sorted(g.vertices())[len(g.vertices()) // 2])
    z_fn = tt.make_expectation_fn(spec, tt.op_matrix("Z", 2),
                                  real_output=True)
    gauged, _ = tp.batched_symmetric_gauge(spec, state)
    _, z_bmps_fn = tp.make_planar_bmps(spec, kmps=10, niters=20)
    z_bmps = z_bmps_fn(gauged.tensors, torch.as_tensor(_Z))
    np.testing.assert_allclose(fids, np.real(fid_ref), atol=2e-5)
    np.testing.assert_allclose(float(z_fn(state)[c]), np.real(bp_ref),
                               atol=1e-4)
    np.testing.assert_allclose(float(torch.real(z_bmps[c])),
                               np.real(bmps_ref), atol=1e-4)
    sampler = tp.make_planar_certified_sampler(spec, norm_rank=10,
                                               projected_rank=10, niters=12)
    bits, logq, log_poverq = sampler(gauged.tensors, 2,
                                     torch.Generator().manual_seed(0))
    assert bits.shape == (2, spec.num_vertices)
    assert torch.isfinite(log_poverq).all() and (logq < 0).all()


def _random_states_of(example, dtype_j):
    """The random states an example draws after ``tnqs.seed(1634)``, in its
    order, carried into the port."""
    import tensornetworkquantumsimulator_tpu as tnqs
    from tensornetworkquantumsimulator_torch.models import state_from_numpy

    from generic_carry import plain

    tnqs.seed(1634)
    out = []
    for g, bond, normalize in example:
        psi = tnqs.random_tensornetworkstate(dtype_j, g, "S=1/2",
                                             bond_dimension=bond)
        if normalize:
            psi = tnqs.normalize(psi, alg="bp")
        out.append(state_from_numpy(plain(psi)))
    return out


def test_torch_example_boundarymps_convergence(capsys):
    """examples/boundarymps_convergence.py (complex64, χ=2; line, 3×3
    hexagonal and 5×5 square): BP, ranks 1-16 and exact ⟨Z⟩ at the
    centre, and ⟨ZZ⟩ at rank 16, on the same random states."""
    import jax.numpy as jnp
    from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

    _example("boundarymps_convergence").main()
    out = capsys.readouterr().out
    blocks = out.split("Testing ")[1:]
    graphs = [j_lat.named_grid((5, 1)), j_lat.named_hexagonal_lattice_graph(3, 3),
              j_lat.named_grid((5, 5))]
    states = _random_states_of([(g, 2, False) for g in graphs], jnp.complex64)
    assert len(blocks) == 3
    for psi, block in zip(states, blocks):
        v = psi.graph().center()[0]
        ref = _numbers(r"(?:value for Z|rank \d+): " + _C, block)
        got = [tt.expect(psi, ("Z", v), alg="bp")]
        got += [tt.expect(psi, ("Z", v), alg="boundarymps",
                          mps_bond_dimension=r) for r in (1, 2, 4, 8, 16)]
        got += [tt.expect(psi, ("Z", v), alg="exact")]
        np.testing.assert_allclose(got, ref, atol=1e-4)
        zz = [complex(x) for m in re.findall(
            r"Exact ZZ: " + _C + r"\s+BMPS ZZ: " + _C, block) for x in m]
        if not psi.graph().is_tree():
            vn = psi.graph().neighbors(v)[0]
            np.testing.assert_allclose(
                [tt.expect(psi, ("ZZ", [v, vn]), alg="boundarymps",
                           mps_bond_dimension=16)], [zz[1]], atol=1e-4)
            np.testing.assert_allclose(zz[1], zz[0], atol=1e-4)


def test_torch_example_loopcorrections(capsys):
    """examples/loopcorrections.py (complex64, χ=3; line, 2×2 hexagonal,
    4×4 square): BP, loop-corrected and exact norms on the same random
    states; then ⟨Z⟩ at the 3×3 centre by "exact", "bp" and
    "loopcorrections" (size 6) and by the batched loop series."""
    import jax.numpy as jnp
    from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

    _example("loopcorrections").main()
    out = capsys.readouterr().out
    graphs = [(j_lat.named_grid((4, 1)), 0),
              (j_lat.named_hexagonal_lattice_graph(2, 2), 6),
              (j_lat.named_grid((4, 4)), 4)]
    states = _random_states_of([(g, 3, True) for g, _ in graphs] + [
        (j_lat.named_grid((3, 3)), 2, True)], jnp.complex64)
    norms = _numbers(r"norm:\s+" + _C, out)
    assert len(norms) == 9
    for k, (psi, (_, girth)) in enumerate(zip(states, graphs)):
        got = [tt.norm(psi, alg="bp"),
               tt.norm(psi, alg="loopcorrections",
                       max_configuration_size=max(2 * girth - 1, 0)),
               tt.norm(psi, alg="exact")]
        np.testing.assert_allclose(got, norms[3 * k:3 * k + 3], rtol=1e-4)
    psi = states[-1]
    v = list(psi.vertices())[4]
    m = re.search(r"exact (\S+)\s+bp (\S+)\s+loop-corrected (\S+)\s+"
                  r"batched (\S+)", out)
    ref = [float(x) for x in m.groups()]
    obs = ("Z", [v])
    cache = tt.BeliefPropagationCache(psi).update(maxiter=100, tolerance=1e-7)
    spec, state = tp.batched_from_tns(psi, chi=2, messages=cache.messages())
    fn = tp.make_loopcorrected_expectations(spec, psi.graph(), [obs],
                                            max_configuration_size=6)
    got = [complex(tt.expect(psi, obs, alg="exact")).real,
           complex(tt.expect(psi, obs, alg="bp")).real,
           complex(tt.expect(psi, obs, alg="loopcorrections",
                             max_configuration_size=6)).real,
           complex(fn(state)[0]).real]
    np.testing.assert_allclose(got, ref, atol=2e-6 + 1e-4)


def test_torch_example_noisy_circuit(capsys):
    """examples/noisy_circuit.py at 3×3, 2 layers: the generic engine's
    ⟨Z⟩ mean and purity per layer (float64), then the batched engine's
    ⟨Z⟩ mean and purity (complex64) and the noise-rate sweep; samples are
    checked for shape and log-probabilities ≤ 0 (the draws are the port's
    own)."""
    nx = ny = 3
    layers, dt, h, J, p_dep, gam = 2, 0.15, 1.0, 1.0, 0.02, 0.03
    _example("noisy_circuit").main(nx=nx, ny=ny, layers=layers)
    out = capsys.readouterr().out
    table = _table(out.split("samples from")[0], 3)
    (zb_ref,) = _numbers(r"batched engine <Z>_mean after \d+ layers: (\S+)",
                         out)
    (pb_ref,) = _numbers(r"batched engine purity after \d+ layers: (\S+)", out)
    sweep_ref = [float(x) for x in re.findall(
        r"'([-+0-9.]+)'", out.split("noise-rate sweep")[1])]

    g = tt.named_grid((nx, ny))
    layer = [("Rx", [v], 2 * h * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    layer += [("depolarizing", [v], p_dep) for v in g.vertices()]
    layer += [("amplitude_damping", [v], gam) for v in g.vertices()]
    rho = tt.density_matrix_tensornetworkstate(torch.float64, lambda v: "0", g)
    obs = [("Z", [v]) for v in g.vertices()]
    rows = []
    for t in range(layers):
        rho, _ = tt.apply_circuit(layer, rho, apply_kwargs=dict(
            maxdim=8, cutoff=1e-12, normalize_tensors=False))
        z = np.real(tt.pauli_expectation(rho, obs, alg="bp"))
        rows.append([t + 1, np.mean(z), tt.purity(rho, alg="bp")])
    np.testing.assert_allclose(np.array(rows), table, atol=2e-6)
    samples = tt.sample_density_matrix(rho, 5)
    assert len(samples) == 5 and all(s["logp"] <= 1e-12 for s in samples)

    chi = 8
    dm = tt.density_matrix_tensornetworkstate(torch.complex64, lambda v: "0", g)
    spec, state = tp.batched_from_tns(dm, chi=chi)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec, d=4,
                                                  picture="rho"),
                                chi=chi, cutoff=1e-10, normalize_tensors=False)
    expect_fn = tp.make_pauli_expectation_fn(spec, chi, torch.complex64)
    for _ in range(layers):
        state, _ = layer_fn(state)
    np.testing.assert_allclose(float(expect_fn(state)["Z"].mean()),
                               np.real(zb_ref), atol=1e-4)
    np.testing.assert_allclose(float(tp.batched_purity(spec, state)),
                               np.real(pb_ref), atol=1e-4)
    bits, logps = tp.make_rho_sampler(spec, chi, torch.complex64,
                                      refresh_iters=6)(state, 5)
    assert bits.shape == (5, spec.num_vertices) and (logps <= 1e-5).all()
    _, noisy_layer = tp.make_noisy_field_layer_fn(
        g, chi, noise=("depolarizing",), spec=spec, jit=False)
    rates = torch.tensor([0.0, p_dep, 2 * p_dep, 4 * p_dep])
    _, st0 = tp.batched_from_tns(dm, chi=chi)
    estate = tp.stack_states([st0] * len(rates))
    sweep = tp.ensemble_fn(noisy_layer, in_axes=(0, None, None, 0))
    for _ in range(layers):
        estate, _ = sweep(estate, 2 * h * dt, 2 * J * dt, rates)
    z_sweep = [float(expect_fn(st)["Z"].mean())
               for st in tp.unstack_states(estate)]
    np.testing.assert_allclose(z_sweep, sweep_ref, atol=1e-4 + 5e-5)


def test_torch_example_tfim_ground_state(capsys):
    """examples/tfim_ground_state.py (3×3, χ=4, complex64, imaginary time)
    for 50 steps: the energy printed every 25 steps and returned."""
    nsteps = 50
    e_ref = _example("tfim_ground_state").main(nsteps=nsteps)
    printed = _numbers(r"E = (\S+)", capsys.readouterr().out)

    g = tt.named_grid((3, 3))
    tau, hx, J = 0.05, 3.0, 1.0
    layer = [("Rx", [v], 2j * tau * hx) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2j * tau * J) for pair in group]
    spec, state = tt.batched_product_state(g, chi=4, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec),
                                chi=4, cutoff=1e-10, bp_maxiter=30)

    def energy(st):
        st = tt.bp_update(spec, st, maxiter=50, tolerance=1e-7)
        ex = tt.local_expectations(spec, st, tt.op_matrix("X", 2))
        ezz = tp.bond_expectations(spec, st, tt.op_matrix("Z", 2),
                                   tt.op_matrix("Z", 2))
        return float(torch.real(-hx * ex.sum() - J * ezz.sum()))

    es = []
    for step in range(1, nsteps + 1):
        state, _ = layer_fn(state)
        if step % 25 == 0:
            es.append(energy(state))
    np.testing.assert_allclose(es, np.real(printed), rtol=1e-4)
    np.testing.assert_allclose(energy(state), e_ref, rtol=1e-4)


def test_torch_example_loschmidt_echo(capsys):
    """examples/loschmidt_echo.py (4×4, χ=3, complex64) for 2 steps:
    log|echo| and the rate function per step."""
    steps, chi = 2, 3
    _example("loschmidt_echo").main(steps=steps, chi=chi)
    out = capsys.readouterr().out
    ref = np.real(_numbers(r"log\|echo\|=(\S+)", out))

    g = tt.named_grid((4, 4))
    dt, hx, J = 0.15, 1.0, 0.6
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    spec, s0 = tt.batched_product_state(g, chi=chi, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec),
                                chi=chi)
    log_norm0, _ = tp.batched_inner(spec, s0, s0, maxiter=60)
    st, got = s0, []
    for _ in range(steps):
        st, _ = layer_fn(st)
        log_abs, _ = tp.batched_loschmidt_echo(spec, s0, st,
                                               log_norm0=log_norm0, maxiter=60)
        got.append(float(log_abs))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_torch_example_correlation_functions(capsys):
    """examples/correlation_functions.py (5×5, χ=3, complex64) for 2
    layers: the connected correlators along row 3 per layer, then the
    boundary-MPS ⟨ZZ⟩ of the same and two cross-row pairs."""
    steps, chi = 2, 3
    _example("correlation_functions").main(steps=steps, chi=chi)
    out = capsys.readouterr().out
    corr_ref = np.real(_numbers(r"C\(\d\)=(\S+)", out)).reshape(steps, 4)
    bmps_ref = np.real(_numbers(r"\)=([-+][0-9.]+)", out.split(
        "boundary-MPS")[1]))

    g = tt.named_grid((5, 5))
    dt, hx, J = 0.2, 1.0, 0.5
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in group]
    spec, state = tt.batched_product_state(g, chi=chi, dtype=torch.complex64)
    layer_fn = tt.make_layer_fn(tt.BatchedCircuit(layer, g, spec=spec),
                                chi=chi, cutoff=1e-10)
    row = [(3, c) for c in range(1, 6)]
    pairs = [(row[0], v) for v in row[1:]]
    z = tt.op_matrix("Z", 2)
    corr_fn = tp.make_path_correlation_fn(spec, pairs, z, connected=True,
                                          real_output=True)
    got = []
    for _ in range(steps):
        state, _ = layer_fn(state)
        got.append(corr_fn(state).numpy())
    np.testing.assert_allclose(np.array(got), corr_ref, atol=1e-4)
    bmps_pairs = pairs + [(row[0], (r, 3)) for r in (4, 5)]
    bmps = tp.make_grid_bmps_correlations(spec, 5, 5, kmps=2 * chi,
                                          pairs=bmps_pairs, real_output=True)
    np.testing.assert_allclose(
        bmps(state.tensors, torch.as_tensor(_Z), torch.as_tensor(_Z)).numpy(),
        bmps_ref, atol=1e-4)


def test_torch_example_disorder_ensemble(capsys):
    """examples/disorder_ensemble.py (3×3, χ=2, 2 layers, 3 realizations):
    the disorder-averaged ⟨Z⟩ per layer, from the example's own numpy
    draws of fields and couplings."""
    nx = ny = 3
    chi, n_layers, n_ens, dt, seed = 2, 2, 3, 0.1, 0
    zbar_ref = _example("disorder_ensemble").main(
        nx=nx, ny=ny, chi=chi, n_layers=n_layers, n_ensemble=n_ens)

    g = tt.named_grid((nx, ny))
    spec, s0 = tt.batched_product_state(g, chi=chi, dtype=torch.complex64)
    _, layer = tp.make_field_layer_fn(g, chi=chi, spec=spec, bp_maxiter=20)
    elayer = tp.ensemble_fn(layer)
    expect_z = tp.make_ensemble_expectation_fn(spec, tt.op_matrix("Z", 2),
                                               real_output=True)
    V, E = spec.num_vertices, len(spec.edges)
    rng = np.random.default_rng(seed)
    site = torch.as_tensor(2 * dt * rng.uniform(0.5, 1.5, (n_ens, V)),
                           dtype=torch.float32)
    bond = torch.as_tensor(2 * dt * rng.uniform(0.8, 1.2, (n_ens, E)),
                           dtype=torch.float32)
    estate = tp.stack_states([s0] * n_ens)
    zbar = []
    for _ in range(n_layers):
        estate, _ = elayer(estate, site, bond)
        zbar.append(float(expect_z(estate).mean()))
    np.testing.assert_allclose(zbar, zbar_ref, atol=1e-4)
    capsys.readouterr()


def test_torch_example_sharded_dynamics(capsys, monkeypatch):
    """examples/sharded_dynamics.py on 4 shards (JAX: 4 of its virtual CPU
    devices; the port: a ``ShardMesh`` of 4 ``cpu`` shards), 2 layers at
    χ=2, complex64: per-layer truncation error and centre ⟨Z⟩, mean ⟨ZZ⟩,
    the largest bond entropy, the truncation error, the sharded boundary-MPS
    log|Z|, the loop-correction factor and the padded Eagle-127 ⟨Z⟩."""
    import jax

    n_layers, chi, S = 2, 2, 4
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:S])
    _example("sharded_dynamics").main(n_layers=n_layers, chi=chi)
    out = capsys.readouterr().out
    num = r"([-+]?[\d.]+(?:e[-+]?\d+)?)"
    ref_layers = [tuple(map(float, m)) for m in re.findall(
        rf"max trunc err {num}  <Z>center {num}", out)]
    ref_zz = float(re.search(rf"<ZZ> over \d+ edges: mean {num}", out)[1])
    ref_ent = float(re.search(rf"edges: max {num}", out)[1])
    ref_trunc = float(re.search(rf"truncate: max err {num}", out)[1])
    ref_lz = float(re.search(rf"\(unnormalized\): {num}", out)[1])
    ref_lc = complex(re.search(r"series\): (\S+)", out)[1])
    ref_eagle = float(re.search(rf"127 qubits {num}", out)[1])

    nx, ny = S, 4
    g = tt.named_grid((nx, ny))
    sspec = tp.shard_spec(g, S)
    spec = sspec.spec
    mesh = tp.ShardMesh(S)
    _, state = tp.batched_product_state(g, chi=chi, spec=spec)
    state = mesh.shard(state)
    dt, hx, J = 0.25, 1.0, 0.5
    gate2 = tt.gate_matrix("Rzz", 2 * J * dt).reshape(2, 2, 2, 2)
    gate1 = tt.gate_matrix("Rx", 2 * hx * dt)
    layer = tp.make_sharded_layer(sspec, mesh, gate2, gate1, chi=chi,
                                  cutoff=1e-12, bp_maxiter=25)
    z = tt.op_matrix("Z", 2)
    site_fn = tp.make_sharded_site_expectations(sspec, mesh, z)
    bond_fn = tp.make_sharded_bond_expectations(sspec, mesh, z, z)
    centre = spec.vertex_position((nx // 2, ny // 2))
    for l in range(n_layers):
        state, errs = layer(state)
        zs = site_fn(state).real.numpy()
        err = float(torch.cat(errs).max())
        assert err == pytest.approx(ref_layers[l][0], abs=1e-6)
        assert zs[centre] == pytest.approx(ref_layers[l][1], abs=1e-5)
    assert float(bond_fn(state).real.mean()) == pytest.approx(ref_zz,
                                                              abs=1e-5)
    state_g, spectra = tp.make_sharded_gauge(sspec, mesh)(state)
    ent = spectra.numpy()
    ent = ent / ent.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        sv = -np.nansum(np.where(ent > 0, ent * np.log(ent), 0.0), axis=1)
    assert sv.max() == pytest.approx(ref_ent, abs=1e-4)
    state_t, terrs = tp.make_sharded_truncate(sspec, mesh, chi=chi,
                                              cutoff=1e-8)(state_g)
    assert float(torch.cat(terrs).max()) == pytest.approx(ref_trunc, abs=1e-6)
    rmesh = tp.ShardMesh(S, ("r",))
    norm_fn, _ = tp.make_sharded_grid_bmps(spec, nx, ny, rmesh, kmps=4,
                                           niters=3)
    lz, _ = norm_fn(state_t)
    assert float(lz) == pytest.approx(ref_lz, abs=1e-4)
    zlc = complex(tp.make_sharded_loopcorrections(
        sspec, mesh, g, max_configuration_size=4)(state_t))
    zbp = complex(tp.make_sharded_loopcorrections(
        sspec, mesh, g, max_configuration_size=3)(state_t))
    assert abs(zlc / zbp - ref_lc) < 1e-6

    g_eg = tt.ibm_eagle_lattice()
    sspec_eg = tp.shard_spec(g_eg, S, pad=True)
    _, st_eg = tp.batched_product_state(g_eg, chi=4, spec=sspec_eg.spec)
    st_eg = mesh.shard(st_eg)
    layer_eg = tp.make_sharded_layer(
        sspec_eg, mesh,
        tt.gate_matrix("Rzz", 2 * (3.14159 / 4)).reshape(2, 2, 2, 2),
        tt.gate_matrix("Rx", 0.4), chi=4, cutoff=1e-12, bp_maxiter=25)
    site_eg = tp.make_sharded_site_expectations(sspec_eg, mesh, z)
    for _ in range(3):
        st_eg, _ = layer_eg(st_eg)
    zs_eg = site_eg(st_eg).real.numpy()
    real_rows = [i for i, v in enumerate(sspec_eg.spec.vertices)
                 if g_eg.has_vertex(v)]
    assert len(real_rows) == 127
    assert zs_eg[real_rows].mean() == pytest.approx(ref_eagle, abs=1e-5)
