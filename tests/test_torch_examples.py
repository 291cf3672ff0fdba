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
