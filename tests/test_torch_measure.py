"""PyTorch port, the measurement half as a whole: each package evolves its
own product state through the same three TFIM Trotter layers (3×3, χ=4,
complex128) and then measures it the way the examples do: Loschmidt echo
against the initial state, Vidal gauge and entanglement spectra, path
correlators from the centre, boundary-MPS ⟨Z⟩ and norm.  The two evolutions
agree to 1e-8 per layer (tests/test_torch_slice.py), BP runs to 1e-12 and
the boundary MPS a fixed number of sweeps, so every gauge-free readout
agrees to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import boundarymps as j_bmps
from tensornetworkquantumsimulator_tpu.parallel import correlations as j_corr
from tensornetworkquantumsimulator_tpu.parallel import gauge as j_gauge
from tensornetworkquantumsimulator_tpu.parallel import overlap as j_ov
from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

torch.set_num_threads(1)
_Z = np.diag([1.0, -1.0])
_KW = dict(chi=4, cutoff=1e-10, normalize_tensors=True, bp_maxiter=100,
           bp_tolerance=1e-12)
_BP = dict(maxiter=300, tolerance=1e-14)
_TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _layer(graphs, g, dt=0.25, hx=1.0, hz=0.8, J=0.5):
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for ce in graphs.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in ce]
    return layer


def _evolve(par, graphs, lat, dtype):
    g = lat.named_grid((3, 3))
    spec, psi0 = par.batched_product_state(g, chi=4, dtype=dtype)
    layer_fn = par.make_layer_fn(
        par.BatchedCircuit(_layer(graphs, g), g, spec=spec), **_KW)
    state = psi0
    for _ in range(3):
        state, _ = layer_fn(state)
    return spec, psi0, par.bp_update(spec, state, maxiter=300,
                                     tolerance=1e-14)


@pytest.fixture(scope="module")
def evolved():
    prev = set_default_device("cpu")
    try:
        port = _evolve(tp, tt, tt, torch.complex128)
    finally:
        set_default_device(prev)
    return _evolve(jp, j_graphs, j_lat, np.complex128), port


def test_echo_against_the_initial_state(evolved):
    (jspec, j0, jt), (tspec, t0, tt_) = evolved
    got = tp.batched_loschmidt_echo(tspec, t0, tt_, **_BP)
    ref = j_ov.batched_loschmidt_echo(jspec, j0, jt, **_BP)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), atol=_TOL)
    np.testing.assert_allclose(np.exp(1j * float(got[1])),
                               np.exp(1j * float(ref[1])), atol=_TOL)
    assert float(got[0]) < -1e-3  # the layers moved the state
    zero = tp.batched_loschmidt_echo(tspec, t0, t0, **_BP)
    np.testing.assert_allclose(float(zero[0]), 0.0, atol=1e-10)


def test_gauge_spectra_and_observables(evolved):
    (jspec, _, jt), (tspec, _, tt_) = evolved
    gauged, spectra = tp.batched_symmetric_gauge(tspec, tt_)
    _, j_spectra = j_gauge.batched_symmetric_gauge(jspec, jt)
    np.testing.assert_allclose(spectra.numpy(), np.asarray(j_spectra),
                               atol=_TOL)
    np.testing.assert_allclose(
        tp.local_expectations(tspec, gauged, _Z).real.numpy(),
        np.real(np.asarray(jp.local_expectations(jspec, jt, _Z))), atol=_TOL)


def test_correlators_from_the_centre(evolved):
    (jspec, _, jt), (tspec, _, tt_) = evolved
    pairs = [((2, 2), v) for v in tspec.vertices if v != (2, 2)]
    got = tp.path_correlations(tspec, tt_, pairs, _Z, connected=True)
    ref = j_corr.make_path_correlation_fn(jspec, pairs, _Z, connected=True,
                                          jit=False)(jt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=_TOL)
    assert np.abs(got.numpy()).max() > 1e-4  # there is something to compare


def test_boundary_mps_readout(evolved):
    (jspec, _, jt), (tspec, _, tt_) = evolved
    kw = dict(niters=5, tolerance=None)
    norm, expect = tp.make_grid_bmps(tspec, 3, 3, 8, **kw)
    j_norm, j_expect = j_bmps.make_grid_bmps(jspec, 3, 3, 8, **kw)
    z = expect(tt_.tensors, _Z).numpy()
    np.testing.assert_allclose(
        z, np.asarray(j_expect(jt.tensors, jnp.asarray(_Z, jnp.complex128))),
        atol=_TOL)
    np.testing.assert_allclose(float(norm(tt_.tensors)[0]),
                               float(j_norm(jt.tensors)[0]), atol=_TOL)
    # BP and the boundary MPS see the same state: close, not equal
    bp = tp.local_expectations(tspec, tt_, _Z).real.numpy()
    assert 1e-9 < np.abs(z - bp).max() < 5e-2
