"""PyTorch port, Vidal gauge and bond truncation against the JAX package
(``parallel/gauge.py``, ``parallel/truncate.py``) on the same numpy inputs.

The gauge transforms carry the SVD's phase freedom, so what is compared is
gauge-free: entanglement spectra, the diagonal messages and ⟨Z⟩ of the
gauged state, 1e-8 in complex128 (both sides run LAPACK in double);
complex64 against the complex128 reference at 1e-4."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch.parallel import gauge as t_gauge
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import gauge as j_gauge
from tensornetworkquantumsimulator_tpu.parallel.truncate import (
    batched_truncate as j_truncate,
)

import measure_states as ms

torch.set_num_threads(1)
_REPO = Path(__file__).resolve().parents[1]
_Z = np.diag([1.0, -1.0])


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _z(spec, state):
    return tt.local_expectations(spec, state, _Z).real.numpy()


def test_measurement_modules_import_without_jax():
    mods = tuple(f"parallel.{m}" for m in (
        "gauge", "truncate", "overlap", "sampling", "correlations",
        "boundarymps", "certified_sampling", "loopcorrection",
        "variational", "sharding", "sharded_layer", "sharding2d",
        "sharded_bmps", "sharded_loopcorrection")) + (
        "utils.checks", "measure", "native") + tuple(
        f"engines.{m}" for m in ("mps", "boundarymps", "loopcorrection",
                                 "diagnostics", "contract")) + (
        "truncate", "sampling", "api", "utils.checkpoint",
        "utils.profiling", "utils.lattices")
    code = "import sys\nimport tensornetworkquantumsimulator_torch\n" + "".join(
        f"import tensornetworkquantumsimulator_torch.{m}\n"
        for m in mods) + (
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tensornetworkquantumsimulator_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("lattice,chi", [("grid3x3", 3), ("heavyhex2x2", 3)])
def test_symmetric_gauge_matches_jax(lattice, chi):
    jspec, jstate, tspec, tensors, messages = ms.converged(lattice, chi)
    state = tp.state_from_numpy(tensors, messages)
    j_gauged, j_spectra = j_gauge.batched_symmetric_gauge(jspec, jstate)
    gauged, spectra = tp.batched_symmetric_gauge(tspec, state)
    # spectra in spec.edges order, descending and positive
    s = spectra.numpy()
    np.testing.assert_allclose(s, np.asarray(j_spectra), rtol=1e-8, atol=1e-10)
    assert (s > 0).all() and (np.diff(s, axis=-1) <= 1e-12).all()
    # the gauge preserves the state: ⟨Z⟩ unchanged, and equal to JAX's
    z = _z(tspec, gauged)
    np.testing.assert_allclose(z, _z(tspec, state), atol=1e-8)
    np.testing.assert_allclose(
        z, np.real(np.asarray(jp.local_expectations(jspec, j_gauged, _Z))),
        atol=1e-8)
    # both messages of an edge are diag(spectrum); dummy slots untouched
    m = gauged.messages.numpy()
    np.testing.assert_allclose(m, np.asarray(j_gauged.messages), atol=1e-8)
    for e, (iu, iv, su, sv) in enumerate(tspec.edges):
        np.testing.assert_allclose(m[iu, su], np.diag(s[e]), atol=1e-12)
        np.testing.assert_allclose(m[iv, sv], np.diag(s[e]), atol=1e-12)


def test_symmetric_gauge_complex64_within_band():
    _, _, tspec, tensors, messages = ms.converged("grid3x3", 3)
    ref, ref_s = tp.batched_symmetric_gauge(
        tspec, tp.state_from_numpy(tensors, messages))
    state = tp.state_from_numpy(tensors.astype(np.complex64),
                                messages.astype(np.complex64))
    gauged, spectra = tp.batched_symmetric_gauge(tspec, state)
    assert gauged.tensors.dtype == torch.complex64
    assert spectra.dtype == torch.float32
    np.testing.assert_allclose(spectra.numpy(), ref_s.numpy(), atol=1e-4)
    np.testing.assert_allclose(_z(tspec, gauged), _z(tspec, ref), atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                       (np.complex64, 1e-4)])
def test_eig_roots_rank_deficient_message(dtype, tol):
    """Messages of padded bonds are rank-deficient (here rank 2 of χ=5,
    plus an exactly zero-padded block): the null directions are zeroed in
    both roots, not amplified."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 2)) + 1j * rng.standard_normal((6, 5, 2))
    m = x @ np.conj(np.swapaxes(x, -1, -2))
    m[-1, 3:, :] = 0.0
    m[-1, :, 3:] = 0.0
    m = m.astype(dtype)
    eps = np.finfo(np.zeros((), dtype).real.dtype).eps
    # the same cutoff on both sides: the complex64 input's null directions
    # carry float32 rounding noise, which the float64 default would keep
    root, inv = t_gauge._eig_roots(torch.from_numpy(m), 1e3 * eps)
    j_root, j_inv = j_gauge._eig_roots(jnp.asarray(m.astype(np.complex128)),
                                       1e3 * eps)
    for got, ref in ((root, j_root), (inv, j_inv)):  # relative to max |ref|
        scale = np.abs(np.asarray(ref)).max()
        np.testing.assert_allclose(got.numpy() / scale,
                                   np.asarray(ref) / scale, atol=tol)
    assert torch.isfinite(torch.view_as_real(inv)).all()
    # root·inv is the projector on the range: trace = rank 2
    rank = torch.einsum("bij,bji->b", root, inv).real.numpy()
    np.testing.assert_allclose(rank, 2.0, atol=100 * tol)


@pytest.fixture(scope="module")
def truncated_jax():
    """The JAX truncation of the grid state at a cutoff that discards."""
    jspec, jstate, *_ = ms.converged("grid3x3", 3)
    fn = jax.jit(lambda st: j_truncate(jspec, st, chi=3, cutoff=0.03,
                                       bp_maxiter=100, bp_tolerance=1e-14))
    out, errs = fn(jstate)
    return (np.real(np.asarray(jp.local_expectations(jspec, out, _Z))),
            np.asarray(errs))


def test_truncate_matches_jax(truncated_jax, monkeypatch):
    for k in ("TNQS_EIGH_ALG", "TNQS_SVD_ALG", "TNQS_QR_ALG"):
        monkeypatch.delenv(k, raising=False)
    z_j, errs_j = truncated_jax
    tspec, state = ms.port_state("grid3x3", 3)
    out, errs = tp.batched_truncate(tspec, state, chi=3, cutoff=0.03,
                                    bp_maxiter=100, bp_tolerance=1e-14)
    assert errs.shape == (len(tspec.edges),)
    assert errs_j.max() > 1e-3  # the cutoff really discards
    np.testing.assert_allclose(errs.numpy(), errs_j, atol=1e-8)
    np.testing.assert_allclose(_z(tspec, out), z_j, atol=1e-8)


def test_truncate_identity_when_chi_suffices():
    tspec, state = ms.port_state("heavyhex2x2", 3)
    out, errs = tp.batched_truncate(tspec, state, chi=3, cutoff=0.0,
                                    bp_tolerance=1e-14, bp_maxiter=100)
    np.testing.assert_allclose(errs.numpy(), 0.0, atol=1e-10)
    # a fidelity distance of 1e-14 leaves the messages converged to ~1e-7 in
    # amplitude, and the refreshes move ⟨Z⟩ within that window
    np.testing.assert_allclose(_z(tspec, out), _z(tspec, state), atol=1e-6)


_FAST_STACK = {"TNQS_EIGH_ALG": "jacobi", "TNQS_SVD_ALG": "gram",
               "TNQS_QR_ALG": "cholqr2"}


@pytest.mark.parametrize("stack", [{}, _FAST_STACK], ids=["default", "fast"])
def test_truncate_complex64_fast_stack_within_band(truncated_jax, stack,
                                                   monkeypatch):
    """complex64 against the complex128 reference at 1e-4, with the default
    stack and with gram split + CholeskyQR2 + the Jacobi routing (its
    wrappers take their plain versions on the CPU).  BP runs 100 sweeps
    (tolerance 0) instead of stopping on the complex64 default of 1e-5: a
    fidelity distance of 1e-5 leaves the messages 3e-3 off in amplitude,
    which this strongly truncated state turns into 1e-3 in <Z>."""
    for k in _FAST_STACK:
        monkeypatch.delenv(k, raising=False)
    for k, v in stack.items():
        monkeypatch.setenv(k, v)
    z_j, _ = truncated_jax
    tspec, state = ms.port_state("grid3x3", 3, dtype=np.complex64)
    out, errs = tp.batched_truncate(tspec, state, chi=3, cutoff=0.03,
                                    bp_maxiter=100, bp_tolerance=0.0)
    assert out.tensors.dtype == torch.complex64
    assert torch.isfinite(errs).all()
    np.testing.assert_allclose(_z(tspec, out), z_j, atol=1e-4)


def test_subgraph_enumerator_builds_into_build_dir(tmp_path):
    """``csrc/subgraphs.cpp`` is built by g++ into ``build/native/<hash>/``
    at the root of the checkout, never into the package directory; without
    g++ the loader reports no library and the Python enumeration runs."""
    import shutil

    from tensornetworkquantumsimulator_torch import native

    pkg = _REPO / "tensornetworkquantumsimulator_torch"
    so = native.library_path()
    assert so.parent.parent == _REPO / "build" / "native"
    assert pkg not in so.parents
    if shutil.which("g++") is None:
        assert native.get_subgraphs() is None
        return
    assert native.get_subgraphs() is not None and so.is_file()
    assert not list(pkg.rglob("*.so"))
    # a fresh checkout builds the same library into its own build/
    copy = tmp_path / "checkout"
    shutil.copytree(pkg, copy / pkg.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from tensornetworkquantumsimulator_torch import native\n"
            "assert native.get_subgraphs() is not None\n"
            "print(native.library_path())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=copy,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    built = Path(proc.stdout.strip())
    assert built.is_file() and copy / "build" / "native" in built.parents
    assert not list((copy / pkg.name).rglob("*.so"))
