"""PyTorch port, Vidal gauge and bond truncation against the JAX package
(``parallel/gauge.py``, ``parallel/truncate.py``) on the same numpy inputs.

The gauge transforms carry the SVD's phase freedom, so what is compared is
gauge-free: entanglement spectra, the diagonal messages and ⟨Z⟩ of the
gauged state, 1e-8 in complex128 (both sides run LAPACK in double);
complex64 against the complex128 reference at 1e-4."""

import ast
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


_PORT = _REPO / "tensornetworkquantumsimulator_torch"
_FORBIDDEN = ("jax", "jaxlib", "tensornetworkquantumsimulator_tpu")


def _port_modules() -> list:
    """Dotted names of every module of the port."""
    names = []
    for f in sorted(_PORT.rglob("*.py")):
        parts = f.relative_to(_REPO).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


def test_measurement_modules_import_without_jax():
    """Importing every module of the port loads no JAX and nothing of the
    JAX package."""
    code = "import sys\n" + "".join(f"import {m}\n"
                                    for m in _port_modules()) + (
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path: Path) -> set:
    """The top-level package of every import statement in a file, relative
    imports resolved inside the port."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(_PORT.name if node.level else
                      node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(_PORT.rglob("*.py")) + [
    _REPO / "chip_smoke.py", _REPO / "kernel_ab.py"],
    ids=lambda p: str(p.relative_to(_REPO)))
def test_no_import_statement_names_jax(path):
    """No import statement of the port or of its GPU scripts, at any depth
    (inside functions too), names JAX or the JAX package."""
    assert not _imported_roots(path) & set(_FORBIDDEN)


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
# the "stop_test" bar in units of the band ``truncate_stop_band`` measures:
# over hash seeds 0-63 the port's complex64 truncation read at most 1.22
# bands from JAX's complex128 one (1.12 default stack, 1.22 fast) and
# JAX's complex64 1.23, so the bar has 2.4× headroom over the worst seed
# (`sharded_cases.py`'s `truncate_readings`, run once per seed)
_STOP_BAND_FACTOR = 3.0


@pytest.fixture(scope="module")
def truncate_stop_band(truncated_jax):
    """How far JAX's complex128 truncation moves ⟨Z⟩ when its refreshes stop
    where a float32 fidelity distance loses resolution (tolerance ε32)
    instead of at 1e-14: complex64's stop test reads noise below ~1e-7, so
    at tolerance 0 a complex64 refresh stops at the first sweep whose noise
    reads ≤ 0 (``test_torch_sharding_layer.py`` shows the same in the
    layer)."""
    jspec, jstate, *_ = ms.converged("grid3x3", 3)
    eps32 = float(np.finfo(np.float32).eps)
    fn = jax.jit(lambda st: j_truncate(jspec, st, chi=3, cutoff=0.03,
                                       bp_maxiter=100, bp_tolerance=eps32))
    out, _ = fn(jstate)
    z = np.real(np.asarray(jp.local_expectations(jspec, out, _Z)))
    return np.abs(z - truncated_jax[0]).max()


@pytest.mark.parametrize("tolerance", [0.0, -1.0],
                         ids=["stop_test", "fixed_sweeps"])
@pytest.mark.parametrize("stack", [{}, _FAST_STACK], ids=["default", "fast"])
def test_truncate_complex64_fast_stack_within_band(truncated_jax,
                                                   truncate_stop_band, stack,
                                                   tolerance, monkeypatch):
    """complex64 against the complex128 reference, with the default stack
    and with gram split + CholeskyQR2 + the Jacobi routing (its wrappers
    take their plain versions on the CPU), BP at most 100 sweeps a refresh
    instead of stopping on the complex64 default of 1e-5 (a fidelity
    distance of 1e-5 leaves the messages 3e-3 off in amplitude, which this
    strongly truncated state turns into 1e-3 in <Z>).  With tolerance −1
    every refresh runs its 100 sweeps: ⟨Z⟩ within 1e-5.  With tolerance 0
    complex64's stop test decides where each refresh stops: ⟨Z⟩ within
    ``_STOP_BAND_FACTOR`` × ``truncate_stop_band``."""
    for k in _FAST_STACK:
        monkeypatch.delenv(k, raising=False)
    for k, v in stack.items():
        monkeypatch.setenv(k, v)
    z_j, _ = truncated_jax
    tspec, state = ms.port_state("grid3x3", 3, dtype=np.complex64)
    out, errs = tp.batched_truncate(tspec, state, chi=3, cutoff=0.03,
                                    bp_maxiter=100, bp_tolerance=tolerance)
    assert out.tensors.dtype == torch.complex64
    assert torch.isfinite(errs).all()
    if tolerance < 0:
        np.testing.assert_allclose(_z(tspec, out), z_j, atol=1e-5)
        return
    assert truncate_stop_band > 1e-5  # the early stop moves ⟨Z⟩ here
    np.testing.assert_allclose(_z(tspec, out), z_j,
                               atol=_STOP_BAND_FACTOR * truncate_stop_band)


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
