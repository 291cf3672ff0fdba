"""PyTorch port, factorizations: the plain versions of the Jacobi kernels
K1 (`jacobi_pseudo_roots`) and K2 (`jacobi_eigh`) against the JAX Pallas
kernels run in interpret mode, the shape gates against the reference's,
and the engine's roots / Gram split / QR-reduce family against the JAX
engine in complex128.

The CUDA kernels themselves run only on a GPU; `chip_smoke.py` holds them
against these same plain versions there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import cuda_linalg as tl
from tensornetworkquantumsimulator_torch.parallel import engine as te
from tensornetworkquantumsimulator_tpu.parallel import engine as je
from tensornetworkquantumsimulator_tpu.parallel import pallas_linalg as jl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _np(x):
    return x.resolve_conj().numpy()


def _random_hermitian(rng, B, n, dtype=np.complex64):
    m = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    return ((m + np.conj(np.swapaxes(m, -1, -2))) / 2).astype(dtype)


def _psd(q, w):
    a = (q * w[:, None, :]) @ np.conj(np.swapaxes(q, -1, -2))
    return ((a + np.conj(np.swapaxes(a, -1, -2))) / 2).astype(np.complex64)


def _check(a, w, v, tol):
    """`tests/test_pallas_linalg.py::_check`: ascending eigenvalues against
    LAPACK in double, reconstruction and unitarity."""
    B, n, _ = a.shape
    w, v = np.asarray(w), np.asarray(v)
    assert np.all(np.diff(w, axis=-1) >= -tol)
    w_ref = np.linalg.eigvalsh(a.astype(np.complex128))
    scale = np.abs(w_ref).max()
    assert np.max(np.abs(w - w_ref)) / scale < tol
    recon = np.einsum("bij,bj,bkj->bik", v, w.astype(v.dtype), np.conj(v))
    assert np.linalg.norm(recon - a) / np.linalg.norm(a) < tol
    gram = np.einsum("bji,bjk->bik", np.conj(v), v)
    assert np.abs(gram - np.eye(n)).max() < tol


@pytest.fixture(scope="module")
def roots_batches():
    """The regimes of `tests/test_pallas_linalg.py:309-383` at n=10, run
    through the JAX kernel in ONE interpret-mode call (each call costs
    seconds on the CPU) and through the port's plain K1."""
    n, B = 10, 6
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(
        rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    )
    ones = np.ones((B, 1))
    # ill-conditioned but clear of the 10·ε·λmax clip, 2 null directions
    ill = _psd(q, np.concatenate([np.logspace(0, -5, n - 2), [1e-9, 1e-9]])
               [None, :] * ones)
    ill[-1] = np.eye(n)  # a padded/dummy slot
    well = _psd(q, (0.1 + np.linspace(0, 1, n))[None, :] * ones)
    qd = rng.standard_normal((4, n, 3)) + 1j * rng.standard_normal((4, n, 3))
    deficient = np.einsum("bik,bjk->bij", qd, np.conj(qd)).astype(np.complex64)
    deficient = (deficient + np.conj(np.swapaxes(deficient, -1, -2))) / 2
    a = np.concatenate([ill, well, deficient])
    jr, js = jl.jacobi_pseudo_roots(jnp.asarray(a), interpret=True)
    tr, ts = tl.jacobi_pseudo_roots(torch.from_numpy(a))
    parts = {"ill": slice(0, B), "well": slice(B, 2 * B),
             "deficient": slice(2 * B, 2 * B + 4)}
    return {k: (a[s], np.asarray(jr)[s], np.asarray(js)[s], tr.numpy()[s],
                ts.numpy()[s]) for k, s in parts.items()}


def test_plain_roots_ill_conditioned_and_identity(roots_batches):
    a, jr, js, root, inv = roots_batches["ill"]
    n = a.shape[-1]
    for r, s in ((root, inv), (jr, js)):
        assert np.linalg.norm(r @ r - a) / np.linalg.norm(a) < 2e-5
        p = r @ s
        assert np.linalg.norm(p @ r - r) / np.linalg.norm(r) < 1e-4
    # both paths make the same keep/zero decisions (rank parity)
    rank = np.real(np.trace(root @ inv, axis1=-2, axis2=-1))
    rank_ref = np.real(np.trace(jr @ js, axis1=-2, axis2=-1))
    np.testing.assert_allclose(rank, rank_ref, atol=0.05)
    np.testing.assert_allclose(rank[:-1], n - 2, atol=0.05)
    # identity env maps to exact identity roots (mask correctness)
    assert np.abs(root[-1] - np.eye(n)).max() < 1e-6
    assert np.abs(inv[-1] - np.eye(n)).max() < 1e-6


def test_plain_roots_well_conditioned_elementwise(roots_batches):
    _a, jr, js, root, inv = roots_batches["well"]
    assert np.abs(root - jr).max() < 2e-5
    assert np.abs(inv - js).max() < 2e-4


def test_plain_roots_rank_deficient(roots_batches):
    a, jr, _js, root, inv = roots_batches["deficient"]
    assert np.linalg.norm(root @ root - a) / np.linalg.norm(a) < 5e-6
    assert (np.linalg.norm(root @ inv @ root - root) / np.linalg.norm(root)
            < 1e-4)
    assert np.abs(root - jr).max() < 2e-5


def test_plain_eigh_matches_jax_kernel_n40():
    rng = np.random.default_rng(40)
    a = _random_hermitian(rng, 3, 40)
    jw, jv = jl.jacobi_eigh(jnp.asarray(a), interpret=True)
    tw, tv = tl.jacobi_eigh(torch.from_numpy(a))
    _check(a, jw, jv, 2e-4)
    _check(a, tw.numpy(), tv.numpy(), 2e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               atol=2e-4 * np.abs(np.asarray(jw)).max())


def test_kernel_gates_match_reference():
    for n in range(0, 300):
        for batch in (0, 1, 72):
            assert tl.roots_kernel_supported(n, batch) == \
                jl.roots_kernel_supported(n, batch)
            # jacobi_eigh's own fallback rule (pallas_linalg.py:247) up to
            # the n = 88 one CTA's shared memory holds; above it the H100's
            # limit: a cluster of 8 CTAs holds 3·n² bytes each (192 KB of
            # 227 KB at n = 256), n a multiple of 16
            ref = not (n % 2 == 1 or n < 4 or n > 88 or batch == 0)
            card = 88 < n <= 256 and n % 16 == 0 and batch > 0
            assert tl.eigh_kernel_supported(n, batch) == (ref or card)
    assert tl.ONE_CTA_MAX_N == 88 and tl.CLUSTER_MAX_N == 256
    assert 3 * tl.CLUSTER_MAX_N ** 2 * 8 // tl.CLUSTER_CTAS < 227 * 1024
    # the convergence test's cap leaves room above the reference's fixed
    # sweep counts
    assert tl.MAX_SWEEPS >= 2 * max(jl.default_sweeps(n) for n in range(4, 90))


# --- complex128: the engine's factorizations against the JAX engine -------


def _set_knob(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _tall(seed, deficient=True):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(5, 96, 24)) + 1j * rng.normal(size=(5, 96, 24))
    if deficient:
        a[2, :, -6:] = 0.0  # rank-deficient member (zero-padded bond)
    return a.astype(np.complex128)


def _assert_isometric_split(q, m, a, tol=1e-10):
    np.testing.assert_allclose(q @ m, a, atol=tol)
    qhq = np.conj(np.swapaxes(q, -1, -2)) @ q
    eye = np.eye(q.shape[-1])
    for b in range(q.shape[0]):
        k = 18 if b == 2 else q.shape[-1]  # range of the deficient member
        np.testing.assert_allclose(qhq[b][:k, :k], eye[:k, :k], atol=tol)


@pytest.mark.parametrize("alg", [None, "cholqr1", "cholqr2", "polar"])
def test_qr_split_variants_match_jax(alg, monkeypatch):
    _set_knob(monkeypatch, "TNQS_QR_ALG", alg)
    _set_knob(monkeypatch, "TNQS_EIGH_ALG", None)
    a = _tall(7, deficient=alg != "cholqr1")
    q, m = (_np(x) for x in te._qr_split(torch.from_numpy(a)))
    jq, jm = (np.asarray(x) for x in je._qr_split(jnp.asarray(a)))
    if alg == "cholqr1":
        # one pass: A = Q·M exactly, Q orthogonal only to ~κ²ε
        np.testing.assert_allclose(q @ m, a, atol=1e-10)
    else:
        _assert_isometric_split(q, m, a)
    np.testing.assert_allclose(q @ m, jq @ jm, atol=1e-10)
    # the same subspace: the singular values of the small factor agree
    np.testing.assert_allclose(np.linalg.svd(m, compute_uv=False),
                               np.linalg.svd(jm, compute_uv=False), atol=1e-10)


def test_defer_qr_reduce_matches_jax(monkeypatch):
    monkeypatch.setenv("TNQS_QR_ALG", "defer")
    a = _tall(7, deficient=False)
    q, r, deferred = te._qr_reduce(torch.from_numpy(a))
    jq, jr, jdeferred = je._qr_reduce(jnp.asarray(a))
    assert deferred and jdeferred
    np.testing.assert_array_equal(_np(q), a)  # raw, no tall pass
    eye = torch.eye(24, dtype=torch.complex128).expand(5, 24, 24)
    qeff = a @ _np(te._rinv_left(r, eye))
    np.testing.assert_allclose(qeff @ _np(r), a, atol=1e-9)
    np.testing.assert_allclose(np.conj(np.swapaxes(qeff, -1, -2)) @ qeff,
                               np.broadcast_to(np.eye(24), (5, 24, 24)),
                               atol=1e-8)
    np.testing.assert_allclose(_np(r), np.asarray(jr), atol=1e-10)


@pytest.mark.parametrize("wide", [False, True])
def test_gram_split_matches_jax(wide):
    rng = np.random.default_rng(5)
    shape = (4, 12, 20) if wide else (4, 20, 12)
    a = (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    a[1, 3:] = 0.0 if wide else a[1, 3:]
    a[1, :, 3:] = a[1, :, 3:] if wide else 0.0  # a rank-3 member
    u, s, vh = (_np(x) for x in te._gram_split(torch.from_numpy(a)))
    ju, js, jvh = (np.asarray(x) for x in je._gram_split(jnp.asarray(a)))
    np.testing.assert_allclose(s, js, atol=1e-10)
    np.testing.assert_allclose((u * s[:, None, :]) @ vh, a, atol=1e-10)
    np.testing.assert_allclose((u * s[:, None, :]) @ vh,
                               (ju * js[:, None, :]) @ jvh, atol=1e-10)


def test_pseudo_roots_match_jax_complex128(monkeypatch):
    monkeypatch.setenv("TNQS_EIGH_ALG", "jacobi")  # x64 never takes a kernel
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.standard_normal((2, 3, 8, 8))
                        + 1j * rng.standard_normal((2, 3, 8, 8)))
    w = np.concatenate([np.logspace(0, -8, 6), [0.0, 0.0]])
    a = (q * w) @ np.conj(np.swapaxes(q, -1, -2))  # [2, 3, 8, 8] PSD
    r, s = (_np(x) for x in te._pseudo_roots(torch.from_numpy(a)))
    jr, js = (np.asarray(x) for x in je._pseudo_roots(jnp.asarray(a)))
    np.testing.assert_allclose(r, jr, atol=1e-10)
    np.testing.assert_allclose(r @ r, a, atol=1e-10)
    np.testing.assert_allclose(np.linalg.eigvalsh(s), np.linalg.eigvalsh(js),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("dtype, tol", [(np.complex64, 1e-5),
                                        (np.complex128, 1e-12)])
def test_default_qr_split_padded_and_equal_columns(dtype, tol, monkeypatch):
    """With no ``TNQS_QR_ALG`` the split is ``torch.linalg.qr`` of the whole
    batch, as the reference's default (engine.py:120), on a 32-bit CPU
    batch in 64 bits and cast back (MKL's complex64 QR returns NaN on
    denormal columns).  Its inputs on the
    layer path are tall and carry zero-padded bond columns; it must give a
    finite Q·R = A with upper-triangular R on zero-padded, equal-column and
    all-zero members (on the card, batches of small square complex matrices
    with equal columns are where the batched QR returned NaN)."""
    _set_knob(monkeypatch, "TNQS_QR_ALG", None)
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((5, 40, 20))
         + 1j * rng.standard_normal((5, 40, 20))).astype(dtype)
    a[:, :, 12:] = 0.0  # padded bond columns
    a[1] = 0.0088 + 0.0088j  # every column equal
    a[2] = a[2, :, :1]  # one random column repeated
    a[3] = 0.0
    at = torch.from_numpy(a)
    q, r = te._qr_split(at)
    q_ref, r_ref = torch.linalg.qr(at.to(torch.complex128))
    q_ref, r_ref = q_ref.to(at.dtype), r_ref.to(at.dtype)
    assert torch.equal(q, q_ref) and torch.equal(r, r_ref)
    q, r = _np(q), _np(r)
    assert np.isfinite(q).all() and np.isfinite(r).all()
    assert np.abs(np.tril(r, -1)).max() == 0.0
    scale = np.abs(a).max()
    assert np.abs(q @ r - a).max() <= tol * scale
