"""PyTorch port, the generic engine's tensor layer (``ops``): named indices,
dense tensors and their algebra, contraction, and the factorizations, each
fed the same numpy inputs as the JAX package's ``ops`` and held to it.

The factors of an SVD, a QR or an eigendecomposition carry a gauge (phases,
signs) that differs between libraries, so the factorizations are compared
on gauge-free outputs: ranks, singular values, truncation errors, products
of the factors, and squares of roots."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import ops as to
from tensornetworkquantumsimulator_torch.ops import index as t_index
from tensornetworkquantumsimulator_torch.ops import linalg as t_linalg
from tensornetworkquantumsimulator_torch.ops.tensor import combiner
from tensornetworkquantumsimulator_tpu import ops as jo
from tensornetworkquantumsimulator_tpu.ops import linalg as j_linalg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _pair(rng, shapes, complex_=True):
    """Index sets with the same ids in both packages, and numpy arrays."""
    jinds = {}
    tinds = {}
    for name, d in shapes.items():
        j = jo.Index(d, tags=(name,))
        jinds[name] = j
        tinds[name] = to.Index(d, tags=(name,), id=j.id)
        t_index.reserve_ids(j.id)  # later port ids never reuse it

    def arr(*names):
        shape = tuple(shapes[n] for n in names)
        a = rng.normal(size=shape)
        if complex_:
            a = a + 1j * rng.normal(size=shape)
        return a

    return jinds, tinds, arr


def test_index_identity_prime_and_sets():
    i = to.Index(3, tags="a")
    assert i.tags == ("a",)
    assert i.prime() != i and i.prime().noprime() == i
    assert i.sim() != i and i.sim().dim == 3
    j, k = to.Index(2), to.Index(4)
    assert to.commoninds([i, j], [j, k]) == [j]
    assert to.uniqueinds([i, j], [j, k]) == [i]
    assert to.unioninds([i, j], [j, k]) == [i, j, k]
    assert to.hastags(i, "a") and to.dim(i) == 3 and to.plev(i.prime(2)) == 2


def test_reserved_ids_never_collide():
    """A carried-in id moves the port's counter past it."""
    big = t_index._last_id + 10_000
    t_index.reserve_ids(big)
    t_index.reserve_ids(big - 5000)  # a smaller reservation lowers nothing
    assert to.Index(2).id > big
    assert to.Index(2).sim().id > big


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_tensor_algebra_and_contraction(dtype):
    rng = np.random.default_rng(0)
    cplx = dtype == np.complex128
    ji, ti, arr = _pair(rng, dict(a=2, b=3, c=4, d=2), cplx)
    A, B = arr("a", "b", "c"), arr("c", "b", "d")
    ja = jo.Tensor(A, (ji["a"], ji["b"], ji["c"]))
    jb = jo.Tensor(B, (ji["c"], ji["b"], ji["d"]))
    ta = to.from_array(A, (ti["a"], ti["b"], ti["c"]))
    tb = to.from_array(B, (ti["c"], ti["b"], ti["d"]))
    jc, tc = ja * jb, ta * tb
    assert [i.id for i in tc.inds] == [i.id for i in jc.inds]
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc.data), atol=1e-12)
    # elementwise algebra on a permuted operand, scalars, dag/prime
    tp = to.from_array(np.transpose(A, (2, 0, 1)), (ti["c"], ti["a"], ti["b"]))
    np.testing.assert_allclose((ta + tp).numpy(), 2 * A, atol=1e-12)
    np.testing.assert_allclose((ta - tp).numpy(), 0 * A, atol=1e-12)
    np.testing.assert_allclose((np.float64(0.5) * ta / 2).numpy(), A / 4)
    assert ta.dag().prime().inds[0] == ti["a"].prime()
    np.testing.assert_allclose(to.dot(ta, ta), jo.dot(ja, ja), rtol=1e-12)
    np.testing.assert_allclose(ta.norm(), ja.norm(), rtol=1e-12)
    np.testing.assert_allclose(ta.normalize().norm(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(ta.sum_entries(), ja.sum_entries(), rtol=1e-12)
    # a list contraction through the path search
    C = arr("d", "a")
    jt = [ja, jb, jo.Tensor(C, (ji["d"], ji["a"]))]
    tt_ = [ta, tb, to.from_array(C, (ti["d"], ti["a"]))]
    np.testing.assert_allclose(to.contract(tt_).scalar(),
                               jo.contract(jt).scalar(), rtol=1e-12)


def test_scalar_algebra_keeps_complex64():
    """JAX's weak scalars: numpy float64 and 0-dim float64 tensors never
    widen complex64."""
    t = to.from_array(np.ones((2, 2), np.complex64), (to.Index(2), to.Index(2)))
    assert (t * np.float64(2.0)).dtype == torch.complex64
    assert (np.float64(2.0) * t).dtype == torch.complex64
    assert (t * torch.tensor(2.0, dtype=torch.float64)).dtype == torch.complex64
    assert (t / np.complex128(2.0)).dtype == torch.complex64
    assert (t * 2.0j).dtype == torch.complex64


def test_mixed_devices_raise():
    i = to.Index(2)
    a = to.from_array(np.ones(2), (i,))
    b = to.Tensor(torch.ones(2, dtype=torch.float64, device="meta"), (i,))
    with pytest.raises(ValueError, match="different devices"):
        to.contract_pair(a, b)


def test_constructors_and_utilities():
    i, j, k = to.Index(2), to.Index(3), to.Index(2)
    ji, jj, jk = (jo.Index(x.dim, id=x.id) for x in (i, j, k))
    for t_, j_ in ((to.delta((i, j, k)), jo.delta((ji, jj, jk))),
                   (to.delta((i, j)), jo.delta((ji, jj))),
                   (to.onehot(j, 2), jo.onehot(jj, 2))):
        np.testing.assert_array_equal(t_.numpy(), np.asarray(j_.data))
        assert t_.dtype == torch.float64
    rng = np.random.default_rng(1)
    M = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    tm = to.from_array(M, (i, i.prime()))
    jm = jo.Tensor(M, (ji, ji.prime()))
    np.testing.assert_allclose(to.make_hermitian(tm).numpy(),
                               np.asarray(jo.make_hermitian(jm).data))
    np.testing.assert_allclose(to.trace(tm), jo.trace(jm))
    np.testing.assert_allclose(to.diagonal(tm).numpy(), np.diag(M))
    np.testing.assert_allclose(to.map_diag(torch.exp, tm).numpy(),
                               np.asarray(jo.map_diag(np.exp, jm).data))
    comb, ci = combiner((i, j))
    assert ci.dim == 6 and comb.shape == (2, 3, 6)
    V = rng.normal(size=2)
    op = to.from_array(M, (i.prime(), i))
    np.testing.assert_allclose(
        to.apply_op(op, to.from_array(V, (i,))).numpy(), M @ V)
    g = torch.Generator().manual_seed(3)
    r = to.random_tensor(g, (i, j), dtype=torch.complex64)
    assert r.dtype == torch.complex64 and r.shape == (2, 3)


@pytest.mark.parametrize("maxdim,cutoff", [(None, None), (3, None),
                                           (None, 1e-2), (4, 1e-3), (2, 0.5)])
@pytest.mark.parametrize("ortho", ["none", "left", "right"])
def test_svd_truncated_ranks_spectra_errors(maxdim, cutoff, ortho):
    rng = np.random.default_rng(2)
    ji, ti, arr = _pair(rng, dict(a=2, b=3, c=4, d=2))
    A = arr("a", "b", "c", "d")
    # a decaying spectrum so that the cutoffs cut
    A = A * np.array([1.0, 0.3])[:, None, None, None]
    jt = jo.Tensor(A, [ji[n] for n in "abcd"])
    tt_ = to.from_array(A, [ti[n] for n in "abcd"])
    jX, jY, js, jerr, _ = jo.svd_truncated(jt, [ji["a"], ji["c"]],
                                           maxdim=maxdim, cutoff=cutoff,
                                           ortho=ortho)
    tX, tY, ts, terr, tb = to.svd_truncated(tt_, [ti["a"], ti["c"]],
                                            maxdim=maxdim, cutoff=cutoff,
                                            ortho=ortho)
    assert tb.dim == js.shape[0]
    np.testing.assert_allclose(np.diag(ts.numpy()), np.diag(np.asarray(js.data)),
                               atol=1e-10)
    np.testing.assert_allclose(terr, jerr, atol=1e-12)
    # the product X·Y is gauge-free
    order = [ti[n] for n in "abcd"]
    jorder = [ji[n] for n in "abcd"]
    np.testing.assert_allclose((tX * tY).numpy(order),
                               np.asarray((jX * jY).array(jorder)), atol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                       (np.complex64, 1e-5)])
def test_qr_factor_and_factorize(dtype, tol):
    rng = np.random.default_rng(3)
    _, ti, arr = _pair(rng, dict(a=3, b=2, c=4))
    A = arr("a", "b", "c").astype(dtype)
    t = to.from_array(A, (ti["a"], ti["b"], ti["c"]))
    Q, R = to.qr_factor(t, [ti["a"], ti["c"]])
    assert Q.dtype == t.dtype
    np.testing.assert_allclose((Q * R).numpy(t.inds), A, atol=tol * 10)
    k = Q.inds[-1]
    q = Q.numpy([ti["a"], ti["c"], k]).reshape(12, k.dim)
    np.testing.assert_allclose(q.conj().T @ q, np.eye(k.dim), atol=tol * 10)
    X, Y, bond = to.factorize(t, [ti["a"]])
    assert bond is X.inds[-1]
    np.testing.assert_allclose((X * Y).numpy(t.inds), A, atol=tol * 10)
    X, Y, bond = to.factorize(t, [ti["a"]], maxdim=2)
    assert bond.dim == 2


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                       (np.complex64, 1e-5)])
def test_pseudo_sqrt_and_eigh(dtype, tol):
    """√M squared against JAX's √M squared (both equal M on its support),
    1/√M·M·1/√M against the projector, and the eigenvalues of M."""
    rng = np.random.default_rng(4)
    n, r = 5, 3
    B = rng.normal(size=(n, r)) + 1j * rng.normal(size=(n, r))
    M = (B @ B.conj().T).astype(dtype)  # rank 3, PSD
    i = to.Index(n)
    ji = jo.Index(n, id=i.id)
    tm = to.from_array(M, (i, i.prime()))
    jm = jo.Tensor(M, (ji, ji.prime()))
    root, inv = to.pseudo_sqrt_inv_sqrt(tm)
    jroot, jinv = jo.pseudo_sqrt_inv_sqrt(jm)
    assert root.dtype == tm.dtype
    r_, jr = root.numpy(), np.asarray(jroot.data)
    scale = np.abs(M).max()
    np.testing.assert_allclose(r_ @ r_, jr @ jr, atol=tol * scale)
    np.testing.assert_allclose(r_ @ r_, M, atol=tol * scale)
    ji_ = np.asarray(jinv.data)
    proj = inv.numpy() @ M @ inv.numpy()
    np.testing.assert_allclose(proj, ji_ @ M @ ji_, atol=tol * 10)
    w, u, odt = to.eigh_tensor(tm)
    jw, _, _ = jo.eigh_tensor(jm)
    assert w.dtype == torch.float64  # 64-bit promotion, as safe_eigen
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=tol * scale)


def _denormal_block() -> np.ndarray:
    """A complex64 8×4 matrix from the Heisenberg-picture example (4×4,
    χ=4): its columns hold denormal entries, and torch's complex64 QR on
    the CPU returns NaN on it (MKL, torch 2.11 and 2.13)."""
    entries = {(0, 0): 0.9928538799285889, (0, 1): 7.226066040181576e-27,
               (0, 2): -2.381445348155465e-26, (0, 3): -1.0725076382556153e-10,
               (1, 0): 5.13089049632024e-34, (2, 0): 1.401298464324817e-45,
               (2, 1): -3.402042898968812e-19, (2, 2): 5.423260951213412e-22,
               (2, 3): -4.883694705286171e-39, (4, 0): -6.522069509748193e-33,
               (4, 1): 4.5862815805500946e-20, (4, 2): -7.311080828054194e-23,
               (4, 3): 6.590530885473907e-40}
    a = np.zeros((8, 4), np.complex64)
    for ij, v in entries.items():
        a[ij] = v
    return a


def test_qr_factor_finite_on_denormal_columns():
    """The generic engine's QR split of the denormal block runs in 64 bits
    and stays finite and exact."""
    a = _denormal_block()
    i, j = to.Index(8), to.Index(4)
    Q, R = to.qr_factor(to.from_array(a, (i, j)), [i])
    assert Q.dtype == torch.complex64
    assert torch.isfinite(Q.data).all() and torch.isfinite(R.data).all()
    np.testing.assert_allclose((Q * R).numpy((i, j)), a, atol=1e-7)


def test_batched_qr_split_finite_on_denormal_columns():
    """The batched engine's default QR split (no ``TNQS_QR_ALG``) of the
    denormal block, alone and in a batch: finite, exact, and |diag R| equal
    to JAX's complex64 QR, which stays finite on it."""
    from tensornetworkquantumsimulator_torch.parallel import engine as t_eng
    from tensornetworkquantumsimulator_tpu.parallel import engine as j_eng

    a = _denormal_block()
    rng = np.random.default_rng(6)
    other = (rng.normal(size=(8, 4)) + 1j * rng.normal(size=(8, 4)))
    for batch in (a[None], np.stack([other.astype(np.complex64), a])):
        q, r = t_eng._qr_split(torch.from_numpy(batch))
        assert q.dtype == r.dtype == torch.complex64
        assert torch.isfinite(q).all() and torch.isfinite(r).all()
        np.testing.assert_allclose((q @ r).numpy(), batch, atol=1e-6)
        _, jr = j_eng._qr_split(batch)
        np.testing.assert_allclose(
            np.abs(np.diagonal(r.numpy(), axis1=-2, axis2=-1)),
            np.abs(np.diagonal(np.asarray(jr), axis1=-2, axis2=-1)),
            atol=1e-6)


def test_batched_qr_refactors_the_matrices_left_non_finite():
    """On CUDA cuBLAS's batched QR returns NaN for some rank-deficient
    matrices with zero columns (heavy-hex at χ=3 on an H100): the engine
    factorizes each matrix whose factors are not finite again alone.  Here
    the batched factors of a [32,9,6] batch with zero columns are spoilt by
    hand: the spoilt matrices come back finite and exact, the others
    untouched."""
    from tensornetworkquantumsimulator_torch.parallel import engine as t_eng

    rng = np.random.default_rng(9)
    x = rng.normal(size=(32, 9, 2)) + 1j * rng.normal(size=(32, 9, 2))
    mat = np.concatenate([x, x @ rng.normal(size=(32, 2, 2)),
                          np.zeros((32, 9, 2))], axis=-1)
    mat = torch.from_numpy(mat.astype(np.complex64))
    q, r = torch.linalg.qr(mat)
    q0, r0 = q.clone(), r.clone()
    q[3, 0, 0] = r[7, 1, 1] = float("nan")
    q, r = t_eng._refactored(mat, q, r)
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    np.testing.assert_allclose((q @ r).numpy(), mat.numpy(), atol=1e-5)
    keep = [i for i in range(32) if i not in (3, 7)]
    assert torch.equal(q[keep], q0[keep]) and torch.equal(r[keep], r0[keep])


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                       (np.complex64, 1e-5)])
def test_eigendecomp_hermitian_matches_jax(dtype, tol):
    """``eigendecomp_hermitian`` against JAX's on the same hermitian PSD
    input: the eigenvalues with the regularization added, and the
    gauge-free reconstruction U·diag(w)·U†."""
    rng = np.random.default_rng(7)
    n = 6
    B = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    M = (B @ B.conj().T).astype(dtype)
    i = to.Index(n)
    ji = jo.Index(n, id=i.id)
    tm = to.from_array(M, (i, i.prime()))
    jm = jo.Tensor(M, (ji, ji.prime()))
    scale = np.abs(M).max()
    for reg in (0.0, 0.25):
        u, w, odt = t_linalg.eigendecomp_hermitian(tm, regularization=reg)
        ju, jw, _ = j_linalg.eigendecomp_hermitian(jm, regularization=reg)
        assert odt == tm.dtype and w.dtype == torch.float64
        assert u.device == tm.data.device
        np.testing.assert_allclose(w.numpy(), np.asarray(jw),
                                   atol=tol * scale)
        un, ju_ = u.numpy(), np.asarray(ju)
        rec = (un * (w.numpy() - reg)) @ un.conj().T
        jrec = (ju_ * (np.asarray(jw) - reg)) @ ju_.conj().T
        np.testing.assert_allclose(rec, jrec, atol=tol * scale)
        np.testing.assert_allclose(rec, M, atol=tol * scale)
    assert not hasattr(to, "eigendecomp_hermitian")  # as in JAX's ops


def test_free_bases_follow_the_reference():
    """Where a factorization may pick its basis, the port on the CPU picks
    JAX's: the QR of the all-ones 4×2 strand a boundary MPS starts from
    (rank 1: the second column is free, and torch's CPU QR returns another
    one), and the SVD of a matrix with a doubly degenerate singular value.
    On host tensors both packages call numpy's LAPACK, so the factors agree
    entry for entry."""
    rng = np.random.default_rng(5)
    jinds, tinds, _ = _pair(rng, {"a": 4, "b": 2, "c": 3, "d": 3})
    ones = np.ones((4, 2), np.complex128)
    qj, rj = jo.qr_factor(jo.Tensor(ones, (jinds["a"], jinds["b"])),
                          [jinds["a"]])
    qt, rt = to.qr_factor(to.from_array(ones, (tinds["a"], tinds["b"])),
                          [tinds["a"]])
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj.data), atol=1e-15)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj.data), atol=1e-15)
    u = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    m = u @ np.diag([2.0, 1.0, 1.0]) @ u.T  # σ = 2, 1, 1
    xj, yj, sj, _, _ = jo.svd_truncated(
        jo.Tensor(m, (jinds["c"], jinds["d"])), [jinds["c"]])
    xt, yt, st, _, _ = to.svd_truncated(
        to.from_array(m, (tinds["c"], tinds["d"])), [tinds["c"]])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj.data), atol=1e-15)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj.data), atol=1e-14)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj.data), atol=1e-14)
