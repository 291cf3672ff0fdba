"""PyTorch port, the Jacobi kernels' schedule (K1 `jacobi_pseudo_roots`, K2
`jacobi_eigh`, `csrc/jacobi.cu`) emulated in float32 numpy: the slot layout
(pairs are always slots 2k, 2k+1; every element moves by `sigma` after a
round), the rotation's guards, the skip of pairs below each caller's noise
floor (K1's; K2 has none), the per-matrix stopping test, and the epilogues
(Newton-Schulz, Rayleigh quotient, sort, clip, roots).  The CUDA kernels
run only on a GPU (`chip_smoke.py` holds them to the same bars there); this
file shows that the algorithm they run meets the bars, and how many sweeps
it takes, before any card is involved.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import KEPT_BAR, kept_ratios

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import engine as te
from tensornetworkquantumsimulator_torch.parallel.cuda_linalg import (
    EIGH_NOISE_FLOOR, ONE_CTA_MAX_N, ROOTS_NOISE_FLOOR)
from tensornetworkquantumsimulator_tpu.parallel import engine as je

torch.set_num_threads(1)

F = np.float32
C = np.complex64
EPS = np.finfo(np.float32).eps


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


# --- the kernel's schedule in float32 ---------------------------------------


def sigma(n):
    """`sigma` of csrc/jacobi.cu: where the content of each slot moves."""
    h = n // 2
    s = np.zeros(n, dtype=np.int64)
    for k in range(h):
        s[2 * k] = 0 if k == 0 else (n - 1 if k == h - 1 else 2 * k + 2)
        s[2 * k + 1] = 2 if k == 0 else 2 * k - 1
    return s


def pow2_floor(x):
    """`pow2_floor`: 2^floor(log2 x) of a normal float32, 0 of a denormal."""
    return (np.asarray(x, F).view(np.int32) & 0x7F800000).view(F)


def pow2_recip(x):
    """`pow2_recip`: 1 / pow2_floor(x) of a normal float32, 2^127 of a
    denormal."""
    return (np.int32(0x7F000000)
            - (np.asarray(x, F).view(np.int32) & 0x7F800000)).view(F)


def rotation(d, c, b, noise):
    """`rotation` of csrc/jacobi.cu on arrays: (cs, sn, u, m)."""
    bx, by = b.real.astype(F), b.imag.astype(F)
    m = np.maximum(np.abs(bx), np.abs(by))
    act = m > F(EPS * 0.03125) * (np.abs(d) + np.abs(c))
    # a pivot below the normal range is left alone (its power-of-two
    # scaling needs a normal m), as is a 2x2 block all at most the
    # caller's noise floor
    act &= m >= np.finfo(F).tiny
    act &= np.maximum(np.maximum(np.abs(d), np.abs(c)), m) > noise
    ms = np.where(act, m, F(1))
    # idle lanes compute on a harmless block
    bx, by = np.where(act, bx, F(1)), np.where(act, by, F(0))
    d, c = np.where(act, d, F(0)), np.where(act, c, F(1))
    rm = pow2_recip(ms)  # exact power-of-two scale: the larger in [1, 2)
    x, y = bx * rm, by * rm
    q = x * x + y * y
    ih = (F(1) / np.sqrt(q)).astype(F)
    absb = q * ih * pow2_floor(ms)
    g = F(0.5) * (c - d)
    rs = pow2_recip(np.maximum(np.abs(g), absb))
    gs, bs = np.abs(g) * rs, absb * rs
    r2 = gs * gs + bs * bs
    t = np.copysign(bs / (gs + r2 * (F(1) / np.sqrt(r2)).astype(F)), g)
    cs = (F(1) / np.sqrt(F(1) + t * t)).astype(F)
    sn = t * cs
    u = np.where(act, x * ih + 1j * (y * ih), 1).astype(C)
    return (np.where(act, cs, F(1)).astype(F),
            np.where(act, sn, F(0)).astype(F), u, m)


def jacobi_emulated(a, max_sweeps=30, noise_floor=EIGH_NOISE_FLOOR):
    """(w in index order, V, sweeps per matrix) as `jacobi_sweeps` computes
    them, all arithmetic in float32; blocks all at most noise_floor·ε·‖A‖_F
    are not rotated (K1 passes ROOTS_NOISE_FLOOR, K2 EIGH_NOISE_FLOOR)."""
    a = np.asarray(a, dtype=C)
    B, n, _ = a.shape
    h = n // 2
    inv = np.argsort(sigma(n))
    A = a.copy()
    V = np.broadcast_to(np.eye(n, dtype=C), a.shape).copy()
    idx = np.tile(np.arange(n), (B, 1))
    fro2 = (A.real.astype(F) ** 2 + A.imag.astype(F) ** 2).sum((1, 2), dtype=F)
    done_below = (F(4 * EPS) * np.sqrt(fro2))[:, None]
    noise = (F(noise_floor) * F(EPS) * np.sqrt(fro2))[:, None]
    active = np.ones(B, bool)
    sweeps = np.zeros(B, int)
    kk = np.arange(h)
    upper = (np.arange(n) // 2)[:, None] < (np.arange(n) // 2)[None, :]
    for _ in range(max_sweeps):
        big = np.zeros(B, bool)
        for _r in range(n - 1):
            d = A[:, 0::2, 0::2].real[:, kk, kk].astype(F)
            c = A[:, 1::2, 1::2].real[:, kk, kk].astype(F)
            b = A[:, 0::2, 1::2][:, kk, kk]
            if n > ONE_CTA_MAX_N:  # a cluster's pivot: the hermitian part
                b = ((b + np.conj(A[:, 1::2, 0::2][:, kk, kk])) / 2).astype(C)
            cs, sn, u, m = rotation(d, c, b, noise)
            big |= (m > done_below).any(1)
            on = active[:, None]  # a matrix that stopped is left as it is
            cs, sn, u = np.where(on, cs, F(1)), np.where(on, sn, F(0)), \
                np.where(on, u, C(1))
            csc, snc, uc = cs[:, None, :], sn[:, None, :], u[:, None, :]
            xp, xq = A[:, :, 0::2], A[:, :, 1::2]
            Y = np.empty_like(A)
            Y[:, :, 0::2] = (csc * (uc * xp) - snc * xq).astype(C)
            Y[:, :, 1::2] = (snc * (uc * xp) + csc * xq).astype(C)
            csr, snr, ur = cs[:, :, None], sn[:, :, None], np.conj(u)[:, :, None]
            yp, yq = Y[:, 0::2, :], Y[:, 1::2, :]
            Z = np.empty_like(A)
            Z[:, 0::2, :] = (csr * (ur * yp) - snr * yq).astype(C)
            Z[:, 1::2, :] = (snr * (ur * yp) + csr * yq).astype(C)
            # one CTA computes the blocks on one side of the diagonal and
            # writes each with its conjugate transpose; a cluster computes
            # every block
            if n <= ONE_CTA_MAX_N:
                Z = np.where(upper, Z,
                             np.where(upper.T, np.conj(Z.swapaxes(1, 2)), Z))
            p, q = idx[:, None, 0::2], idx[:, None, 1::2]
            vp = np.take_along_axis(V, p, 2)
            vq = np.take_along_axis(V, q, 2)
            np.put_along_axis(V, p, (csc * (uc * vp) - snc * vq).astype(C), 2)
            np.put_along_axis(V, q, (snc * (uc * vp) + csc * vq).astype(C), 2)
            A = Z[:, inv][:, :, inv]  # new[sigma(s1), sigma(s2)] = Z[s1, s2]
            idx = idx[:, inv]
        sweeps[active] += 1
        active &= big
        if not active.any():
            break
    w = np.empty((B, n), F)
    np.put_along_axis(w, idx, A.real[:, np.arange(n), np.arange(n)].astype(F), 1)
    return w, V, sweeps


def _mm(x, y):
    return (x @ y).astype(C)


def _herm(x):
    return np.conj(np.swapaxes(x, -1, -2))


def newton_schulz(v):
    n = v.shape[-1]
    return _mm(v, (F(1.5) * np.eye(n, dtype=C) - F(0.5) * _mm(_herm(v), v)))


def rayleigh(a, v):
    return np.einsum("bij,bij->bj", np.conj(v), _mm(a, v)).real.astype(F)


def eigh_emulated(a, **kw):
    """K2 with its polish: (w ascending, V, sweeps); no noise skip unless
    ``noise_floor`` says otherwise."""
    _, v, sweeps = jacobi_emulated(a, **kw)
    v = newton_schulz(v)
    w = rayleigh(np.asarray(a, dtype=C), v)
    order = np.argsort(w, axis=-1, kind="stable")
    return (np.take_along_axis(w, order, -1),
            np.take_along_axis(v, order[:, None, :], -1), sweeps)


def roots_emulated(a, noise_floor=ROOTS_NOISE_FLOOR, **kw):
    """K1: (root, inverse root, sweeps)."""
    _, v, sweeps = jacobi_emulated(a, noise_floor=noise_floor, **kw)
    v = newton_schulz(newton_schulz(v))
    w = rayleigh(np.asarray(a, dtype=C), v)
    wmax = np.abs(w).max(-1, keepdims=True)
    good = w > F(10 * EPS) * np.maximum(wmax, F(EPS))
    sq = np.where(good, np.sqrt(np.where(good, w, F(1))), F(0)).astype(F)
    isq = np.where(good, F(1) / np.where(good, sq, F(1)), F(0)).astype(F)
    return (_mm(v * sq[:, None, :], _herm(v)), _mm(v * isq[:, None, :], _herm(v)),
            sweeps)


# --- batches -----------------------------------------------------------------


def _hermitize(m):
    return ((m + _herm(m)) / 2).astype(C)


def _batch(kind, n, B, rng):
    if kind == "hermitian":
        return _hermitize(rng.standard_normal((B, n, n))
                          + 1j * rng.standard_normal((B, n, n)))
    if kind == "ill":  # 1 ... 1e-5 plus two 1e-9
        q, _ = np.linalg.qr(rng.standard_normal((B, n, n))
                            + 1j * rng.standard_normal((B, n, n)))
        w = np.concatenate([np.logspace(0, -5, n - 2), [1e-9, 1e-9]])
        return _hermitize((q * w) @ _herm(q))
    if kind == "graded":  # a Gram split's: n/4 kept, 1 ... 1e-6, null space
        q, _ = np.linalg.qr(rng.standard_normal((B, n, n))
                            + 1j * rng.standard_normal((B, n, n)))
        w = np.concatenate([np.logspace(0, -6, n // 4), np.zeros(n - n // 4)])
        return _hermitize((q * w) @ _herm(q))
    r = n if kind == "gram" else max(2, n // 4)  # "deficient": rank n/4
    x = rng.standard_normal((B, n, r)) + 1j * rng.standard_normal((B, n, r))
    return _hermitize(x @ _herm(x))


def _eigh_errors(a, w, v):
    """K2's bars: eigenvalues relative to the largest, reconstruction,
    unitarity, then the kept eigenpairs' eigenvalue and subspace errors as
    multiples of the library complex64 eigh's (chip_smoke.kept_ratios:
    the eigenpairs a Gram split keeps, which a bar relative to the largest
    eigenvalue cannot see)."""
    n = a.shape[-1]
    a128 = a.astype(np.complex128)
    w_ref = np.linalg.eigvalsh(a128)
    e_w = np.abs(w - w_ref).max() / np.abs(w_ref).max()
    e_rec = (np.linalg.norm((v * w[:, None, :]) @ _herm(v) - a128)
             / np.linalg.norm(a128))
    e_unit = np.abs(_herm(v).astype(np.complex128) @ v - np.eye(n)).max()
    return (e_w, e_rec, e_unit) + kept_ratios(a, w, v)


KINDS = ("hermitian", "ill", "gram", "deficient", "graded")


@pytest.mark.parametrize("n", [4, 10, 40, 64, 88, 256])
def test_sigma_meets_every_pair_once(n):
    inv, idx, met = np.argsort(sigma(n)), np.arange(n), set()
    for _ in range(n - 1):
        met |= {frozenset((idx[2 * k], idx[2 * k + 1])) for k in range(n // 2)}
        idx = idx[inv]
    assert len(met) == n * (n - 1) // 2
    # a row moves by at most two slots: in a cluster only the rows at a
    # CTA's edge are written to a neighbour
    assert np.abs(sigma(n) - np.arange(n)).max() <= 2


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,B", [(10, 6), (40, 4), (64, 3), (128, 1)])
def test_emulated_schedule_meets_the_bars(n, B, kind):
    """K2's bars (2e-4: eigenvalues, reconstruction, unitarity, order) at
    every size, and K1's (|root^2 - A|/|A| < 2e-5) on the PSD batches."""
    a = _batch(kind, n, B, np.random.default_rng(1000 + n))
    w, v, sweeps = eigh_emulated(a)
    e_w, e_rec, e_unit, kept_w, kept_sub = _eigh_errors(a, w, v)
    assert np.all(np.diff(w, axis=-1) >= 0)
    assert max(e_w, e_rec, e_unit) < 2e-4, (e_w, e_rec, e_unit)
    assert max(kept_w, kept_sub) <= KEPT_BAR, (kept_w, kept_sub)
    assert 2 <= sweeps.min() and sweeps.max() <= 14, sweeps
    print(f"{kind} n={n}: sweeps {sweeps}, eigenvalues {e_w:.1e}, "
          f"reconstruction {e_rec:.1e}, unitarity {e_unit:.1e}, kept "
          f"eigenvalues / subspace {kept_w:.2f} / {kept_sub:.2f} x library")
    if kind != "hermitian":
        root, inv_root, _ = roots_emulated(a)
        rec = (np.linalg.norm(root.astype(np.complex128) @ root - a)
               / np.linalg.norm(a))
        assert rec < 2e-5, rec
        piv = np.linalg.norm(root @ inv_root @ root - root) / np.linalg.norm(root)
        assert piv < 1e-4, piv


@pytest.mark.parametrize("n,B", [(40, 12), (64, 12)])
def test_noise_pairs_skipped_keeps_rank_deficient_sweeps_down(n, B):
    """K1's noise floor.  Rotating the null space's all-noise 2x2 blocks
    refills the couplings between range and null space, and the pivots
    then shrink linearly: with the blocks below ROOTS_NOISE_FLOOR·ε·‖A‖_F
    skipped, a rank-deficient batch takes no more sweeps than a full-rank
    one, and without the skip (K2's EIGH_NOISE_FLOOR, none) 3 sweeps more,
    at most 3 above the full-rank batch.  Both meet the bars."""
    rng = np.random.default_rng(n)
    deficient, full = _batch("deficient", n, B, rng), _batch("gram", n, B, rng)
    _, _, s_full = jacobi_emulated(full)
    w, v, s_skip = eigh_emulated(deficient, noise_floor=ROOTS_NOISE_FLOOR)
    w0, v0, s_rot = eigh_emulated(deficient, noise_floor=EIGH_NOISE_FLOOR)
    print(f"n={n} sweeps: full rank {sorted(s_full.tolist())}, rank n/4 "
          f"with the floor {sorted(s_skip.tolist())}, without "
          f"{sorted(s_rot.tolist())}")
    assert s_skip.max() <= s_full.max()
    assert s_skip.max() + 3 <= s_rot.max() <= s_full.max() + 3, (s_rot, s_skip)
    for w_, v_ in ((w, v), (w0, v0)):
        errs = _eigh_errors(deficient, w_, v_)
        assert max(errs[:3]) < 2e-4, errs
        assert max(errs[3:]) <= KEPT_BAR, errs


@pytest.mark.parametrize("n,B", [(24, 12), (40, 8)])
def test_noise_floor_loses_the_small_kept_eigenpairs(n, B):
    """Why K2 has no noise floor: on a Gram split's graded spectrum (n/4
    kept eigenvalues 1 ... 1e-6, then a null space) K1's floor, 4·ε·‖A‖_F,
    leaves the blocks of the smallest kept eigenpairs and the null space
    unrotated, and the kept subspace's error is past KEPT_BAR times the
    library's; K2 (no floor) stays within it.  n = 24 is the Gram split's
    size at χ = 6 (examples/ising_2d_dynamics.py on the fast stack)."""
    a = _batch("graded", n, B, np.random.default_rng(n))
    floored = kept_ratios(a, *eigh_emulated(
        a, noise_floor=ROOTS_NOISE_FLOOR)[:2])
    k2 = kept_ratios(a, *eigh_emulated(a)[:2])
    print(f"n={n}: kept eigenvalues / subspace x library: with K1's floor "
          f"{floored[0]:.2f} / {floored[1]:.2f}, K2 {k2[0]:.2f} / {k2[1]:.2f}")
    assert floored[1] > KEPT_BAR, floored
    assert max(k2) <= KEPT_BAR, k2


def test_denormal_pivots_of_a_padded_block_stay_finite():
    """K2 rotates every block, the null space's too, so it meets pivots
    below float32's normal range (a zero-padded bond's block, d = c = 0,
    with couplings at 1e-40): the power-of-two scaling of `rotation` would
    turn one into 0 * inf.  Such a pivot is left alone; K1 and K2 stay
    finite and exact on the range."""
    n = 8
    a = np.zeros((2, n, n), C)
    a[:, np.arange(n // 2), np.arange(n // 2)] = np.logspace(0, -3, n // 2)
    for p, q, x in ((4, 5, 1e-40), (6, 7, 3e-41j), (5, 6, 2e-40)):
        a[:, p, q], a[:, q, p] = x, np.conj(x)
    w, v, _ = eigh_emulated(a)
    assert np.isfinite(w).all() and np.isfinite(v).all()
    errs = _eigh_errors(a, w, v)
    assert max(errs[:3]) < 1e-6 and max(errs[3:]) <= KEPT_BAR, errs
    root, inv_root, _ = roots_emulated(a)
    assert np.isfinite(root).all() and np.isfinite(inv_root).all()


def test_identity_stops_after_one_sweep():
    a = np.broadcast_to(np.eye(10, dtype=C), (2, 10, 10))
    root, inv_root, sweeps = roots_emulated(a)
    assert list(sweeps) == [1, 1]
    assert np.abs(root - np.eye(10)).max() < 1e-6
    assert np.abs(inv_root - np.eye(10)).max() < 1e-6


# --- the engine at the cluster size, on the CPU --------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.complex64, 1e-5),
                                       (np.complex128, 1e-10)])
def test_gram_split_n256_matches_jax(dtype, tol, monkeypatch):
    """`_eigh` / `_gram_split` at the chi = 64 Gram size, n = 256, rank-
    deficient as on the main path: on the CPU the port takes its plain
    eigh whatever the knob says, and equals the JAX package's."""
    monkeypatch.setenv("TNQS_EIGH_ALG", "jacobi")
    rng = np.random.default_rng(256)
    x = rng.normal(size=(2, 256, 96)) + 1j * rng.normal(size=(2, 256, 96))
    y = rng.normal(size=(2, 96, 256)) + 1j * rng.normal(size=(2, 96, 256))
    a = (x @ y / 96).astype(dtype)  # rank 96
    u, s, vh = (t.resolve_conj().numpy()
                for t in te._gram_split(torch.from_numpy(a)))
    ju, js, jvh = (np.asarray(t) for t in je._gram_split(jnp.asarray(a)))
    scale = js.max()
    # a Gram split resolves singular values to sqrt(eps): the null ones
    # agree to sqrt(tol), those above the split's resolution to tol
    np.testing.assert_allclose(s / scale, js / scale, atol=tol ** 0.5)
    keep = js > scale * (1e-2 if dtype == np.complex64 else 1e-6)
    np.testing.assert_allclose(s[keep] / scale, js[keep] / scale, atol=tol)
    rec = (u * s[:, None, :]) @ vh
    jrec = (ju * js[:, None, :]) @ jvh
    np.testing.assert_allclose(rec, a, atol=tol * 50 * np.abs(a).max())
    np.testing.assert_allclose(rec, jrec, atol=tol * 50 * np.abs(a).max())
    w, v = te._eigh(torch.from_numpy(_hermitize(a @ _herm(a)).astype(dtype)))
    assert w.shape == (2, 256) and v.shape == (2, 256, 256)
    assert bool((w[:, 1:] >= w[:, :-1]).all())
