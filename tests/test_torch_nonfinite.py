"""PyTorch port, CholeskyQR on blocks whose ridged Cholesky fails, and the
Jacobi kernels (K1, K2) on non-finite matrices.

On an H100 the float32 Gram of an Eagle χ=64 block ([4096, 128]) carries
rounding that grows with the block's rows; on two blocks at step 7 of
θ_h = 0.961737 its null-space eigenvalues read −1.24e-6 and −1.30e-6 of the
trace, below the ridge's −1.19e-6, and the ridged factorization failed.
The CPU's Gram of the same blocks is ~30 times more accurate (−3.9e-8 of
the trace), so here a block conditioned as those is given the card's
Gram: its own plus a null-space error of that size
(:func:`_card_gram`).

No JAX here: the card's test runs in this file too."""

import math

import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as par
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import cuda_linalg, engine
from tensornetworkquantumsimulator_torch.utils import profiling

torch.set_num_threads(1)

_Z = tt.op_matrix("Z", 2)
# the card's null-space error, a little more than it read (1.30e-6), so
# that the CPU Gram's own rounding (~4e-8 of the trace) cannot decide
CARD_ERROR = 1.5e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _eagle_block(seed, m=4096, k=128):
    """A complex64 [m, k] block conditioned as the card's failing ones: 64
    singular values from 1 down to 2e-2 and 64 from 7e-6 down to 7e-8 (of
    the largest), trace 1.5e-3."""
    g = torch.Generator().manual_seed(seed)
    u, _ = torch.linalg.qr(torch.randn(m, k, dtype=torch.complex128,
                                       generator=g))
    v, _ = torch.linalg.qr(torch.randn(k, k, dtype=torch.complex128,
                                       generator=g))
    s = torch.cat([torch.logspace(0, math.log10(2e-2), k // 2,
                                  dtype=torch.float64),
                   torch.logspace(math.log10(7e-6), math.log10(7e-8), k // 2,
                                  dtype=torch.float64)])
    a = (u * s) @ v.mH
    return (a * math.sqrt(1.5e-3 / float((s * s).sum()))).to(torch.complex64)


def _card_gram(a, bad):
    """A†A of the batch ``a`` as the card forms it: the matrices ``bad``
    take an error of −CARD_ERROR·tr along their four smallest right
    singular directions."""
    gram = a.mH @ a
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1).real
    v = torch.linalg.svd(a.to(torch.complex128),
                         full_matrices=False)[2].mH[..., -4:]
    err = (v @ v.mH).to(gram.dtype) * (CARD_ERROR * tr)[:, None, None].to(
        gram.dtype)
    return gram - err * bad[:, None, None].to(gram.dtype)


def _old_chol_once(mat, gram):
    """One CholeskyQR pass as the port made it before the fallback, from
    the Gram ``gram`` of ``mat``."""
    k = gram.shape[-1]
    eps = torch.finfo(gram.real.dtype).eps
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1).real
    ridge = (10.0 * k * eps * (tr / k + eps)).to(gram.dtype)
    eye = torch.eye(k, dtype=gram.dtype)
    ell, info = torch.linalg.cholesky_ex(
        cuda_linalg.hermitize(gram + ridge[..., None, None] * eye))
    q = torch.linalg.solve_triangular(ell.mH, mat, upper=True, left=False)
    return q, ell.mH, info


def _card_first_pass(monkeypatch, a, bad):
    """``engine._ridged_cholesky`` with the card's Gram for the block
    ``a`` (the first CholeskyQR pass); any other input as it is."""
    gram_cholesky = engine._gram_cholesky

    def ridged(mat, shifted=None):
        gram = _card_gram(mat, bad) if mat is a else mat.mH @ mat
        return gram_cholesky(gram, mat.shape[-2], shifted)

    monkeypatch.setattr(engine, "_ridged_cholesky", ridged)


def _orthonormal_error(q, r, rank):
    """‖Q_r†Q_r − I‖₂ on the ``rank`` leading left singular directions of
    R (the block's range), per matrix, in complex128."""
    u = torch.linalg.svd(r.to(torch.complex128))[0][..., :rank]
    qs = q.to(torch.complex128) @ u
    eye = torch.eye(rank, dtype=torch.complex128)
    return torch.linalg.matrix_norm(qs.mH @ qs - eye, ord=2)


def test_cholqr2_takes_the_shift_where_the_ridged_factor_fails(monkeypatch):
    """Block 0 carries the card's Gram and fails the ridged factorization,
    as the port's CholeskyQR2 failed on the card; blocks 1 and 2 do not.
    With the fallback every factor is finite, Q·R = A to 1e-6 of ‖A‖ (read
    ~1e-7) and Q is orthonormal on the block's 64 leading directions to
    1e-3 (read 1.7e-4 on the card's own blocks, 8e-5 without the card's
    error); blocks 1 and 2 come out bit for bit as before."""
    monkeypatch.setenv("TNQS_QR_ALG", "cholqr2")
    a = torch.stack([_eagle_block(s) for s in (1, 2, 3)])
    bad = torch.tensor([True, False, False])
    # as before: block 0's ridged factorization fails
    q1, m1, info1 = _old_chol_once(a, _card_gram(a, bad))
    assert info1[0] != 0 and info1[1:].tolist() == [0, 0]
    q_old, m2, info2 = _old_chol_once(q1, q1.mH @ q1)
    r_old = m2 @ m1

    _card_first_pass(monkeypatch, a, bad)
    shifted = []
    q, r = engine._qr_split(a, shifted)
    assert [s.tolist() for s in shifted] == [[True, False, False],
                                             [False, False, False]]
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    a64 = a.to(torch.complex128)
    rec = torch.linalg.matrix_norm(q.to(torch.complex128)
                                   @ r.to(torch.complex128) - a64)
    assert (rec / torch.linalg.matrix_norm(a64)).max() <= 1e-6
    assert _orthonormal_error(q, r, 64).max() <= 1e-3
    assert torch.equal(q[1:], q_old[1:]) and torch.equal(r[1:], r_old[1:])


@pytest.mark.parametrize("route", ["cholqr1", "defer"])
def test_the_other_cholesky_routes_take_the_shift_too(monkeypatch, route):
    """The single pass and the deferred Q share the factorization: finite
    factors where the ridged one fails, the others as before."""
    monkeypatch.setenv("TNQS_QR_ALG", route)
    a = torch.stack([_eagle_block(s) for s in (4, 5)])
    bad = torch.tensor([True, False])
    _, m_old, info = _old_chol_once(a, _card_gram(a, bad))
    assert info[0] != 0 and info[1] == 0
    _card_first_pass(monkeypatch, a, bad)
    shifted = []
    q, r, deferred = engine._qr_reduce(a, shifted)
    assert deferred == (route == "defer")
    assert [s.tolist() for s in shifted] == [[True, False]]
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    assert torch.equal(r[1], m_old[1])


def test_a_non_finite_block_gives_nan_factors_the_others_as_before(
        monkeypatch):
    """No factorization succeeds on a block holding a NaN: its factors are
    NaN, never a finite wrong answer, and the batch's others are those of
    a batch without it."""
    monkeypatch.setenv("TNQS_QR_ALG", "cholqr2")
    g = torch.Generator().manual_seed(7)
    a = torch.randn(3, 96, 24, dtype=torch.complex64, generator=g)
    a[1, 5, 7] = float("nan")
    shifted = []
    q, r = engine._qr_split(a, shifted)
    assert shifted[0].tolist() == [False, True, False]
    assert torch.isnan(q[1]).all() and torch.isnan(r[1]).all()
    q_rest, r_rest = engine._qr_split(a[[0, 2]])
    assert torch.equal(q[[0, 2]], q_rest) and torch.equal(r[[0, 2]], r_rest)


class _Plain:
    """A CUDA graph capture as a plain call: a "replay" runs the stretch
    again and copies its outputs into the first run's (as
    ``tests/test_torch_su_graphs.py`` drives the graph path on the CPU)."""

    def __init__(self, device):
        pass

    def __call__(self, fn):
        outs = fn()

        def replay():
            for out, new in zip(outs, fn()):
                out.copy_(new)

        return replay, outs


@pytest.mark.parametrize("graphs", [False, True])
def test_the_update_counts_the_shifted_factors(monkeypatch, graphs):
    """Each CholeskyQR pass of the update counts its factors
    (``qr.chol_factors``) and, summed on the device, those that took a
    shift (``qr.chol_shifted``), eager or through the graphs' replays.
    Here every Gram loses 1e-5 of its trace, which fails the ridged
    factorization of each rank-deficient block."""
    import collections

    from tensornetworkquantumsimulator_torch.parallel import su_graphs

    for knob, value in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                        ("TNQS_QR_ALG", "cholqr2")):
        monkeypatch.setenv(knob, value)
    monkeypatch.setattr(su_graphs, "_cache", collections.OrderedDict())
    monkeypatch.setattr(su_graphs, "_captures", {})
    if graphs:
        monkeypatch.setattr(su_graphs, "Capture", _Plain)
        monkeypatch.setattr(su_graphs, "_capturable", lambda device: True)
    g = tt.named_grid((3, 3))
    spec, state = par.batched_product_state(g, chi=4, dtype=torch.complex64)
    _, layer = par.make_field_layer_fn(g, 4, site_pauli=("X", "Z"),
                                       cutoff=1e-10, bp_maxiter=20, spec=spec)
    V, E = spec.num_vertices, len(spec.edges)
    site = torch.tensor([[0.5] * V, [0.4] * V], dtype=torch.float64)
    bond = torch.linspace(0.2, 0.9, E, dtype=torch.float64)
    per_pass = 2 * E  # both endpoints of every edge, once a layer
    gram_cholesky = engine._gram_cholesky

    def lossy(mat, shifted=None):
        gram = mat.mH @ mat
        tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1).real
        eye = torch.eye(gram.shape[-1], dtype=gram.dtype)
        gram = gram - (1e-5 * tr)[:, None, None].to(gram.dtype) * eye
        return gram_cholesky(gram, mat.shape[-2], shifted)

    counts = []
    for lose in (False, True):
        if lose:
            monkeypatch.setattr(engine, "_ridged_cholesky", lossy)
        st = state
        with profiling.tracing() as handle:
            for _ in range(3):  # eager, capture, replay
                st, _err = layer(st, site, bond)
            c = handle.collect()["counters"]
        counts.append((c["qr.chol_factors"], c["qr.chol_shifted"]))
        z = par.local_expectations(spec, st, _Z).real
        assert torch.isfinite(z).all()
    (factors, none), (factors_lossy, shifted) = counts
    assert factors == factors_lossy == 3 * 2 * per_pass and none == 0
    # from the second layer on, every bond is rank-deficient (χ=4 buffers)
    assert 2 * 2 * per_pass <= shifted <= factors


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_CARD = "needs a CUDA card: K1 and K2 run only there"


def _psd_batch(batch, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, n, n, dtype=torch.complex64, device="cuda",
                    generator=g)
    return x @ x.mH / n


@pytest.mark.card
def test_k1_and_k2_return_nan_for_a_non_finite_matrix_and_the_context_lives(
        monkeypatch):
    """24 launches of K1 (n=10) and K2 (n=40 and 64 on one CTA a matrix,
    n=256 on a cluster), each on a batch holding one matrix with a NaN or
    an Inf: that matrix comes back all NaN, every other equals its result
    in a batch without it, bit for bit; then the same process runs a χ=10
    layer on the fast stack (K1 and K2 launch) whose ⟨Z⟩ agrees with the
    CPU's to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    for knob, value in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                        ("TNQS_QR_ALG", "cholqr2")):
        monkeypatch.setenv(knob, value)
    launches = 0
    for rep in range(3):
        for kind, n in (("k1", 10), ("k2", 40), ("k2", 64), ("k2", 256)):
            for bad_value in (float("nan"), float("inf")):
                h = _psd_batch(4, n, seed=100 * rep + n)
                spoilt = h.clone()
                spoilt[2, 1, n - 1] = bad_value
                if kind == "k1":
                    got = cuda_linalg.jacobi_pseudo_roots(spoilt)
                    want = cuda_linalg.jacobi_pseudo_roots(h[[0, 1, 3]])
                else:
                    got = cuda_linalg.jacobi_eigh(spoilt)
                    want = cuda_linalg.jacobi_eigh(h[[0, 1, 3]])
                torch.cuda.synchronize()
                launches += 2
                for x, y in zip(got, want):
                    assert torch.isnan(x[2]).all(), (kind, n, bad_value)
                    assert torch.equal(x[[0, 1, 3]], y), (kind, n, bad_value)
    assert launches >= 20

    def chi10(device):
        g = tt.named_grid((5, 5))
        spec, state = par.batched_product_state(g, chi=10,
                                                dtype=torch.complex64,
                                                device=device)
        _, layer = par.make_field_layer_fn(g, 10, site_pauli=("X", "Z"),
                                           cutoff=1e-10, bp_maxiter=25,
                                           spec=spec, device=device)
        V, E = spec.num_vertices, len(spec.edges)
        site = torch.tensor([[0.5] * V, [0.4] * V], dtype=torch.float64,
                            device=device)
        bond = torch.full((E,), 0.25, dtype=torch.float64, device=device)
        for _ in range(3):
            state, _ = layer(state, site, bond)
        return par.local_expectations(spec, state, _Z).real.cpu()

    before = (cuda_linalg.roots_launches.count,
              cuda_linalg.eigh_launches.count)
    z_card = chi10("cuda")
    assert cuda_linalg.roots_launches.count > before[0]
    assert cuda_linalg.eigh_launches.count > before[1]
    z_cpu = chi10("cpu")
    assert float((z_card - z_cpu).abs().max()) <= 1e-4
