"""PyTorch port, K4: the Gauss-trick complex matmul (`cuda_matmul`) against
the JAX Pallas kernel in interpret mode, on the reference tests' shapes,
the microbenchmark's shapes and a ragged one; and the microbenchmark's
step against its arithmetic.

Both sides compute in float32 on the re/im planes, so the bar is the
reference tests' own: max|C − A@B| / max|A@B| < 1e-5
(tests/test_pallas_kernels.py:24,39), against a complex128 numpy A@B."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import microbench
from tensornetworkquantumsimulator_torch.parallel import cuda_matmul as tm
from tensornetworkquantumsimulator_tpu.parallel.pallas_kernels import (
    complex_matmul as j_complex_matmul,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


# (seed, a shape, b shape): the reference tests', the microbenchmark's
# a @ a at its sweep shapes, and a ragged one (no dimension a multiple of 8)
_SHAPES = {
    "square128": (3, (3, 128, 128), (3, 128, 128)),
    "rectangular": (4, (2, 64, 128), (2, 128, 256)),
    "micro16x40": (5, (16, 40, 40), (16, 40, 40)),
    "micro8x128": (6, (8, 128, 128), (8, 128, 128)),
    "ragged": (7, (5, 33, 17), (5, 17, 65)),
}


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _scaled_err(c, ref):
    return float(np.abs(c - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_torch_gauss_matmul_matches_jax_interpret(name):
    seed, sa, sb = _SHAPES[name]
    rng = np.random.default_rng(seed)
    a, b = _complex(rng, sa), _complex(rng, sb)
    ref = a.astype(np.complex128) @ b.astype(np.complex128)
    c_j = np.asarray(j_complex_matmul(a, b, interpret=True))
    before = tm.matmul_launches.count
    c_t = tm.complex_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert tm.matmul_launches.count == before  # CPU tensors: plain version
    assert c_t.dtype == torch.complex64 and c_t.shape == ref.shape
    c_t = c_t.numpy()
    assert _scaled_err(c_j, ref) < 1e-5
    assert _scaled_err(c_t, ref) < 1e-5
    assert _scaled_err(c_t, c_j) < 1e-5


def test_torch_gauss_matmul_keeps_input_dtype_and_checks_shapes():
    rng = np.random.default_rng(8)
    a = _complex(rng, (2, 6, 5)).astype(np.complex128)
    b = _complex(rng, (2, 5, 3)).astype(np.complex128)
    c = tm.complex_matmul(torch.from_numpy(a), torch.from_numpy(b))
    # the reference casts back to a.dtype after an fp32 computation
    assert c.dtype == torch.complex128
    assert _scaled_err(c.numpy(), a @ b) < 1e-5
    with pytest.raises(ValueError, match="expected"):
        tm.complex_matmul(torch.from_numpy(a), torch.from_numpy(a))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32: 10 mantissa bits, to nearest (ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds on the card)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _real_product(x, y, split):
    """float32 x @ y as the tensor cores form it: one TF32 product, or the
    3xTF32 split x = hi + lo, y = hi + lo, lo·hi + hi·lo + hi·hi."""
    if split == "tf32":
        return _tf32(x) @ _tf32(y)
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    return xl @ yh + xh @ yl + xh @ yh


def _gauss(a, b, split):
    """complex64 a @ b by the Gauss trick, each real product in ``split``."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    p1 = _real_product(ar, br, split)
    p2 = _real_product(ai, bi, split)
    p3 = _real_product(ar + ai, br + bi, split)
    return torch.complex(p1 - p2, p3 - p1 - p2)


def _four(a, b, split):
    """complex64 a @ b by four real products, each in ``split`` (K3's
    form: Cr = Ar Br − Ai Bi, Ci = Ar Bi + Ai Br)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(
        _real_product(ar, br, split) - _real_product(ai, bi, split),
        _real_product(ar, bi, split) + _real_product(ai, br, split))


def _absorb(x, m, axis, split):
    """Σ_l x[v, .., l, ..] m[v, l, l'] along ``axis``, by ``_four``."""
    x2 = torch.movedim(x, axis, -1)
    out = _four(x2.reshape(x2.shape[0], -1, x2.shape[-1]), m, split)
    return torch.movedim(out.reshape(x2.shape), -1, axis)


def _k3_emulated(t, m, split):
    """K3's chain as the kernels run it: t ×1 m1 ×2 m2 for slot 0,
    P = t ×0 m0 then P ×2 m2 and P ×1 m1 for slots 1 and 2, each message
    the absorbed tensor times conj(t) over the other legs, every product
    in the four-product form."""
    V, chi = t.shape[:2]
    y = _absorb(t, m[:, 1], 2, split)
    p = _absorb(t, m[:, 0], 1, split)
    xs = (_absorb(y, m[:, 2], 3, split), _absorb(p, m[:, 2], 3, split),
          _absorb(p, m[:, 1], 2, split))
    outs = []
    for j, x in enumerate(xs):
        a = torch.movedim(x, 1 + j, 1).reshape(V, chi, -1)
        b = torch.movedim(t, 1 + j, 1).reshape(V, chi, -1).conj().mT
        outs.append(_four(a, b.resolve_conj(), split))
    return torch.stack(outs, dim=1)


# K4's shapes, and K3 at small chi (its contractions run over chi^2 d)
_SPLIT_CASES = sorted(_SHAPES) + ["k3_chi8", "k3_chi16"]


@pytest.mark.parametrize("name", _SPLIT_CASES)
def test_tf32x3_split_keeps_the_bar_and_tf32_does_not(name):
    """The precision argument of the tensor-core kernels, emulated on the
    CPU: the 3xTF32 products (K4's Gauss form, K3's four-product form)
    meet the bars (K4 1e-5, K3 2e-5, scaled, against complex128); one TF32
    product per plane does not."""
    if name.startswith("k3"):
        from test_torch_bp import _random_state
        from tensornetworkquantumsimulator_torch.parallel import cuda_bp

        t, m = _random_state(np.random.default_rng(12), 3,
                             int(name[len("k3_chi"):]), 2)
        ref = cuda_bp.bp_outgoing_plain(
            torch.from_numpy(t.astype(np.complex128)),
            torch.from_numpy(m.astype(np.complex128))).numpy()
        run = lambda split: _k3_emulated(  # noqa: E731
            torch.from_numpy(t), torch.from_numpy(m), split)
        bar = 2e-5
    else:
        seed, sa, sb = _SHAPES[name]
        rng = np.random.default_rng(seed)
        a, b = _complex(rng, sa), _complex(rng, sb)
        ref = a.astype(np.complex128) @ b.astype(np.complex128)
        run = lambda split: _gauss(  # noqa: E731
            torch.from_numpy(a), torch.from_numpy(b), split)
        bar = 1e-5
    err3 = _scaled_err(run("tf32x3").numpy(), ref)
    err1 = _scaled_err(run("tf32").numpy(), ref)
    assert err3 < bar, (err3, bar)
    assert err1 > bar, (err1, bar)


@pytest.mark.parametrize("op", microbench.OPS)
def test_torch_microbench_step_arithmetic(op):
    """Each op's step is its reconstruction (A for svd/gram/qr, A + A† for
    the eighs, A @ A for the matmuls), renormalized per batch element
    plus 1e-3, as in scripts/microbench.py:45-85."""
    rng = np.random.default_rng(9)
    a = _complex(rng, (3, 12, 12))
    if op in ("eigh", "jeigh"):
        out = a + np.conj(np.swapaxes(a, -1, -2))
    elif op in ("matmul", "cmatmul", "cpallas"):
        out = a.astype(np.complex128) @ a
    else:
        out = a
    nrm = np.linalg.norm(out.reshape(3, -1), axis=-1)[:, None, None]
    expect = out / nrm + 1e-3
    got = microbench.step(op, torch.from_numpy(a)).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, expect, atol=2e-6)


@pytest.mark.parametrize("b,n", microbench.SWEEP_SHAPES)
def test_torch_microbench_qr_step_at_the_chain_fixed_point(b, n):
    """The chain converges to a batch whose complex columns are all equal
    (on the card, cuBLAS's batched QR turns it to NaN; chip_smoke.py
    checks the step there): the qr step, one matrix per QR, reconstructs
    it at the sweep shapes."""
    a = np.full((b, n, n), 0.0088 + 0.0088j, dtype=np.complex64)
    q, r = microbench.library_qr(torch.from_numpy(a))
    np.testing.assert_allclose((q @ r).numpy(), a, atol=1e-6)
    got = microbench.step("qr", torch.from_numpy(a)).numpy()
    expect = a / np.linalg.norm(a.reshape(b, -1), axis=-1)[:, None, None] + 1e-3
    np.testing.assert_allclose(got, expect, atol=2e-6)


def test_torch_microbench_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.run("cpallas", 2, 8, 3)
    assert microbench.main(["cpallas", "2", "8", "3"]) != 0
    assert microbench.main(["--sweep"]) != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line
