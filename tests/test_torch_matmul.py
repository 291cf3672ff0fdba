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

from tensornetworkquantumsimulator_torch import microbench
from tensornetworkquantumsimulator_torch.parallel import cuda_matmul as tm
from tensornetworkquantumsimulator_tpu.parallel.pallas_kernels import (
    complex_matmul as j_complex_matmul,
)

torch.set_num_threads(1)

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
