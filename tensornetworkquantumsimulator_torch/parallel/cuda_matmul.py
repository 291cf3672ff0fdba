"""Batched complex64 matmul by the Gauss trick as a CUDA kernel (K4).

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
pallas_kernels.complex_matmul``: C = A @ B per batch element from three
real products on the re/im planes, P1 = Ar·Br, P2 = Ai·Bi,
P3 = (Ar+Ai)(Br+Bi), Cr = P1 − P2, Ci = P3 − P1 − P2, accumulated in fp32
and cast back to ``a.dtype``.  The kernel lives in ``csrc/complex_matmul.cu``
and runs the products on the tensor cores with a 3xTF32 split
(``csrc/complex_tf32x3.cuh``, in its Gauss form).

At the microbenchmark's shapes the call is the cost, so the CUDA path is
short: the bound C function is looked up once (``cuda_build.launch``),
and contiguous, unconjugated operands are passed as they are.

No engine path calls it, as in the JAX package: its caller is the
factorization microbenchmark (``microbench``, op ``cpallas``), where it is
the A/B partner of cuBLAS's complex GEMM (op ``cmatmul``).

:func:`complex_matmul_plain` is the plain version: the same formula as
three float32 ``torch.matmul`` on the planes.  The wrapper takes it only
for a CPU tensor; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..utils.profiling import Counter
from . import cuda_build

matmul_launches = Counter("launches.complex_matmul")


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or (
            a.shape[2] != b.shape[1]):
        raise ValueError(f"complex_matmul: expected [B, N, K] @ [B, K, M], "
                         f"got {tuple(a.shape)} @ {tuple(b.shape)}")


def complex_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the Gauss formula as three float32 matmuls."""
    _check_shapes(a, b)
    ar, ai = a.real.float(), a.imag.float()
    br, bi = b.real.float(), b.imag.float()
    p1 = torch.matmul(ar, br)
    p2 = torch.matmul(ai, bi)
    p3 = torch.matmul(ar + ai, br + bi)
    return torch.complex(p1 - p2, p3 - p1 - p2).to(a.dtype)


def complex_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C [B, N, M] = A [B, N, K] @ B [B, K, M] for complex64 batches, any
    N, K, M (the reference's multiple-of-8 rule was a TPU tile size)."""
    _check_shapes(a, b)
    if not a.is_cuda:
        return complex_matmul_plain(a, b)
    if not (b.is_cuda and b.device == a.device):
        raise ValueError("complex_matmul: a and b must share a CUDA device")
    if a.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise TypeError(f"complex_matmul: CUDA kernel takes complex64, got "
                        f"{a.dtype} @ {b.dtype}")
    B, N, K = a.shape
    M = b.shape[2]
    c = torch.empty((B, N, M), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    # the short path: no copies for contiguous, unconjugated operands
    if a.is_conj() or not a.is_contiguous():
        a = a.resolve_conj().contiguous()
    if b.is_conj() or not b.is_contiguous():
        b = b.resolve_conj().contiguous()
    cuda_build.launch("tnqs_complex_matmul", a.device, a.data_ptr(),
                      b.data_ptr(), c.data_ptr(), B, N, K, M)
    matmul_launches.count += 1
    return c
