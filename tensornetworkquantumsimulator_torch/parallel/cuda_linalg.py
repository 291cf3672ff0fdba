"""Batched hermitian Jacobi eigh and fused pseudo-roots as CUDA kernels.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
pallas_linalg``.  Two kernels share one parallel-ordered cyclic Jacobi
device routine (``csrc/jacobi.cu``), which stops each matrix by a
convergence test (capped at :data:`MAX_SWEEPS`) and can report the sweeps
each matrix ran:

- :func:`jacobi_pseudo_roots` (K1) runs the whole environment-root stage
  of the simple update in one launch: Jacobi, two Newton–Schulz unitarity
  passes, Rayleigh re-extraction from the original matrix, the 10·ε·λmax
  clip and both reconstructions U√wU†, Uw^-½U†.
- :func:`jacobi_eigh` (K2) returns ascending eigenvalues and eigenvectors:
  Jacobi, one Newton–Schulz pass, a Rayleigh quotient and the sort, in one
  launch with one CTA per matrix up to n = 88; above that a cluster of 8
  CTAs holds one matrix and the polish follows in PyTorch.

Beside each wrapper sits its plain PyTorch version (the reference's
non-kernel path).  A wrapper takes the plain version only for a CPU
tensor; on a CUDA tensor it launches the kernel or raises.  K1's shape
gate is the reference's; K2's is the reference's up to n = 88 and this
card's above it (:func:`eigh_kernel_supported`).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import cuda_build


# kernel launches, one per wrapper call that reaches the kernel (always
# counted)
roots_launches = profiling.Counter("launches.jacobi_pseudo_roots")
eigh_launches = profiling.Counter("launches.jacobi_eigh")
# while tracing: the Jacobi sweeps each launch's matrices ran (the kernel's
# own count, summed on the device) and the matrices launched
roots_sweeps = profiling.Counter("jacobi.roots_sweeps")
roots_matrices = profiling.Counter("jacobi.roots_matrices")
eigh_sweeps = profiling.Counter("jacobi.eigh_sweeps")
eigh_matrices = profiling.Counter("jacobi.eigh_matrices")


# Cap of the kernels' per-matrix convergence test: each matrix stops after
# the first sweep in which every off-diagonal was at most 4·ε·‖A‖_F.  The
# reference runs a fixed 6-8 sweeps, which leaves spectra spanning several
# decades unconverged at n ≥ 32.
MAX_SWEEPS = 30

# Noise floors, in units of ε·‖A‖_F: a 2×2 block whose |d|, |c| and |b| are
# all at most the floor is not rotated.  Rotating a rank-deficient matrix's
# null-space blocks (pure rounding noise) at angles of order one refills
# the couplings between range and null space and costs sweeps, so K1 skips
# them: its clip zeroes every eigenvalue below 10·ε·λmax anyway.  K2 skips
# nothing: the Gram split keeps eigenvalues down to 1e-10 of the trace,
# far below 4·ε·‖A‖_F, and a skipped block of a kept and a dropped
# eigenpair leaves the kept subspace off by an angle of order one.
ROOTS_NOISE_FLOOR = 4.0
EIGH_NOISE_FLOOR = 0.0

# One CTA holds a matrix up to this n: both copies of A, V and a strip of
# rotations per warp, 3·n²·8 + 32·(n/2)·16 bytes = 208 KB at n = 88, of the
# 227 KB a block may use on an H100 (the reference's limit is the same 88).
ONE_CTA_MAX_N = 88
# Above it a thread block cluster of 8 CTAs holds a matrix, n/8 rows each:
# 3·n² bytes a CTA, 192 KB at n = 256 (n = 272 would need 217 KB + tables,
# and 8 is the largest portable cluster), n a multiple of 16 so that every
# CTA owns whole pairs.
CLUSTER_CTAS = 8
CLUSTER_MAX_N = 256


def roots_kernel_supported(n: int, batch: int) -> bool:
    """Shape gate of K1: the reference's (even 4 ≤ n ≤ 40)."""
    return n % 2 == 0 and 4 <= n <= 40 and batch > 0


def eigh_kernel_supported(n: int, batch: int) -> bool:
    """Shape gate of K2 on an H100: even 4 ≤ n ≤ 88 in one CTA's shared
    memory (as in the reference), and multiples of 16 up to 256 in the
    distributed shared memory of a cluster of 8 CTAs (:data:`CLUSTER_MAX_N`);
    other n go to the library eigh."""
    if batch <= 0:
        return False
    if n <= ONE_CTA_MAX_N:
        return n % 2 == 0 and n >= 4
    return n % (2 * CLUSTER_CTAS) == 0 and n <= CLUSTER_MAX_N


def hermitize(m: torch.Tensor) -> torch.Tensor:
    """(M + M†)/2.  ``torch.linalg.eigh`` reads only the lower triangle
    where ``jnp.linalg.eigh`` symmetrizes its input, so every library
    eigh and Cholesky of the port goes through this first."""
    return 0.5 * (m + m.mH)


def clip_roots(w: torch.Tensor, u: torch.Tensor):
    """(√M, 1/√M) from an eigendecomposition, eigenvalues ≤ 10·ε·λmax
    zeroed in both (`utils.jl:18-26`; engine.py's `_pseudo_roots`)."""
    eps = torch.finfo(w.dtype).eps
    wmax = w.abs().amax(dim=-1, keepdim=True)
    good = w > 10 * eps * torch.clamp(wmax, min=eps)
    safe = torch.where(good, w, torch.ones_like(w))
    zero = torch.zeros_like(w)
    sq = torch.where(good, torch.sqrt(safe), zero)
    isq = torch.where(good, 1.0 / torch.sqrt(safe), zero)
    uh = u.mH
    root = (u * sq[..., None, :].to(u.dtype)) @ uh
    inv_root = (u * isq[..., None, :].to(u.dtype)) @ uh
    return root, inv_root


def eigh_plain(h: torch.Tensor):
    """Plain version of K2: the library eigh of (h + h†)/2, ascending.

    On CUDA a 32-bit batch is solved in 64 bits and cast back: cuSOLVER's
    complex64 eigh reports non-convergence on the main path's rank-deficient
    Gram batches, where the complex128 solve succeeds.  Measured on an H100
    (torch 2.11 + CUDA 12.8) on the batches the layers produce: 13 of 20
    chi10 gram-split batches at n=40 and 5 of 6 chi64 batches at n=256
    fail in complex64.  The complex64 MAGMA solve converges but takes
    10-20x the complex128 cuSOLVER time at n=256, so 64-bit cuSOLVER is
    the library eigh at every n."""
    h = hermitize(h)
    if h.is_cuda and h.dtype in (torch.complex64, torch.float32):
        wide = torch.complex128 if h.is_complex() else torch.float64
        w, v = torch.linalg.eigh(h.to(wide))
        return w.to(torch.float32), v.to(h.dtype)
    return torch.linalg.eigh(h)


def library_qr(a: torch.Tensor):
    """``torch.linalg.qr`` of a batch, one matrix per call.

    On CUDA torch takes cuBLAS's batched geqrf for a batch of small
    matrices, which returns NaN for complex matrices whose columns are
    exactly equal; one matrix per call takes cuSOLVER's geqrf, which does
    not.  The microbenchmark's chains converge to such a matrix (on an H100
    with torch 2.11 + CUDA 12.8 the batched QR turned the [8,128,128] chain
    to NaN at step 340 and the [16,40,40] one at step 1171), and the
    certified sampler's padded strands start from one."""
    q, r = zip(*(torch.linalg.qr(m) for m in a))
    return torch.stack(q), torch.stack(r)


def pseudo_roots_plain(h: torch.Tensor):
    """Plain version of K1: library eigh → clip → reconstructions."""
    return clip_roots(*eigh_plain(h))


def _check_cuda_batch(h: torch.Tensor, name: str) -> None:
    if h.dtype != torch.complex64:
        raise TypeError(f"{name}: CUDA kernel takes complex64, got {h.dtype}")
    if h.ndim != 3 or h.shape[1] != h.shape[2]:
        raise ValueError(f"{name}: expected [B, n, n], got {tuple(h.shape)}")


def _sweeps_ptr(sweeps, batch: int, device, counter) -> int:
    """Device pointer of the per-matrix sweep counts: the caller's
    ``sweeps``, else while tracing ``batch`` slots that ``counter`` adds up,
    else 0 (none)."""
    if sweeps is None:
        return counter.device_slots(batch, device)
    if (sweeps.dtype != torch.int32 or sweeps.shape != (batch,)
            or sweeps.device != device or not sweeps.is_contiguous()):
        raise ValueError(f"sweeps: expected a contiguous int32 [{batch}] on "
                         f"{device}")
    return sweeps.data_ptr()


def jacobi_pseudo_roots(h: torch.Tensor, max_sweeps: int = MAX_SWEEPS,
                        sweeps: torch.Tensor | None = None):
    """(√M, 1/√M) of a hermitian PSD batch ``h`` [B, n, n] as ONE kernel
    (K1).  Callers gate on :func:`roots_kernel_supported`.  ``sweeps``, an
    int32 [B] CUDA tensor, receives the Jacobi sweeps each matrix ran."""
    B, n, _ = h.shape
    if not roots_kernel_supported(n, B):
        raise ValueError(f"jacobi_pseudo_roots: unsupported shape {tuple(h.shape)}")
    if not h.is_cuda:
        return pseudo_roots_plain(h)
    _check_cuda_batch(h, "jacobi_pseudo_roots")
    h = h.contiguous()
    root = torch.empty_like(h)
    inv_root = torch.empty_like(h)
    cuda_build.launch(
        "tnqs_jacobi_pseudo_roots", h.device, h.data_ptr(), root.data_ptr(),
        inv_root.data_ptr(), _sweeps_ptr(sweeps, B, h.device, roots_sweeps),
        B, n, max_sweeps, ROOTS_NOISE_FLOOR,
    )
    roots_launches.count += 1
    roots_matrices.add(B)
    if sweeps is not None:
        roots_sweeps.add_device(sweeps)
    return root, inv_root


def _launch_eigh(h: torch.Tensor, max_sweeps: int, polish: bool, sweeps):
    B, n, _ = h.shape
    _check_cuda_batch(h, "jacobi_eigh")
    if not h.is_cuda or not eigh_kernel_supported(n, B):
        raise ValueError(f"jacobi_eigh: the kernel needs a CUDA batch that "
                         f"eigh_kernel_supported admits, got {tuple(h.shape)} "
                         f"on {h.device}")
    h = h.contiguous()
    w = torch.empty((B, n), dtype=torch.float32, device=h.device)
    v = torch.empty_like(h)
    cuda_build.launch(
        "tnqs_jacobi_eigh", h.device, h.data_ptr(), w.data_ptr(),
        v.data_ptr(), _sweeps_ptr(sweeps, B, h.device, eigh_sweeps), B, n,
        max_sweeps, EIGH_NOISE_FLOOR, int(polish),
    )
    eigh_launches.count += 1
    eigh_matrices.add(B)
    if sweeps is not None:
        eigh_sweeps.add_device(sweeps)
    return w, v


def jacobi_eigh_raw(h: torch.Tensor, max_sweeps: int = MAX_SWEEPS,
                    sweeps: torch.Tensor | None = None):
    """The K2 kernel without its polish: eigenvalues in no particular order
    (float32 [B, n], the diagonal of the rotated matrix) and the
    accumulated rotations (complex64 [B, n, n], column j the eigenvector of
    eigenvalue j)."""
    return _launch_eigh(h, max_sweeps, False, sweeps)


def jacobi_eigh(h: torch.Tensor, max_sweeps: int = MAX_SWEEPS,
                sweeps: torch.Tensor | None = None):
    """Batched hermitian eigendecomposition ``h`` [B, n, n] → (w [B, n]
    ascending, v [B, n, n] unitary), drop-in for ``torch.linalg.eigh``.

    On CUDA the Jacobi rotations run in the K2 kernel, followed by one
    Newton–Schulz step (V ← V(1.5I − 0.5V†V)), a Rayleigh quotient against
    the original matrix and the ascending sort (the reference wrapper's
    two-pass polish, pallas_linalg.py:289-311): inside the same launch for
    n ≤ :data:`ONE_CTA_MAX_N`, here in PyTorch for the cluster sizes."""
    B, n = h.shape[0], h.shape[-1]
    if not h.is_cuda or not eigh_kernel_supported(n, B):
        return eigh_plain(h)
    if n <= ONE_CTA_MAX_N:
        return _launch_eigh(h, max_sweeps, True, sweeps)
    w, v = _launch_eigh(h, max_sweeps, False, sweeps)
    eye = torch.eye(n, dtype=v.dtype, device=v.device)
    v = v @ (1.5 * eye - 0.5 * (v.mH @ v))
    w = torch.einsum("bji,bji->bi", v.conj(), h @ v).real
    w, order = torch.sort(w, dim=-1)
    v = torch.take_along_dim(v, order[:, None, :], dim=-1)
    return w, v
