"""Peaks of one NVIDIA H100 SXM and the least time of a piece of work.

The published dense peaks (NVIDIA's data sheet, at the 700 W power limit):
TF32 on the tensor cores 495 TFLOP/s, HBM3 3.35 TB/s.  Both roofline
shares use the TF32 peak, the fastest unit that can hold these float32
contractions and decompositions, so no implementation that passes the
check can read above 100%.  Operations and bytes are counted from the
shapes a call was handed, never from what an implementation did: each
input byte read once, each output byte written once.
"""

from __future__ import annotations

PEAK_TF32 = 495e12  # FLOP/s
PEAK_BYTES = 3.35e12  # B/s

# real flops per n×n Hermitian matrix: the eigendecomposition with vectors
# (Hermitian QR algorithm, 9 n³ complex = 36 n³ real) and the roots stage,
# which adds the two reconstructions U f(w) U† (2 × 8 n³ real)
EIGH_FLOPS = 36
ROOTS_FLOPS = 52


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_TF32, nbytes / PEAK_BYTES)


def eigh_work(n: int, batch: int, itemsize: int):
    """A batched eigh: A in, eigenvalues (real) and vectors out."""
    flops = EIGH_FLOPS * batch * n**3
    nbytes = batch * (2 * n * n * itemsize + n * itemsize // 2)
    return flops, nbytes


def roots_work(n: int, batch: int, itemsize: int):
    """The roots stage: A in, √A and 1/√A out."""
    return ROOTS_FLOPS * batch * n**3, 3 * batch * n * n * itemsize


def _absorbs(d: int) -> int:
    """Absorbs of the all-but-one split over d legs: T(d) = d + T(⌊d/2⌋)
    + T(⌈d/2⌉), T(1) = 0."""
    if d <= 1:
        return 0
    return d + _absorbs(d // 2) + _absorbs(d - d // 2)


def message_work(shape, itemsize: int):
    """All outgoing BP messages of tensors ``shape`` = [V, χ, …, χ, d] with
    D bond legs: T(D) absorbs of one message into a leg and D contractions
    with the conjugate tensor, each V·χ^(D+1)·d complex multiply-adds at 8
    real flops; the tensors and the D incoming messages read, the D
    outgoing written."""
    V, chi, d = shape[0], shape[1], shape[-1]
    D = len(shape) - 2
    macs = (_absorbs(D) + D) * V * chi ** (D + 1) * d
    nbytes = (V * chi**D * d + 2 * V * D * chi * chi) * itemsize
    return 8 * macs, nbytes
