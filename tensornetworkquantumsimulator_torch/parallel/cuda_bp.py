"""Outgoing BP messages of degree-3 states as one CUDA kernel chain (K3).

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
pallas_bp``.  ``TNQS_BP_KERNEL=1`` routes ``engine._outgoing_messages``
here for degree-3 complex64 states with equal bond legs (the Eagle χ=64
configuration).  The kernels live in ``csrc/bp_outgoing_d3.cu``: per chunk
of vertices two leg absorbs into one scratch buffer and three contractions
that each fuse the slot's second absorb, all on the tensor cores through
the 3xTF32 complex tile product (``csrc/complex_tf32x3.cuh``, in its
four-product form).  This wrapper picks the chunk (which bounds the
scratch) and the split of each contraction over its outer leg, and
allocates the scratch and the partial sums.

:func:`bp_outgoing_plain` is the plain version: the reference's
``_all_except_one`` + einsum chain (engine.py:333-344).  The wrapper takes
it only for a CPU tensor; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..utils.profiling import Counter
from . import cuda_build

bp_launches = Counter("launches.bp_outgoing_d3")

_TARGET_BLOCKS = 264  # two contraction CTAs per SM of an H100
_SCRATCH_BUDGET = 64 << 20  # bytes of the per-chunk scratch (Y, then P)


def bp_kernel_supported(degree: int, chi: int, d: int, dtype,
                        num_vertices: int = 1) -> bool:
    """Gate of K3, from what the CUDA kernels accept: degree 3, complex64,
    1 ≤ d ≤ 4 (the contraction kernel is built for each d), 32-bit
    indexing of one vertex's tensor, and at most 65535 vertices (a chunk
    of vertices rides on gridDim.z).  Any χ passes; the caller also
    requires the three bond legs to be equal."""
    return (
        degree == 3
        and dtype == torch.complex64
        and chi >= 1
        and 1 <= d <= 4
        and 1 <= num_vertices <= 65535
        and num_vertices * chi**3 * d < 2**31
    )


def launch_plan(V: int, chi: int, d: int) -> tuple[int, int]:
    """(vertices per chunk, splits of each contraction over its outer leg):
    a chunk holds as many vertices as fit _SCRATCH_BUDGET (16 at χ=64,
    d=2), and the splits give about _TARGET_BLOCKS CTAs per contraction;
    no split is left empty."""
    chunk = max(1, min(V, _SCRATCH_BUDGET // (chi**3 * d * 8)))
    tiles = -(-chi // 32) * -(-chi // 64)
    splits = min(chi, -(-_TARGET_BLOCKS // (chunk * tiles)))
    rlen = -(-chi // splits)
    return chunk, -(-chi // rlen)


def bp_outgoing_plain(t: torch.Tensor, messages: torch.Tensor) -> torch.Tensor:
    """m_out [V, 3, χ, χ] by the engine's einsum chain (un-normalized)."""
    from .engine import outgoing_messages_einsum

    return outgoing_messages_einsum(t, messages)


def bp_outgoing_d3(t: torch.Tensor, messages: torch.Tensor) -> torch.Tensor:
    """All outgoing messages of a degree-3 batched state.  ``t``
    [V, χ, χ, χ, d] complex64, ``messages`` [V, 3, χ, χ] → m_out
    [V, 3, χ, χ] (un-normalized; the caller hermitizes and masks)."""
    if t.ndim != 5 or len(set(t.shape[1:4])) != 1:
        raise ValueError(f"bp_outgoing_d3: expected [V, χ, χ, χ, d], got "
                         f"{tuple(t.shape)}")
    V, chi, d = t.shape[0], t.shape[1], t.shape[-1]
    if tuple(messages.shape) != (V, 3, chi, chi):
        raise ValueError(f"bp_outgoing_d3: messages {tuple(messages.shape)} "
                         f"do not match t {tuple(t.shape)}")
    if not t.is_cuda:
        return bp_outgoing_plain(t, messages)
    if not (messages.is_cuda and messages.device == t.device):
        raise ValueError("bp_outgoing_d3: t and messages must share a device")
    if t.dtype != torch.complex64 or messages.dtype != torch.complex64:
        raise TypeError("bp_outgoing_d3: CUDA kernel takes complex64")
    if not bp_kernel_supported(3, chi, d, t.dtype, V):
        raise ValueError(f"bp_outgoing_d3: unsupported shape {tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:  # the kernels copy 16-byte (s, s + 1) pairs
        t = t.clone()
    messages = messages.contiguous()
    chunk, splits = launch_plan(V, chi, d)
    out = torch.empty((V, 3, chi, chi), dtype=t.dtype, device=t.device)
    scratch = torch.empty((chunk,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
    partial = torch.empty((splits, chunk, chi, chi), dtype=t.dtype,
                          device=t.device)
    cuda_build.launch(
        "tnqs_bp_outgoing_d3", t.device, t.data_ptr(), messages.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), partial.data_ptr(),
        V, chi, d, chunk, splits,
    )
    bp_launches.count += 1
    return out
