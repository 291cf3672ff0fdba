"""Outgoing BP messages of degree-3 states as one CUDA kernel chain (K3).

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
pallas_bp``.  ``TNQS_BP_KERNEL=1`` routes ``engine._outgoing_messages``
here for degree-3 complex64 states with equal bond legs (the Eagle χ=64
configuration).  The kernels live in ``csrc/bp_outgoing_d3.cu``: five
shared partial absorbs and three message contractions, all in the file's
own tiled kernels, staged through two device scratch buffers that this
wrapper allocates.

:func:`bp_outgoing_plain` is the plain version: the reference's
``_all_except_one`` + einsum chain (engine.py:333-344).  The wrapper takes
it only for a CPU tensor; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_build import LaunchCounter

bp_launches = LaunchCounter("bp_outgoing_d3")

_TARGET_BLOCKS = 528  # ~4 blocks per SM of an H100 for the contractions
_MIN_CHUNK = 256  # smallest K chunk of a split-K contraction


def bp_kernel_supported(degree: int, chi: int, d: int, dtype,
                        num_vertices: int = 1) -> bool:
    """Gate of K3, from what the CUDA kernels accept: degree 3, complex64,
    32-bit column indexing of one vertex's tensor, and at most 65535
    vertices (the kernels put V on gridDim.z).  Any χ and d pass; the
    caller also requires the three bond legs to be equal."""
    return (
        degree == 3
        and dtype == torch.complex64
        and chi >= 1
        and d >= 1
        and 1 <= num_vertices <= 65535
        and num_vertices * chi**3 * d < 2**31
    )


def _splitk(V: int, chi: int, d: int) -> int:
    """K chunks per message contraction: enough blocks to fill the card,
    no chunk shorter than _MIN_CHUNK."""
    tiles = -(-chi // 32)
    blocks = V * tiles * tiles
    k = chi * chi * d
    want = -(-_TARGET_BLOCKS // blocks)
    return max(1, min(want, k // _MIN_CHUNK))


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
    messages = messages.contiguous()
    splitk = _splitk(V, chi, d)
    out = torch.empty((V, 3, chi, chi), dtype=t.dtype, device=t.device)
    s0 = torch.empty_like(t)
    s1 = torch.empty_like(t)
    partial = torch.empty((splitk, V, chi, chi), dtype=t.dtype,
                          device=t.device)
    cuda_build.launch(
        "tnqs_bp_outgoing_d3", t.data_ptr(), messages.data_ptr(),
        out.data_ptr(), s0.data_ptr(), s1.data_ptr(), partial.data_ptr(),
        V, chi, d, splitk,
    )
    bp_launches.count += 1
    return out
