"""Where the port's entry points put their tensors and modules.

``device=None`` in an entry point (``batched_product_state``,
``state_from_numpy``, ``make_layer_fn``, ``make_field_layer_fn``,
``make_noisy_field_layer_fn``, ``identity_messages``) means the package's
default device: CUDA, unless :func:`set_default_device` or
:func:`select_device` chose another.  With no CUDA device visible, asking
for CUDA raises: the port never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

_default: torch.device | None = None  # None: CUDA


def set_default_device(device) -> torch.device | None:
    """Make ``device`` the default of every entry point (``None``: back to
    CUDA).  Returns the previous setting, so a caller can restore it."""
    global _default
    prev = _default
    _default = None if device is None else torch.device(device)
    return prev


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    package's default.  Raises if that is CUDA and no CUDA device is
    visible."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = _default if _default is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port's entry points run on CUDA "
            "unless asked otherwise (pass device='cpu', or call "
            "set_default_device('cpu') or select_device('cpu'))")
    return dev


def select_device(name: str = "cuda") -> torch.device:
    """Make ``name`` the default device of the entry points and return it,
    with float32 matmuls at full precision: no TF32 in cuBLAS (complex GEMM
    included) or cuDNN, as the reference runs every einsum at
    ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = resolve_device(name)
    set_default_device(dev)
    return dev
