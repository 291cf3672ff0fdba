"""The leaf-free subgraph enumerator in C++ (``csrc/subgraphs.cpp``), loaded
with :mod:`ctypes`.

A jax-free counterpart of the JAX package's ``native`` loader for
``libsubgraphs``: the enumeration behind the loop-correction series
(NamedGraphs' ``edgeinduced_subgraphs_no_leaves``, `loopcorrection.jl:11-12`).
It is host code, not a kernel.  The library is built with ``g++`` at first
use into ``build/native/<hash>/`` at the root of the checkout, beside the
CUDA build, in a directory named after a hash of the source and flags, and
never into the package directory.  Where no ``g++`` is found, or the build
fails, :func:`leaffree_subsets_native` returns None and the caller runs the
pure-Python enumeration, which is also the parity oracle.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "subgraphs.cpp"
BUILD_ROOT = _PKG.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsubgraphs.so"


def _build(so: Path) -> None:
    """Compile under a temporary name and rename: a concurrent or
    interrupted build never leaves a half-written library behind."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_subgraphs() -> "ctypes.CDLL | None":
    """The loaded enumerator, built on first call if needed; None when it
    cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = library_path()
        try:
            if not so.is_file():
                _build(so)
            lib = ctypes.CDLL(str(so))
            fn = lib.enumerate_leaffree2
        except (OSError, RuntimeError, subprocess.SubprocessError,
                AttributeError):
            _failed = True
            return None
        fn.restype = ctypes.c_longlong
        fn.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_longlong,
            ctypes.c_int,
        ]
        _lib = lib
        return lib


def leaffree_subsets_native(edge_pairs, n_vertices, max_edges,
                            leaf_ok=None):
    """All vertex-disjoint unions of connected edge subsets with
    <= max_edges edges whose every degree-1 vertex is flagged in
    ``leaf_ok`` (strictly leaf-free when ``leaf_ok`` is None), as lists of
    edge indices into `edge_pairs` — or None when the native library is
    unavailable / the graph exceeds the 256-edge/256-vertex bitset
    capacity.

    `edge_pairs` is a list of (src_index, dst_index) vertex-index pairs;
    ``leaf_ok`` an optional boolean sequence per vertex index (the
    observable vertices of the loop-corrected-expectation numerator).
    """
    lib = get_subgraphs()
    n_edges = len(edge_pairs)
    if lib is None or n_edges == 0 or max_edges is None or max_edges <= 0:
        return None if lib is None else []
    if n_edges > 256 or n_vertices > 256:
        return None
    words = (n_edges + 63) // 64
    src = (ctypes.c_int * n_edges)(*[p[0] for p in edge_pairs])
    dst = (ctypes.c_int * n_edges)(*[p[1] for p in edge_pairs])
    if leaf_ok is None:
        mask = ctypes.POINTER(ctypes.c_ubyte)()
    else:
        mask = (ctypes.c_ubyte * n_vertices)(
            *[1 if leaf_ok[i] else 0 for i in range(n_vertices)]
        )
    cap = 1 << 16
    while True:
        out = (ctypes.c_uint64 * (cap * words))()
        total = lib.enumerate_leaffree2(
            n_vertices, n_edges, src, dst, max_edges, mask, out, cap, words
        )
        if total < 0:
            return None
        if total <= cap:
            break
        cap = int(total)
    results = []
    for i in range(total):
        idxs = []
        for w in range(words):
            bits = out[i * words + w]
            while bits:
                b = bits & (-bits)
                idxs.append(w * 64 + b.bit_length() - 1)
                bits ^= b
        results.append(idxs)
    return results
