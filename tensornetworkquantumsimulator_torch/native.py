"""The package's C++ host libraries, loaded with :mod:`ctypes`.

A jax-free counterpart of the JAX package's ``native`` loader, for its two
libraries:

- ``libpathopt`` (``csrc/pathopt.cpp``): the exact contraction-order DP
  behind :func:`~.ops.paths.contraction_sequence` (the counterpart of the
  reference's TensorOperations.optimaltree);
- ``libsubgraphs`` (``csrc/subgraphs.cpp``): the leaf-free subgraph
  enumeration behind the loop-correction series (NamedGraphs'
  ``edgeinduced_subgraphs_no_leaves``, `loopcorrection.jl:11-12`).

They are host code, not kernels.  Each is built with ``g++`` at first use
into ``build/native/<hash>/`` at the root of the checkout, beside the CUDA
build, in a directory named after a hash of its source and flags, and never
into the package directory.  Where no ``g++`` is found, or a build fails,
the loader returns None and the caller runs its pure-Python path, which is
also the parity oracle.

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
BUILD_ROOT = _PKG.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
_failed: set = set()


def source(stem: str) -> Path:
    return _PKG / "csrc" / f"{stem}.cpp"


def library_path(stem: str = "subgraphs") -> Path:
    """Where the library of the current source of ``stem`` lives (built or
    not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source(stem).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{stem}.so"


def _build(stem: str, so: Path) -> None:
    """Compile under a temporary name and rename: a concurrent or
    interrupted build never leaves a half-written library behind."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(source(stem))],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _library(stem: str, configure) -> "ctypes.CDLL | None":
    """The loaded ``lib{stem}.so``, built on first call if needed and set up
    by ``configure``; None when it cannot be built or loaded."""
    with _lock:
        if stem in _libs or stem in _failed:
            return _libs.get(stem)
        so = library_path(stem)
        try:
            if not so.is_file():
                _build(stem, so)
            lib = ctypes.CDLL(str(so))
            configure(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError,
                AttributeError):
            _failed.add(stem)
            return None
        _libs[stem] = lib
        return lib


def _configure_pathopt(lib) -> None:
    fn = lib.optimal_path2
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int),
    ]


def _configure_subgraphs(lib) -> None:
    fn = lib.enumerate_leaffree2
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


def get_pathopt() -> "ctypes.CDLL | None":
    """The loaded contraction-order DP, or None."""
    return _library("pathopt", _configure_pathopt)


def get_subgraphs() -> "ctypes.CDLL | None":
    """The loaded subgraph enumerator, or None."""
    return _library("subgraphs", _configure_subgraphs)


def optimal_path_native(inputs: list, dims: dict):
    """SSA pairwise path for a tensor list, or None.

    ``inputs`` is a list of index-key tuples per tensor; ``dims`` maps index
    key -> dimension.  None when the library is unavailable, the list is
    outside its reach (2 ≤ n ≤ 64 tensors, ≤ 128 distinct indices), or its
    enumeration budget overflowed.
    """
    n = len(inputs)
    if n < 2 or n > 64:
        return None
    keys = []
    key_pos = {}
    for sub in inputs:
        for k in sub:
            if k not in key_pos:
                key_pos[k] = len(keys)
                keys.append(k)
    if len(keys) > 128:
        return None
    lib = get_pathopt()
    if lib is None:
        return None
    ind_dims = (ctypes.c_double * len(keys))(*[float(dims[k]) for k in keys])
    words = []
    for sub in inputs:
        m = 0
        for k in sub:
            m |= 1 << key_pos[k]
        words.append(m & 0xFFFFFFFFFFFFFFFF)
        words.append(m >> 64)
    tensor_inds = (ctypes.c_uint64 * (2 * n))(*words)
    out = (ctypes.c_int * (2 * (n - 1)))()
    rc = lib.optimal_path2(n, len(keys), ind_dims, tensor_inds, out)
    if rc != 0:
        return None
    return [(out[2 * i], out[2 * i + 1]) for i in range(n - 1)]


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
