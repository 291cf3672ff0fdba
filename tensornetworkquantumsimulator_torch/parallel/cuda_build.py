"""Build and load the hand-written Hopper kernels in ``csrc/``.

The CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a``,
one ``nvcc`` process per source, all started together, and linked into
one shared library with a plain ``extern "C"`` interface, which is loaded
with :mod:`ctypes`.  The library lands in ``build/tnqs_kernels/``
at the root of the checkout, in a directory named after a hash of the
sources and flags, so an edit to any source rebuilds it and an unchanged
tree reuses it.

Nothing here runs at import time: the CPU tests import every module, and
a CPU-only install has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "tnqs_kernels"
SOURCES = ("jacobi.cu", "bp_outgoing_d3.cu", "complex_matmul.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every function returns cudaError_t as int)
_SIGNATURES = {
    # (a, w, v, sweeps, batch, n, max_sweeps, noise_floor, polish, stream)
    "tnqs_jacobi_eigh": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # (a, root, inv_root, sweeps, batch, n, max_sweeps, noise_floor, stream)
    "tnqs_jacobi_pseudo_roots": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # (t, messages, out, scratch, partial, V, chi, d, chunk, splits, stream)
    "tnqs_bp_outgoing_d3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (a, b, c, batch, n, k, m, stream)
    "tnqs_complex_matmul": (_P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of the build this process ran
build_log: str = ""  # nvcc's stderr (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built with the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every ``(name, Popen)``; raise with the output of the first
    that failed, else return their stderr (ptxas reports) joined."""
    logs, failed = [], None
    for name, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc {name} failed ({proc.returncode}):\n{out}\n{err}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _build(out_dir: Path, so: Path) -> None:
    """Compile every source to an object in parallel, then link.  The
    library is linked under a temporary name and renamed: a concurrent or
    interrupted build never leaves a half-written library behind."""
    global build_log
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp_dir / (Path(s).stem + ".o") for s in SOURCES]
        build_log = _run([
            (s, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for s, o in zip(SOURCES, objs)
        ])
        tmp_so = tmp_dir / so.name
        _run([("link", subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _source_hash()
        so = out_dir / "libtnqs_kernels.so"
        if not so.is_file():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _build(out_dir, so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.tnqs_error_string.argtypes = [ctypes.c_int]
        lib.tnqs_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


_entries: dict = {}  # name -> bound C function, looked up once


def launch(name: str, device, *args) -> None:
    """Call one C entry point on ``device`` (the device of the data it is
    handed), on PyTorch's current stream there; raise on a non-zero
    ``cudaGetLastError`` (a refused launch never runs, and a later
    synchronize would not report it).  The launch goes to the data's
    card even when another card is current, as for a shard on a second
    card.  After the first call the bound function is a dictionary
    lookup, with no lock: at small shapes the host path is the cost of a
    call."""
    import torch

    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = library().tnqs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
