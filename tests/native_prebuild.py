"""Build the JAX package's two native libraries once, whole, before use.

``tensornetworkquantumsimulator_tpu.native`` builds ``libpathopt.so`` and
``libsubgraphs.so`` with g++ on first use, straight onto their final paths
and under a thread lock only.  Under pytest-xdist several worker processes
can find a library missing at once: one worker's linker is still writing
the file when another worker loads it, the load fails, and that worker
takes the pure-Python fallback for the rest of its process.

:func:`prebuild` removes the race: under an ``fcntl.flock`` on a lock file
in ``build/`` it builds each library that is missing, older than its
``.cpp`` or fails to load (a JAX loader in another worker may still be
writing it), with the JAX loader's own command, to a temporary name in the
package's ``native/`` directory, and renames the result onto the final name
(``os.replace`` is atomic).  A library that is present, fresh and loads is
left alone, so after one call the JAX loader never rebuilds.  It writes only the
git-ignored ``.so`` artefacts that the JAX loader itself writes there.

Where no ``g++`` is found it does nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]
NATIVE = _REPO / "tensornetworkquantumsimulator_tpu" / "native"
STEMS = ("pathopt", "subgraphs")
_LOCK = _REPO / "build" / "native_prebuild.lock"


def have_compiler() -> bool:
    return shutil.which("g++") is not None


def _stale(stem: str) -> bool:
    src, lib = NATIVE / f"{stem}.cpp", NATIVE / f"lib{stem}.so"
    return not lib.exists() or src.stat().st_mtime > lib.stat().st_mtime


def _loads(stem: str) -> bool:
    try:
        ctypes.CDLL(str(NATIVE / f"lib{stem}.so"))
    except OSError:
        return False
    return True


def prebuild() -> list:
    """Build every library that is missing, stale or does not load; return
    the stems built."""
    if not have_compiler():
        return []
    built = []
    _LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for stem in STEMS:
            if not _stale(stem) and _loads(stem):
                continue
            # a name the repo's "*.so" ignore rule covers, unique per process
            tmp = NATIVE / f".lib{stem}.{os.getpid()}.so"
            try:
                subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o",
                                str(tmp), str(NATIVE / f"{stem}.cpp")],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, NATIVE / f"lib{stem}.so")
            finally:
                tmp.unlink(missing_ok=True)
            built.append(stem)
    return built
