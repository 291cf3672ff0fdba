"""Factorization microbenchmark on the GPU.

The counterpart of ``scripts/microbench.py``.  Each sample chains M
dependent repetitions of one op on a complex64 batch [B, N, N] (each
output renormalized and fed to the next step, so no repetition can be
skipped or overlapped), after one warm-up step that also builds the
kernels, and times the chain with CUDA events.  Two M points give a slope
that is free of the fixed cost of a call::

    python -m tensornetworkquantumsimulator_torch.microbench OP B N M [seed]
    python -m tensornetworkquantumsimulator_torch.microbench --sweep

OP is one of the reference's names:

- ``svd``, ``qr``: ``torch.linalg.svd`` / ``torch.linalg.qr`` (one matrix
  per call, see :func:`library_qr`);
- ``gram``: the engine's Gram split (``engine._gram_split``, which follows
  ``TNQS_EIGH_ALG`` like the layers do);
- ``eigh``: the port's library eigh (``cuda_linalg.eigh_plain``; 32-bit
  batches are solved in 64 bits on CUDA) of A + A†;
- ``jeigh``: the Jacobi eigh K2 (``cuda_linalg.jacobi_eigh``) of A + A†;
  N outside its even 4 ≤ N ≤ 88 gate goes to the library eigh, as in the
  reference;
- ``matmul``, ``cmatmul``: ``a @ a`` (cuBLAS's complex GEMM);
- ``cpallas``: ``a @ a`` by the Gauss-trick kernel K4
  (``cuda_matmul.complex_matmul``).

A sample prints one JSON line with the reference's keys; ``backend`` is
the card's name.  The script needs a CUDA device and refuses to start
without one: it never times the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .parallel.cuda_linalg import library_qr

OPS = ("svd", "gram", "eigh", "qr", "matmul", "cmatmul", "cpallas", "jeigh")
SWEEP_SHAPES = ((16, 40), (8, 128))
SWEEP_M_POINTS = (400, 4000)


def _reconstruct(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """V diag(w) V† from an eigendecomposition."""
    return (v * w[..., None, :].to(v.dtype)) @ v.mH


def step(op: str, a: torch.Tensor) -> torch.Tensor:
    """One repetition of ``op`` on ``a``, renormalized (the reference's
    step, scripts/microbench.py:45-85)."""
    from .parallel import cuda_linalg, cuda_matmul, engine

    b = a.shape[0]
    if op == "svd":
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        out = (u * s[..., None, :].to(a.dtype)) @ vh
    elif op == "gram":
        u, s, vh = engine._gram_split(a)
        out = (u * s[..., None, :].to(a.dtype)) @ vh
    elif op == "eigh":
        out = _reconstruct(*cuda_linalg.eigh_plain(a + a.mH))
    elif op == "qr":
        q, r = library_qr(a)
        out = q @ r
    elif op in ("matmul", "cmatmul"):
        out = a @ a
    elif op == "cpallas":
        out = cuda_matmul.complex_matmul(a, a)
    elif op == "jeigh":
        out = _reconstruct(*cuda_linalg.jacobi_eigh(a + a.mH))
    else:
        raise ValueError(f"unknown op {op!r} (one of {OPS})")
    # keep the chain data-dependent and bounded
    nrm = torch.linalg.vector_norm(out.reshape(b, -1), dim=-1)[:, None, None]
    return out / torch.where(nrm == 0, torch.ones_like(nrm), nrm) + 1e-3


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("microbench needs a CUDA device; it does not time "
                           "the CPU")
    from . import select_device

    return select_device("cuda")


def run(op: str, b: int, n: int, m: int, seed: int = 0) -> dict:
    """One sample: M chained repetitions of ``op`` on [b, n, n]."""
    dev = _device()
    rng = np.random.default_rng(7)
    a0 = (rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
          ).astype(np.complex64) * (1.0 + 1e-6 * seed)
    a = step(op, torch.from_numpy(a0).to(dev))  # warm-up (and kernel build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(m):
        a = step(op, a)
    end.record()
    t_disp = time.perf_counter() - t0
    t1 = time.perf_counter()
    end.synchronize()
    t_sync = time.perf_counter() - t1
    wall = start.elapsed_time(end) / 1e3
    z = float(a[0, 0, 0].abs())
    return {
        "backend": torch.cuda.get_device_name(dev),
        "op": op, "B": b, "N": n, "M": m,
        "wall_seconds": wall,
        "dispatch_seconds": t_disp,
        "sync_seconds": t_sync,
        "per_op_us_upper": 1e6 * wall / m,
        "z": z,
        "valid": bool(np.isfinite(z)),
    }


def sweep(shapes=SWEEP_SHAPES, ops=OPS, m_points=SWEEP_M_POINTS,
          out=None) -> list:
    """Every (shape, op) at two M points in this process; prints (to
    ``out``, standard output by default) and returns one slope record per
    pair (µs per op from the two walls)."""
    out = sys.stdout if out is None else out
    records = []
    m_lo, m_hi = sorted(m_points)
    for (b, n) in shapes:
        for op in ops:
            samples = {m: run(op, b, n, m, seed=i + 1)
                       for i, m in enumerate((m_lo, m_hi))}
            walls = {m: s["wall_seconds"] for m, s in samples.items()}
            rec = {
                "op": op, "B": b, "N": n,
                "per_op_us_slope": 1e6 * (walls[m_hi] - walls[m_lo])
                / (m_hi - m_lo),
                "walls": walls,
                "z": [samples[m]["z"] for m in (m_lo, m_hi)],
                "valid": all(s["valid"] for s in samples.values()),
            }
            print(json.dumps(rec), file=out, flush=True)
            records.append(rec)
    return records


def main(argv: list) -> int:
    try:
        if "--sweep" in argv:
            return 0 if all(r["valid"] for r in sweep()) else 1
        if len(argv) < 4:
            print(__doc__, file=sys.stderr)
            return 2
        rec = run(argv[0], int(argv[1]), int(argv[2]), int(argv[3]),
                  int(argv[4]) if len(argv) > 4 else 0)
    except RuntimeError as e:
        print(f"microbench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0 if rec["valid"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
