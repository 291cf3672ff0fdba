#!/usr/bin/env python3
"""K3 and K4 alone on the GPU, for an A/B of two versions of the port.

    python3 kernel_ab.py [DIR]

imports ``tensornetworkquantumsimulator_torch`` from DIR (default: this
checkout; another version is unpacked inside this checkout first, e.g.
``git archive HEAD~1 | tar -x -C build/parent``) and prints one JSON line
per kernel and shape: K3 ``bp_outgoing_d3`` at the chi64 main path's shape
[127,64,64,64,2] with its peak memory above its inputs and its device time
by kernel (``torch.profiler``), and K4 ``complex_matmul`` at the shapes
``chip_smoke.py`` times, beside cuBLAS's ``a @ b``.  Call time is CUDA
events around back-to-back calls, device time a CUDA graph of the calls,
as in ``chip_smoke.py``.  To compare two versions on one card, run them in
turns (A, B, B, A), one process each.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (K4_TIMED, REPO, device_ms, random_vertex_state,
                        time_ms)


def kernel_breakdown(fn) -> dict:
    """Device milliseconds per launch of each kernel in one call of ``fn``
    (torch.profiler; it may miss launches, so the mean per launch is the
    datum), with the launches it recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            name = (e.key.replace("(anonymous namespace)::", "").split("(")[0]
                    .removeprefix("void "))
            ms = getattr(e, "device_time_total", 0.0) / 1e3
            out[name] = {"ms_per_launch": ms / e.count, "recorded": e.count}
    return out


def main(repo: Path) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    if not repo.is_relative_to(REPO):
        print(f"kernel_ab: {repo} is not inside {REPO}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from tensornetworkquantumsimulator_torch.parallel import cuda_bp as cb
    from tensornetworkquantumsimulator_torch.parallel import cuda_build
    from tensornetworkquantumsimulator_torch.parallel import cuda_matmul as cm

    cuda_build.library()
    rng = np.random.default_rng(2024)
    card = torch.cuda.get_device_name(0)

    def line(kernel, shape, fn, reference, reps, **extra):
        out, ref = fn(), reference()
        dev_ms, how = device_ms(fn, reps)
        print(json.dumps({
            "repo": str(repo), "kernel": kernel, "shape": shape,
            "ms": time_ms(fn, reps), "device_ms": dev_ms, "device_how": how,
            "rel_err_vs_reference": float((out - ref).abs().max()
                                          / ref.abs().max()),
            "card": card, **extra}), flush=True)

    t, m = (torch.from_numpy(x).cuda()
            for x in random_vertex_state(rng, 127, 64, 2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cb.bp_outgoing_d3(t, m)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    k3 = lambda: cb.bp_outgoing_d3(t, m)  # noqa: E731
    line("K3", "127x64x64x64x2", k3, lambda: cb.bp_outgoing_plain(t, m), 5,
         peak_extra_mib=peak)
    for label in K4_TIMED:
        sa, sb = (tuple(map(int, x.split("x"))) for x in label.split("@"))
        a, b = (torch.from_numpy((rng.standard_normal(x) + 1j
                                  * rng.standard_normal(x)).astype(
            np.complex64)).cuda() for x in (sa, sb))
        line("K4", label, lambda: cm.complex_matmul(a, b), lambda: a @ b, 100,
             cublas_ms=time_ms(lambda: a @ b, 100),
             cublas_device_ms=device_ms(lambda: a @ b, 100)[0])
    # last: torch.profiler stays attached and slows every launch after it
    print(json.dumps({"repo": str(repo), "kernel": "K3",
                      "shape": "127x64x64x64x2", "card": card,
                      "by_kernel": kernel_breakdown(k3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]).resolve() if len(sys.argv) > 1
                  else REPO))
