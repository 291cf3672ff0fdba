#!/usr/bin/env python3
"""K1-K4 alone on the GPU, for an A/B of two versions of the port.

    python3 kernel_ab.py [DIR]

imports ``tensornetworkquantumsimulator_torch`` from DIR (default: this
checkout; another version is unpacked inside this checkout first, e.g.
``git archive HEAD~1 | tar -x -C build/parent``) and prints one JSON line
per kernel and shape: K3 ``bp_outgoing_d3`` at the chi64 main path's shape
[127,64,64,64,2] with its peak memory above its inputs and its device time
by kernel (``torch.profiler``), K4 ``complex_matmul`` at the shapes
``chip_smoke.py`` times, beside cuBLAS's ``a @ b``, then K1
``jacobi_pseudo_roots`` at [72,10,10] and K2 ``jacobi_eigh`` on full-rank
and rank-deficient Gram batches at [12,40,40], [200,64,64] and the chi64
Gram split's [48,256,256] (which a version whose gate stops at n = 88
hands to the library eigh in complex128), and last the layers per second
of chi10, chi64 and chi10_rolled on the fast stack with that version's
kernels.  Call time is CUDA
events around back-to-back calls, device time a CUDA graph of the calls,
as in ``chip_smoke.py``.  To compare two versions on one card, run them in
turns (A, B, B, A), one process each.

    python3 kernel_ab.py --generic [DIR]

times the generic engine instead, which no kernel serves: 5 layers of
``chip_smoke.py``'s chi10 circuit through ``apply_circuit`` from the
product state, then 3 more each between CUDA events, and the host syncs
of one more (CUDA's sync debug mode); one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (FAST_STACK, GENERIC_APPLY, GENERIC_LAYERS, K4_TIMED,
                        REPO, count_syncs, device_ms, generic_tfim, gram,
                        layers_per_second, random_vertex_state, time_ms)

# (batch, n, rank) of the Gram batches K1 and K2 are timed on
K1_TIMED = ((72, 10, 10),)
K2_TIMED = ((12, 40, 40), (12, 40, 10), (200, 64, 64), (200, 64, 16),
            (48, 256, 64))


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


def generic_layers(tt, repo: Path) -> None:
    """One JSON line: ms of each of 3 generic chi10 layers (CUDA events)
    after GENERIC_LAYERS from the product state, and one layer's syncs."""
    dev = tt.select_device("cuda")
    _, layer, _, psi, z = generic_tfim(tt, dev, GENERIC_LAYERS)

    def one():
        return tt.apply_circuit(layer, psi, apply_kwargs=GENERIC_APPLY)

    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    _, syncs = count_syncs(one)
    print(json.dumps({"repo": str(repo), "generic_chi10_layer_ms": ms,
                      "host_syncs_per_layer": syncs,
                      "z_mean": float(z.mean()),
                      "card": torch.cuda.get_device_name(0)}), flush=True)


def main(repo: Path, generic: bool = False) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    if not repo.is_relative_to(REPO):
        print(f"kernel_ab: {repo} is not inside {REPO}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import tensornetworkquantumsimulator_torch as tt

    if generic:
        generic_layers(tt, repo)
        return 0
    from tensornetworkquantumsimulator_torch.parallel import cuda_bp as cb
    from tensornetworkquantumsimulator_torch.parallel import cuda_build
    from tensornetworkquantumsimulator_torch.parallel import cuda_linalg as cl
    from tensornetworkquantumsimulator_torch.parallel import cuda_matmul as cm

    cuda_build.library()
    rng = np.random.default_rng(2024)
    card = torch.cuda.get_device_name(0)

    def line(kernel, shape, fn, reference, reps, capturable=True, **extra):
        out, ref = fn(), reference()
        if capturable:
            dev_ms, how = device_ms(fn, reps)
        else:
            dev_ms, how = time_ms(fn, reps), "call time of a synchronizing call"
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
    rng = np.random.default_rng(2025)  # K3's and K4's batches stay as they were
    for kernel, shapes, fn, plain in (
            ("K1", K1_TIMED, cl.jacobi_pseudo_roots, cl.pseudo_roots_plain),
            ("K2", K2_TIMED, cl.jacobi_eigh, cl.eigh_plain)):
        for B, n, r in shapes:
            at = torch.from_numpy(gram(rng, B, n, r)).cuda()
            took_kernel = getattr(cl, "roots_kernel_supported" if kernel == "K1"
                                  else "eigh_kernel_supported")(n, B)
            # the first output: K1's root, K2's ascending eigenvalues.  The
            # library eigh synchronizes, so it cannot go into a CUDA graph:
            # its device time is then the call time of a run that waits
            line(kernel, f"{B}x{n}x{n} gram rank {r}", lambda: fn(at)[0],
                 lambda: plain(at)[0], 3 if n > 88 else 20,
                 capturable=took_kernel, took_kernel=took_kernel)
    dev = tt.select_device("cuda")
    rates = {name: layers_per_second(tt, dev, name, n, FAST_STACK)
             for name, n in (("chi10", 20), ("chi64", 2), ("chi10_rolled", 20))}
    print(json.dumps({"repo": str(repo), "layers_per_s": rates, "card": card,
                      "how": "fast stack, CUDA events after one warm-up "
                             "layer; 20, 2 and 20 layers"}), flush=True)
    # last: torch.profiler stays attached and slows every launch after it
    print(json.dumps({"repo": str(repo), "kernel": "K3",
                      "shape": "127x64x64x64x2", "card": card,
                      "by_kernel": kernel_breakdown(k3)}), flush=True)
    return 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--generic"]
    sys.exit(main(Path(args[0]).resolve() if args else REPO,
                  generic="--generic" in sys.argv[1:]))
