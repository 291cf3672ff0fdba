"""The program's own spans and counters (``utils/profiling.py`` in the
package) over two short sub-windows, and a tool that runs them.

``host_pass`` turns the package's tracer on, with no profiler, over a few
steps: host time inside each span (inclusive and self) and the counters
(BP sweeps, member-sweeps computed and still active, the program's own
blocking host reads, the Jacobi kernels' sweeps per matrix).
``device_pass`` turns it on under ``torch.profiler`` (CPU and CUDA), where
each span is the profiler range ``tnqs.<name>``: every kernel, copy and
memset carries its device time to the profiler event that launched it
(the profiler's launch correlation), and that event lies inside the
innermost ``tnqs.*`` range the host was in, so each span gets the device
time of the work launched inside it (``busy_ms``, inclusive of the spans
under it).  Each idle gap of the device is filed under the innermost range
the host was in when the gap began (``idle_gaps``).  Both passes read the
program's spans, never a function patched by name.

The readers in ``metrics/`` read these passes from ``record.program``
(``{"host": ..., "device": ...}``) and find nothing where a record has
none.  As a tool, on the card::

    python3 -m portbench.program_trace --workload <cell> --seed <n> \\
        [--seconds 5]

builds the cell's program as ``run.py`` does, runs a window under the
benchmark's own spans, its device and sync passes, then these two passes,
and prints one JSON line: the per-layer metrics the cell lists and the
program's (``NEW``), their cross-checks, the program spans' host and
device times per step, the idle gaps by program span, and the stack of
each host synchronization.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings

PREFIX = "tnqs."
OUTSIDE = "outside the program's spans"
# the per-layer metrics that read the program's spans and counters
NEW = ("update_host_ms_per_step", "update_busy_ms_per_step",
       "bp_busy_ms_per_step", "bp_sync_wait_ms_per_step",
       "bp_active_member_share", "eigh_sweeps_per_matrix",
       "roots_sweeps_per_matrix")


def _sync():
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def span_times(spans) -> dict:
    """name → [count, inclusive ms, self ms] over the spans."""
    out: dict = {}
    for s in spans:
        row = out.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (s.end_ns - s.start_ns) / 1e6
        row[2] += s.self_ns / 1e6
    return out


def host_pass(run_steps) -> dict:
    """The tracer on, no profiler: ``{"steps", "spans": name → [count,
    inclusive ms, self ms], "counters"}``."""
    from tensornetworkquantumsimulator_torch.utils import profiling

    _sync()
    with profiling.tracing() as handle:
        steps = run_steps()
        _sync()
        data = handle.collect()
    return {"steps": steps, "spans": span_times(data["spans"]),
            "counters": data["counters"]}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _containing(ranges, points):
    """For each point t (sorted), the names of the ranges [start, end) that
    hold it, outermost first.  ``ranges`` nest (one host thread)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, i, out = [], 0, []
    for t in points:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append([r[2] for r in stack])
    return out


def attribute(events) -> dict:
    """Device time by program span from profiler events (``prof.events()``:
    ``name``, ``device_type``, ``time_range``, ``thread``, ``kernels``).

    ``busy_ms``: name → ms of the device work launched inside that span or
    a span under it; ``self_busy_ms``: by the innermost span alone;
    ``idle_gaps``: [[``tnqs.<name>``, s]] of the device's idle gaps filed
    under the innermost range holding the gap's start, top 10;
    ``device_ms``: the union of all device work; ``outside_ms``: the work
    launched outside every span."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
              for e in cpu if e.name.startswith(PREFIX)]
    threads = {e.thread for e in cpu if e.name.startswith(PREFIX)}
    # the device's copies of the ranges are annotations, not work
    launches = sorted(
        (e.time_range.start, sum(k.duration for k in e.kernels
                                 if not k.name.startswith(PREFIX)))
        for e in cpu if e.kernels and (not threads or e.thread in threads))
    busy: dict = {}
    self_busy: dict = {}
    outside = 0.0
    for (_, us), chain in zip(launches,
                              _containing(ranges, [t for t, _ in launches])):
        if not chain:
            outside += us
            continue
        for name in set(chain):
            busy[name] = busy.get(name, 0.0) + us / 1e3
        self_busy[chain[-1]] = self_busy.get(chain[-1], 0.0) + us / 1e3
    work = _union((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(PREFIX))
    gaps = [(end, nxt - end) for (_, end), (nxt, _) in zip(work, work[1:])]
    idle: dict = {}
    for (_, us), chain in zip(gaps,
                              _containing(ranges, [t for t, _ in gaps])):
        label = PREFIX + chain[-1] if chain else OUTSIDE
        idle[label] = idle.get(label, 0.0) + us / 1e6
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_ms": busy, "self_busy_ms": self_busy,
            "idle_gaps": [[k, v] for k, v in top],
            "device_ms": sum(e - s for s, e in work) / 1e3,
            "outside_ms": outside / 1e3}


def device_pass(run_steps) -> dict:
    """The tracer on under ``torch.profiler`` (CPU and CUDA): ``{"steps",
    **attribute(...)}``."""
    from torch.profiler import ProfilerActivity, profile

    from tensornetworkquantumsimulator_torch.utils import profiling

    _sync()
    with profiling.tracing():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps = run_steps()
            _sync()
    return {"steps": steps, **attribute(prof.events())}


# -- what the readers read ---------------------------------------------------


def _pass(record, which):
    program = getattr(record, "program", None)
    got = (program or {}).get(which)
    return got if got and got.get("steps") else None


def host_ms_per_step(record, name):
    """Host ms inside the spans ``name`` per wall step of the host pass."""
    p = _pass(record, "host")
    if p is None or name not in p["spans"]:
        return None
    return p["spans"][name][1] / p["steps"]


def busy_ms_per_step(record, name):
    """Device ms of the work launched inside the spans ``name`` per wall
    step of the device pass."""
    p = _pass(record, "device")
    if p is None or name not in p["busy_ms"]:
        return None
    return p["busy_ms"][name] / p["steps"]


def counter_ratio(record, num, den):
    """counters[num] / counters[den] over the host pass."""
    p = _pass(record, "host")
    if p is None or not p["counters"].get(den) or num not in p["counters"]:
        return None
    return p["counters"][num] / p["counters"][den]


# -- the tool ----------------------------------------------------------------


def sync_sites(run_steps) -> dict:
    """CUDA's sync debug mode over a few steps with the tracer on: the
    synchronizations, each filed under the innermost frame of the package
    (or else of the benchmark) on the stack that raised its warning, and
    the program's own host reads counted over the same steps."""
    import torch

    from tensornetworkquantumsimulator_torch.utils import profiling

    sites: dict = {}

    def seen(message, *_args, **_kw):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "tensornetworkquantumsimulator_torch" in f.filename
                  or "portbench" in f.filename]
        f = frames[-1] if frames else None
        key = (f"{os.path.relpath(f.filename)}:{f.lineno} {f.name}"
               if f else "elsewhere")
        sites[key] = sites.get(key, 0) + 1

    _sync()
    with warnings.catch_warnings(), profiling.tracing() as handle:
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            steps = run_steps()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        reads = {k: v for k, v in handle.collect()["counters"].items()
                 if k.startswith("host.reads.")}
    return {"steps": steps, "count": sum(sites.values()), "sites": sites,
            "host_reads": reads}


def measure(cell, seed: int, seconds: float) -> dict:
    import torch

    from . import run, systems
    from . import trace as tracing
    from .lattices import build
    from .spans import Spans
    from .traffic import Generator

    config, mix = cell["config"], cell["mix"]
    dev = torch.device("cuda")
    vertices, edges = build(config["lattice"])
    spans = Spans()
    with spans.installed():
        program = systems.load(config).Program(config, vertices, edges,
                                               int(mix["members"]), dev)
        gen = Generator(mix, config, len(vertices), len(edges), seed)
        warm = run.Client(program, gen)
        warm.run(0, min_steps=int(mix.get("warmup_steps", 2)))
        warm.drop()
        client = run.Client(program, gen, spans)
        spans.enabled = True
        steps = len(client.run(seconds))
        spans.enabled = False
        client.drop()
        record = run.Record(steps, spans.collect(), dict(spans.counts),
                            None, None)
        more = run.Client(program, gen)
        record.profile = tracing.device_pass(
            lambda: len(more.run(0.5, min_steps=2, max_steps=50)))
        record.syncs = sync_sites(
            lambda: len(more.run(0.3, min_steps=2, max_steps=20)))
        record.program = {
            "host": host_pass(
                lambda: len(more.run(0.5, min_steps=2, max_steps=50))),
            "device": device_pass(
                lambda: len(more.run(0.2, min_steps=2, max_steps=10)))}
        more.drop()
    names = list(cell["per_layer"]) + [n for n in NEW
                                       if n not in cell["per_layer"]]
    metrics = {n: run.metric_reader(n)(record) for n in names}
    host, device = record.program["host"], record.program["device"]
    c = host["counters"]
    per_step = record.profile["busy_s"] * 1e3 / record.profile["steps"]
    top = sum(busy_ms_per_step(record, n) or 0.0 for n in ("layer",
                                                         "readout"))
    return {
        "cell": cell["name"], "seed": seed,
        "device": run.card_facts(torch), "metrics": metrics,
        "checks": {
            "spans_busy_ms_per_step": top,
            "device_pass_busy_ms_per_step": per_step,
            "bp_sweeps_per_step_program": c.get("bp.sweeps", 0)
            / host["steps"],
            "bp_sweeps_per_step_benchmark": metrics.get("bp_sweeps_per_step"),
            "host_reads_per_step": {k: v / record.syncs["steps"] for k, v in
                                    record.syncs["host_reads"].items()},
            "device_ms_outside_spans_per_step": device["outside_ms"]
            / device["steps"]},
        "host_ms_per_step": {k: [v[0] / host["steps"], v[1] / host["steps"],
                                 v[2] / host["steps"]]
                             for k, v in host["spans"].items()},
        "busy_ms_per_step": {k: v / device["steps"]
                             for k, v in device["busy_ms"].items()},
        "self_busy_ms_per_step": {k: v / device["steps"] for k, v in
                                  device["self_busy_ms"].items()},
        "counters_per_step": {k: v / host["steps"] for k, v in c.items()},
        "idle_gaps_by_program_span": device["idle_gaps"],
        "syncs_per_step": record.syncs["count"] / record.syncs["steps"],
        "sync_sites": record.syncs["sites"],
    }


def main(argv=None) -> int:
    from . import run

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    want = run.pinned_env(cell["config"])
    if any(os.environ.get(k) != v for k, v in want.items()):
        if os.environ.get(run.T0_ENV):
            print("the re-executed run did not get its settings",
                  file=sys.stderr)
            return 2
        env = {**os.environ, **want, run.T0_ENV: repr(time.time())}
        os.execve(sys.executable,
                  [sys.executable, "-m", "portbench.program_trace", *argv],
                  env)
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 3
    print(json.dumps(measure(cell, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
