"""Reading the device trace of a short sub-window.

``device_pass`` traces the device alone (kernels, copies, memsets) over a
few steps: their count, the union of their intervals (busy seconds), the
sub-window's length on the host clock between two synchronizes, and the
device operations that took most time.  ``labelled_pass`` traces host and
device over fewer steps with the spans' profiler ranges open, and files
each idle gap of the device under the innermost benchmark range the host
was in when the gap began: what the host was doing while the device
waited.  ``sync_pass`` counts the synchronizations torch reports in CUDA's
sync debug mode.
"""

from __future__ import annotations

import time
import warnings

import torch

HARNESS = "outside the layer (harness)"
NAME_CHARS = 120  # kernel names are C++ template signatures


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_pass(run_steps) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run_steps()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = _device_events(prof)
    busy = _union((e.time_range.start, e.time_range.end) for e in events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "device_ops": len(events),
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": window_s,
            "top": [[k[:NAME_CHARS], v] for k, v in top]}


def labelled_pass(run_steps, spans) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    spans.enabled = spans.label = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_steps()
            torch.cuda.synchronize()
    finally:
        spans.enabled = spans.label = False
        spans.collect()  # these spans' times belong to no metric
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len("portbench."):])
              for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("portbench.")]
    # the device's copies of the ranges are annotations, not work
    busy = _union((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("portbench."))
    idle: dict = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        inside = [r for r in ranges if r[0] <= end < r[1]]
        # the innermost range holding the gap's start
        label = min(inside, key=lambda r: r[1] - r[0])[2] if inside else HARNESS
        idle[label] = idle.get(label, 0.0) + (nxt - end) / 1e6
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]


def sync_pass(run_steps) -> dict:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            steps = run_steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    count = sum("synchroniz" in str(w.message) for w in seen)
    return {"steps": steps, "count": count}
