"""Profiling and observability.

The counterpart of ``tensornetworkquantumsimulator_tpu.utils.profiling``:
:func:`trace` captures a ``torch.profiler`` trace of a region (CPU and,
where there is one, CUDA activity) and writes it to ``log_dir`` as a
Chrome trace, with the program's own spans and counters beside it;
:class:`LayerTimer` times each step between CUDA events once the process
uses CUDA, on the host clock otherwise.

The program's spans and counters.  The package marks its own regions
(``with span("bp.update"):`` inside the function that does the work) and
counts its own events (:class:`Counter`).  Both record only while tracing
is on, which only :func:`tracing` (or :func:`trace`) turns on: with it off
a span site is one test of a module flag and returns a shared no-op
context, and a counter's :meth:`Counter.add` is the same test, so the off
path makes no CUDA event, no profiler range, no allocation and no device
operation.  With it on, each span keeps in memory its name, host start
and end (``time.perf_counter_ns``), its parent, its step (one id per
root ``layer`` span; a span outside any layer carries the last layer's
step) and, for a matrix batch, its batch size and order ``n``.  While a
``torch.profiler`` is recording, each span also opens the profiler range
``tnqs.<name>``, which puts the program's regions on the profiler's clock
beside the device's kernels.  The tracer follows one host thread, the one
that drives the layers.
"""

from __future__ import annotations

import array
import contextlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/tnqs-trace"):
    """Profile the region; on exit write ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing), in which the program's spans are the
    ``tnqs.*`` ranges over the device's kernels, and beside it the spans
    on the host clock (``spans.json``) and the counters (``counters.json``)
    that :meth:`Tracing.export` writes.  Yields ``log_dir``, as the JAX
    package's ``trace`` does."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with tracing() as handle:
        prof.start()
        try:
            yield log_dir
        finally:
            prof.stop()
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            handle.export(log_dir)


@contextlib.contextmanager
def _clock(out: list):
    """Append the region's seconds to ``out``: between two CUDA events
    (after the device has finished the region's work) once the process
    uses CUDA, on the host clock otherwise."""
    if torch.cuda.is_initialized():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3)
    else:
        t0 = time.perf_counter()
        yield
        out.append(time.perf_counter() - t0)


@dataclass
class LayerTimer:
    """Seconds per layer: CUDA events with a synchronize on CUDA, the host
    clock on the CPU.  ``layer``'s arguments are accepted for the JAX
    package's signature; the events wait for all of the device's work."""

    times: list = field(default_factory=list)

    @contextlib.contextmanager
    def layer(self, *sync_args):
        with _clock(self.times):
            yield

    def time_fn(self, fn, *args):
        with _clock(self.times):
            out = fn(*args)
        return out

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")


@dataclass(frozen=True)
class ApplyConfig:
    """The reference's `apply_kwargs` knob set (`apply_gates.jl` docstring)."""

    maxdim: int | None = None
    cutoff: float | None = None
    normalize_tensors: bool = True

    def asdict(self) -> dict:
        return dict(
            maxdim=self.maxdim,
            cutoff=self.cutoff,
            normalize_tensors=self.normalize_tensors,
        )


@dataclass(frozen=True)
class BPUpdateConfig:
    """The reference's `bp_update_kwargs` knob set
    (`beliefpropagationcache.jl:108-119`)."""

    maxiter: int | None = None
    tolerance: float | None = "default"  # type: ignore[assignment]
    verbose: bool = False

    def asdict(self) -> dict:
        out: dict = dict(verbose=self.verbose, tolerance=self.tolerance)
        if self.maxiter is not None:
            out["maxiter"] = self.maxiter
        return out


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

COUNTERS: dict = {}  # name -> Counter, every counter of the package
_tracer: "_Tracer | None" = None  # the session of tracing(); None: off


_FIELDS = 8  # integers a span keeps while tracing
_SLOTS = 1 << 20  # int32 slots of a counter's device buffer (Counter.device_slots)


class Span(NamedTuple):
    """One closed span; times in ns on ``time.perf_counter_ns``."""

    id: int
    name: str
    parent: int | None
    step: int
    start_ns: int
    end_ns: int
    self_ns: int  # the duration less the time its children cover
    batch: int | None = None
    n: int | None = None


class Counter:
    """A named count of the package's, registered in :data:`COUNTERS`.

    Kernel launches count always (``count += 1`` at the launch, as the
    kernel wrappers do).  :meth:`add` and :meth:`add_device` record only
    while tracing is on: :meth:`add` adds a host integer, and
    :meth:`add_device` adds the sum of a device tensor into an accumulator
    on that device, which :meth:`Tracing.collect` reads once, so a step
    never waits for it.  A session reports each counter's change since
    it began."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self

    def reset(self) -> None:
        self.count = 0

    def add(self, n: int = 1) -> None:
        if _tracer is not None:
            self.count += n

    def add_device(self, x: torch.Tensor) -> None:
        if _tracer is not None:
            _tracer.accumulate(self.name, x)

    def device_slots(self, n: int, device: torch.device) -> int:
        """While tracing, the device address of ``n`` int32 slots for a
        kernel to fill with counts that this counter adds up (on the device,
        at :meth:`Tracing.collect`); 0 while off.  A launch pays no tensor
        operation for it."""
        if _tracer is None:
            return 0
        return _tracer.slots(self.name, n, device)


_OFF = contextlib.nullcontext()  # every span site's span while tracing is off


def span(name: str, mat: torch.Tensor | None = None):
    """A region of the program, as a context manager: a no-op while tracing
    is off.  ``mat``, a batch of matrices [..., n, n], gives the span its
    batch size and order.  ``linalg.*`` spans take one depth: an eigh
    inside a roots call belongs to the roots span."""
    t = _tracer
    if t is None:
        return _OFF
    if (name.startswith("linalg.") and t.stack
            and t.stack[-1].name.startswith("linalg.")):
        return _OFF
    return _Open(t, name, mat)


def is_tracing() -> bool:
    return _tracer is not None


class _Open:
    __slots__ = ("tracer", "name", "batch", "n", "id", "parent", "step",
                 "child_ns", "start_ns", "range")

    def __init__(self, tracer, name, mat):
        self.tracer, self.name = tracer, name
        self.batch = self.n = None
        if mat is not None:
            self.n = int(mat.shape[-1])
            self.batch = math.prod(mat.shape[:-2])

    def __enter__(self):
        t = self.tracer
        stack = t.stack
        if not stack and self.name == "layer":
            t.step += 1
        self.id = t.next_id
        t.next_id += 1
        self.parent = stack[-1].id if stack else None
        self.step = t.step
        self.child_ns = 0
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(
                "tnqs." + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        t = self.tracer
        t.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        dur = end - self.start_ns
        if t.stack:
            t.stack[-1].child_ns += dur
        # flat integers, not a Span object per span: objects kept alive
        # from step to step would wake the cyclic garbage collector, whose
        # full passes over a process holding torch cost ~100 ms each
        t.names.append(self.name)
        t.records.extend((
            self.id, -1 if self.parent is None else self.parent, self.step,
            self.start_ns, end, dur - self.child_ns,
            -1 if self.batch is None else self.batch,
            -1 if self.n is None else self.n))
        return False


def _opt(v: int):
    return None if v < 0 else v


class _Tracer:
    def __init__(self):
        self.names: list = []  # each closed span's name
        self.records = array.array("q")  # and its _FIELDS integers
        self.stack: list = []
        self.step = 0
        self.next_id = 1
        self.base = {name: c.count for name, c in COUNTERS.items()}
        self.device_sums: dict = {}  # (name, device) -> int64 accumulator
        self.slot_bufs: dict = {}  # (name, device) -> [int32 buffer, used]

    def accumulate(self, name: str, x: torch.Tensor) -> None:
        s = x.sum(dtype=torch.int64)
        key = (name, x.device)
        acc = self.device_sums.get(key)
        if acc is None:
            self.device_sums[key] = s
        else:
            acc.add_(s)

    def slots(self, name: str, n: int, device: torch.device) -> int:
        entry = self.slot_bufs.get((name, device))
        if entry is None or entry[1] + n > entry[0].numel():
            if entry is not None:  # full: fold what it holds, start again
                self.accumulate(name, entry[0][:entry[1]])
            size = max(_SLOTS, n)
            if entry is None or entry[0].numel() < size:
                buf = torch.empty(size, dtype=torch.int32, device=device)
            else:
                buf = entry[0]
            entry = self.slot_bufs[(name, device)] = [buf, 0]
        buf, used = entry
        entry[1] = used + n
        return buf.data_ptr() + used * buf.element_size()


class Tracing:
    """The handle :func:`tracing` yields: :meth:`collect` and
    :meth:`export` read the session's spans and counters, during it or
    after it."""

    def __init__(self, tracer: _Tracer):
        self._tracer = tracer

    def collect(self) -> dict:
        """``{"spans": [Span], "counters": {name: int}}``: every counter's
        change since the session began (device accumulators read here,
        once; that waits for the device)."""
        t = self._tracer
        counts = {name: c.count - t.base.get(name, 0)
                  for name, c in COUNTERS.items()}
        for (name, _dev), acc in t.device_sums.items():
            counts[name] = counts.get(name, 0) + int(acc)
        for (name, _dev), (buf, used) in t.slot_bufs.items():
            counts[name] = counts.get(name, 0) + int(
                buf[:used].sum(dtype=torch.int64))
        r = t.records
        spans = [Span(r[i], name, _opt(r[i + 1]), r[i + 2], r[i + 3],
                      r[i + 4], r[i + 5], _opt(r[i + 6]), _opt(r[i + 7]))
                 for name, i in zip(t.names, range(0, len(r), _FIELDS))]
        return {"spans": spans, "counters": counts}

    def export(self, log_dir: str) -> None:
        """Write ``log_dir/spans.json`` (the spans as Chrome-trace complete
        events, in µs on the host clock) and ``log_dir/counters.json``."""
        data = self.collect()
        pid = os.getpid()
        events = [{"name": f"tnqs.{s.name}", "ph": "X", "pid": pid,
                   "tid": "tnqs spans", "ts": s.start_ns / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"id": s.id, "parent": s.parent, "step": s.step,
                            "self_us": s.self_ns / 1e3, "batch": s.batch,
                            "n": s.n}}
                  for s in data["spans"]]
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump({"traceEvents": events}, f)
        with open(os.path.join(log_dir, "counters.json"), "w") as f:
            json.dump(data["counters"], f, indent=1, sort_keys=True)


@contextlib.contextmanager
def tracing():
    """Turn the program's spans and counters on for the region; yields the
    session's :class:`Tracing` handle.  Sessions do not nest."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("tracing is already on")
    tracer = _tracer = _Tracer()
    try:
        yield Tracing(tracer)
    finally:
        _tracer = None
