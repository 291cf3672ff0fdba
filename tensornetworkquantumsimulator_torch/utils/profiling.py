"""Profiling and observability.

The counterpart of ``tensornetworkquantumsimulator_tpu.utils.profiling``:
:func:`trace` captures a ``torch.profiler`` trace of a region (CPU and,
where there is one, CUDA activity) and writes it to ``log_dir`` as a
Chrome trace; :class:`LayerTimer` times each step between CUDA events
once the process uses CUDA, on the host clock otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/tnqs-trace"):
    """Profile the region; on exit write ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing).  Yields ``log_dir``, as the JAX
    package's ``trace`` does."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
