"""Spans and counters around the package's layers, from the benchmark's
own files.

Each span wraps a package function under the name its caller looks it up
by (a module attribute; ``parallel/ensemble.py`` imports ``bp_update``
and ``apply_color_group`` from ``engine`` by name, so those are patched
there too) and times each call between two CUDA events: the span's
device time is the stream's time from the call's first enqueued work to
its last, idle gaps inside the span included, so a share computed from
it never overstates the device's rate.  A span records the shapes it was
handed, for the roofline counts in ``metrics/``.  ``eigh`` and ``roots``
share one depth: an eigh inside a roots call belongs to the roots span.
With ``label=True`` each span also opens a profiler range of its name.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

PKG = "tensornetworkquantumsimulator_torch.parallel"

# span name -> the (module, attribute) pairs its callers look it up in
TIMED = {
    "bp_update": (("engine", "bp_update"), ("ensemble", "bp_update")),
    "group_update": (("engine", "apply_color_group"),
                     ("ensemble", "apply_color_group")),
    "eigh": (("engine", "_eigh"),),
    "roots": (("engine", "_pseudo_roots"),),
    "bp_message": (("engine", "_outgoing_messages"),),
}
COUNTED = {"bp_sweep": (("engine", "bp_iteration"),)}
NESTED = {"eigh": "linalg", "roots": "linalg"}


def _shape_of(name, args):
    if name in ("eigh", "roots"):
        m = args[0]
        return (int(m.shape[-1]), int(m.numel() // (m.shape[-1] ** 2)),
                m.element_size())
    if name == "bp_message":
        t = args[0].tensors
        return (tuple(int(x) for x in t.shape), t.element_size())
    return None


class Spans:
    """Install with ``with spans.installed():``; timing runs only while
    ``enabled`` is true."""

    def __init__(self):
        self.enabled = False
        self.label = False
        self.pending: list = []  # (name, start event, end event, shape)
        self.counts = {k: 0 for k in COUNTED}
        self._depth = {}

    def _timed(self, name, fn):
        family = NESTED.get(name)

        def wrapped(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            if family is not None and self._depth.get(family, 0):
                return fn(*args, **kwargs)
            if family is not None:
                self._depth[family] = 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            ctx = (torch.profiler.record_function(f"portbench.{name}")
                   if self.label else contextlib.nullcontext())
            try:
                with ctx:
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
            finally:
                if family is not None:
                    self._depth[family] = 0
            self.pending.append((name, start, end, _shape_of(name, args)))
            return out
        return wrapped

    def _counted(self, name, fn):
        def wrapped(*args, **kwargs):
            if self.enabled:
                self.counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def region(self, name: str):
        """A span of the benchmark's own code (the readout call)."""
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ctx = (torch.profiler.record_function(f"portbench.{name}")
               if self.label else contextlib.nullcontext())
        with ctx:
            start.record()
            yield
            end.record()
        self.pending.append((name, start, end, None))

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for table, make in ((TIMED, self._timed), (COUNTED, self._counted)):
                for name, places in table.items():
                    for mod_name, attr in places:
                        mod = importlib.import_module(f"{PKG}.{mod_name}")
                        if not hasattr(mod, attr):
                            continue
                        orig = getattr(mod, attr)
                        saved.append((mod, attr, orig))
                        setattr(mod, attr, make(name, orig))
            yield self
        finally:
            for mod, attr, orig in reversed(saved):
                setattr(mod, attr, orig)

    def collect(self) -> dict:
        """name → [(device ms, shape)]; synchronizes the device."""
        torch.cuda.synchronize()
        out: dict = {}
        for name, start, end, shape in self.pending:
            out.setdefault(name, []).append((start.elapsed_time(end), shape))
        self.pending = []
        return out
