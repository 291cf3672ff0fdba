"""CUDA graphs of the colour-group simple update.

One update of a colour group's buckets (``engine._group_update``) enqueues
about 200 small kernels of fixed shapes and reads nothing back to the host;
on a small lattice the host takes longer to launch them one by one than the
device takes to run them.  Here the update's three stretches are captured
once per shape as CUDA graphs and replayed:

- S0 (``engine._su_env``): the environments, stacked for one roots call;
- S1 (``engine._su_reduce`` and ``engine._gram``): √env absorbed, the
  stacked QR-reduce, θ, the Gram product;
- S2 (``engine._gram_factors``, ``_su_truncate``, ``_su_rebuild``): the
  split's tail, the rebuild, the messages.

``engine._group_core`` keeps that order and runs the stretches through a
runner; here the runner (:class:`_Replay`) replays them.  K1
(``engine._pseudo_roots``, after S0) and K2 (``engine._eigh``, after S1)
run eagerly between the graphs, looked up on ``engine`` at every call, so
whatever wraps them sees every call.

Each stretch reads fixed buffers: the buckets' endpoint rows, gathered
eagerly into them (the state itself is never a graph input), a copy of the
gate, and K1's and K2's outputs, copied in; it writes fixed outputs, which
the caller copies out (``engine._group_update``'s write-back) before any
other graph replays.  All graphs of a device share one memory pool, which
that order makes safe: a graph may overwrite the memory of another key's
outputs only after they were copied out.

A key names everything the captured code sees: device, dtypes, the state's
site shape (D, χ, d), each bucket's slot pair and row count, the gate's shape
and dtype, χ, the cutoff, normalization and the QR, SVD and eigh routes.
The indices and every value are inputs.  A key's first call runs eagerly
(which also warms the libraries), its second captures, every later call
replays; at most :data:`MAX_KEYS` keys are kept, least recently used out.

The graphs engage only where the code can: the tensors are on CUDA,
autograd is not recording through them, the stream is not capturing
already, and the route reads nothing back to the host: QR ``cholqr1``,
``cholqr2`` or ``defer`` with the ``gram`` split on the Jacobi eigh.  The
Householder QR reads its factors' finiteness (``engine._refactored``), the
library SVD checks its result, and the polar QR runs K1 inside S1: those
routes run eagerly.  A capture that raises leaves its key eager for the
rest of the process, with a warning.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict

import torch

from ..utils.profiling import Counter, span
from . import engine

# counted while tracing (``utils.profiling``)
_CAPTURES = Counter("su.graph.captures")  # stretches captured
_REPLAYS = Counter("su.graph.replays")  # stretches replayed
_EAGER = Counter("su.graph.eager")  # updates that ran eagerly
_EVICTIONS = Counter("su.graph.evictions")  # keys dropped from the cache

MAX_KEYS = 32  # a 5×5 field layer has 4, one per colour group
_QR_ROUTES = ("cholqr1", "cholqr2", "defer")

_cache: OrderedDict = OrderedDict()  # key -> _Entry, least recent first
_captures: dict = {}  # device -> Capture


class Capture:
    """Captures stretches into CUDA graphs on a side stream of ``device``,
    every graph in one shared memory pool.

    The allocator keeps a pool while any graph captured into it lives, and
    refuses a capture into a pool whose graphs all died before its memory
    was returned.  So the capturer holds a graph of its own in the pool
    (``_anchor``, one fill): the keys' graphs may all be evicted or dropped
    and later captures still find the pool."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            self._anchor.capture_begin(pool=self.pool)
            self._anchor_out = torch.zeros(1, device=device)
            self._anchor.capture_end()

    def __call__(self, fn):
        """(replay, outputs) of ``fn``, a stretch returning a tuple of
        tensors.  ``fn`` runs twice on the side stream: eagerly (the
        libraries' handles and workspaces of that stream), then captured.
        The outputs hold nothing until the first replay."""
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            fn()
            graph.capture_begin(pool=self.pool)
            try:
                outs = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void; the first error says why
                raise
            graph.capture_end()
        main.wait_stream(self.stream)
        return graph.replay, outs


class Entry:
    """One key's graphs (here and in ``bp_graphs``): its calls so far,
    whether its capture failed, its fixed buffers and its stretches."""

    __slots__ = ("calls", "failed", "statics", "stretches")

    def __init__(self):
        self.calls = 0
        self.failed = False
        self.drop()

    def drop(self):
        self.statics = {}  # name -> a fixed buffer a stretch reads
        self.stretches = {}  # name -> (replay, outputs)

    def refuse(self, what: str, exc: Exception):
        """A capture of this key raised: drop its graphs and buffers, keep
        it eager for the rest of the process, and warn."""
        self.failed = True
        self.drop()
        warnings.warn(f"{what}: capture failed, this shape runs eagerly from "
                      f"now on: {exc!r}", RuntimeWarning, stacklevel=3)


class _Entry(Entry):
    __slots__ = ("items", "gate")

    def drop(self):
        super().drop()  # statics: K1's and K2's outputs; stretches: S0-S2
        self.items = self.gate = None  # the gathered rows' and gate's buffers


def capture(device) -> Capture:
    """The capturer of ``device``: one memory pool per device, shared by
    every key's graphs, the update's and BP's (``bp_graphs``)."""
    cap = _captures.get(device)
    if cap is None:
        cap = _captures[device] = Capture(device)
    return cap


def _capturable(device) -> bool:
    return (device.type == "cuda"
            and not torch.cuda.is_current_stream_capturing())


def _engages(state, gate) -> bool:
    t, m = state.tensors, state.messages
    if torch.is_grad_enabled() and (
            t.requires_grad or m.requires_grad or gate.requires_grad):
        return False
    return (engine._qr_alg() in _QR_ROUTES and engine._svd_alg() == "gram"
            and engine._eigh_alg() == "jacobi" and _capturable(t.device))


def _key(state, group, gate, chi, cutoff, normalize_tensors) -> tuple:
    t = state.tensors
    return (t.device, t.dtype, state.messages.dtype, tuple(t.shape[1:]),
            tuple((su, sv, u_idx.shape[0]) for su, sv, u_idx, _ in group),
            tuple(gate.shape), gate.dtype, chi, cutoff,
            bool(normalize_tensors), engine._qr_alg(), engine._svd_alg(),
            engine._eigh_alg())


def cached(cache: OrderedDict, key, make, limit: int, evictions: Counter):
    """``cache[key]``, made by ``make()`` where absent, now the most recent
    key; beyond ``limit`` keys the least recent goes, counted."""
    entry = cache.get(key)
    if entry is not None:
        cache.move_to_end(key)
        return entry
    entry = cache[key] = make()
    if len(cache) > limit:
        cache.popitem(last=False)
        evictions.add()
    return entry


def _entry(key) -> _Entry:
    return cached(_cache, key, _Entry, MAX_KEYS, _EVICTIONS)


def updates(state, group, gate, chi, cutoff, normalize_tensors):
    """[(tu_new, tv_new, msg, err)] per bucket of ``group`` ([(slot_u,
    slot_v, u_idx, v_idx)]): replayed from the key's graphs where they
    engage, else ``engine._group_core`` on freshly gathered rows.  A
    replay's tensors are its graphs' outputs: copy them out before the next
    update."""
    if _engages(state, gate):
        entry = _entry(_key(state, group, gate, chi, cutoff,
                            normalize_tensors))
        entry.calls += 1
        if entry.stretches:
            return _run(entry, state, group, gate, chi, cutoff,
                        normalize_tensors, None)
        if entry.calls > 1 and not entry.failed:
            try:
                return _run(entry, state, group, gate, chi, cutoff,
                            normalize_tensors, capture(state.tensors.device))
            except Exception as exc:  # noqa: BLE001 - reported, then eager
                entry.refuse("su_graphs: the update", exc)
    _EAGER.add()
    return engine._group_core(engine._gather(state, group), gate, chi, cutoff,
                              normalize_tensors)


class _Replay:
    """``engine._group_core``'s runner on one key: each stretch is replayed
    (captured first, on a capture call), each kernel's output copied into
    the entry's fixed buffer of that name."""

    def __init__(self, entry, capture):
        self.entry, self.capture = entry, capture

    def stretch(self, i, fn):
        entry = self.entry
        if self.capture is not None:
            entry.stretches[i] = self.capture(fn)
            _CAPTURES.add()
        replay, outs = entry.stretches[i]
        with span("su.graph"):
            replay()
        _REPLAYS.add()
        return outs

    def fixed(self, name, value):
        """``value`` in the buffer ``name``; the first value (a fresh output
        of K1 or K2) becomes that buffer."""
        buf = self.entry.statics.get(name)
        if buf is None:
            self.entry.statics[name] = value
            return value
        buf.copy_(value)
        return buf


def _run(entry, state, group, gate, chi, cutoff, normalize_tensors, capture):
    tensors, messages = state.tensors, state.messages
    if capture is not None:
        entry.items = [
            (su, sv) + tuple(torch.index_select(src, 0, idx) for src, idx in (
                (tensors, u_idx), (tensors, v_idx), (messages, u_idx),
                (messages, v_idx)))
            for su, sv, u_idx, v_idx in group]
        entry.gate = gate.clone()
    else:
        for (_su, _sv, *bufs), (_, _, u_idx, v_idx) in zip(entry.items,
                                                            group):
            for buf, src, idx in zip(bufs, (tensors, tensors, messages,
                                            messages),
                                     (u_idx, v_idx, u_idx, v_idx)):
                torch.index_select(src, 0, idx, out=buf)
        entry.gate.copy_(gate)
    return engine._group_core(entry.items, entry.gate, chi, cutoff,
                              normalize_tensors, _Replay(entry, capture))
