"""CUDA graphs of the flooding-BP sweep.

One sweep of ``engine.bp_update`` enqueues about 250 small kernels of fixed
shapes, and then the host reads one flag: whether to go on.  On a small
lattice the host takes longer to launch the kernels one by one than the
device takes to run them.  Here each sweep's three stretches are captured
once per shape as CUDA graphs and replayed:

- ``"m"`` (in ``engine._outgoing_messages``, the einsum route only): the
  outgoing messages, ``engine.outgoing_messages_einsum``;
- ``"n1"`` (in ``engine.bp_iteration``): the gather of the incoming
  messages and their normalization (``engine._incoming``);
- ``"n2"`` (in ``engine._fixed_point``): damping, the message distance, the
  members' freeze and the flag (``engine._sweep_end``).

The host still calls ``engine.bp_iteration`` and
``engine._outgoing_messages`` once a sweep, looked up on ``engine``, so
whatever wraps them sees every sweep; K3 (``cuda_bp.bp_outgoing_d3``, the
degree-3 route) runs eagerly between the graphs, and the host reads the
flag once a sweep, as on the eager path: every refresh stops on the sweep
it stops on there.

Each stretch reads fixed buffers and writes fixed outputs.  The inputs are
copied in: the state's tensors and the neighbour tables once a refresh (the
tensors before its first sweep, outside the spans of the sweeps), the
messages and the active members each sweep, K3's output each sweep.  The
graphs share the update's memory pool (``su_graphs.capture``), where a
stretch's replay may overwrite the outputs of any stretch captured after
it.  So each sweep first copies in the last sweep's outputs, before any
stretch replays, and :meth:`_Replay.out` copies the refresh's messages
out: no later replay overwrites what is still to be read.

A key names everything the captured code sees: device, dtypes, the
tensors' and messages' shapes and strides, the tables' dtypes and shapes,
the members, damping, tolerance and the message route.  Every value is an
input.  A key's first refresh runs eagerly, its second captures (in its
first sweep), every later one replays; at most :data:`MAX_KEYS` keys are
kept, least recently used out.  The graphs engage only where the code can:
CUDA tensors, autograd not recording through them, a stream not capturing
already.  A capture that raises leaves its key eager for the rest of the
process, with a warning.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..utils.profiling import Counter, span
from . import engine, su_graphs

# counted while tracing (``utils.profiling``); the replay share of BP's
# sweeps is 1 - bp.graph.eager / bp.sweeps
_CAPTURES = Counter("bp.graph.captures")  # stretches captured
_REPLAYS = Counter("bp.graph.replays")  # stretches replayed
_EAGER = Counter("bp.graph.eager")  # sweeps that ran eagerly
_EVICTIONS = Counter("bp.graph.evictions")  # keys dropped from the cache

MAX_KEYS = 16  # a field layer has one
_LAST = "n2"  # a sweep's last stretch
_ONCE = ("t", "nbr", "nbr_slot", "mask")  # fixed within a refresh
_ADOPTED = ("m_out",)  # a fresh output: its first value becomes the buffer

_cache: OrderedDict = OrderedDict()  # key -> su_graphs.Entry, least recent 1st
_capturable = su_graphs._capturable  # bound here: tests patch BP's alone


class _EagerSweeps:
    """A refresh that runs eagerly: ``engine._Eager``, each sweep counted."""

    @staticmethod
    def stretch(name, fn):
        if name == _LAST:
            _EAGER.add()
        return fn()

    @staticmethod
    def fixed(_name, value):
        return value

    @staticmethod
    def out(m):
        return m


def _engages(t, m) -> bool:
    if torch.is_grad_enabled() and (t.requires_grad or m.requires_grad):
        return False
    return _capturable(t.device)


def _key(state, tables, members, damping, tolerance) -> tuple:
    t, m = state.tensors, state.messages
    return (t.device, t.dtype, m.dtype, tuple(t.shape), t.stride(),
            tuple(m.shape), m.stride(),
            tuple((x.dtype, tuple(x.shape)) for x in tables), members,
            damping, tolerance, engine._k3_route(t, m))


def refresh(state, tables, members, damping, tolerance):
    """The runner of one ``bp_update`` call: replays of its key's graphs
    where they engage (captured in this call's first sweep if the key has
    none yet), else each sweep eagerly."""
    if not _engages(state.tensors, state.messages):
        return _EagerSweeps
    key = _key(state, tables, members, damping, tolerance)
    entry = su_graphs.cached(_cache, key, su_graphs.Entry, MAX_KEYS,
                             _EVICTIONS)
    entry.calls += 1
    if entry.calls == 1 or entry.failed:
        return _EagerSweeps
    run = _Replay(entry, state.tensors.device)
    if not key[-1]:  # the einsum route: M reads the tensors
        run.fixed("t", state.tensors)
    return run


class _Replay:
    """``engine``'s stretch runner for one refresh of a key: each stretch
    replayed (captured first where the key lacks it), each input copied
    into the key's fixed buffer of that name."""

    def __init__(self, entry, device):
        self.entry, self.device = entry, device
        self.eager = False  # a capture failed in this refresh
        self.replayed = False
        self.copied = set()  # the names of _ONCE copied in this refresh

    def fixed(self, name, value):
        if self.eager:
            return value
        statics = self.entry.statics
        buf = statics.get(name)
        if value is buf or name in self.copied:
            return buf
        if name in _ONCE:
            self.copied.add(name)
        if buf is None:
            buf = statics[name] = (value if name in _ADOPTED
                                   else value.clone())
        else:
            buf.copy_(value)
        return buf

    def stretch(self, name, fn):
        if self.eager:
            return _EagerSweeps.stretch(name, fn)
        entry = self.entry
        if name not in entry.stretches:
            try:
                entry.stretches[name] = su_graphs.capture(self.device)(fn)
            except Exception as exc:  # noqa: BLE001 - reported, then eager
                self.eager = True
                entry.refuse("bp_graphs: a BP sweep", exc)
                return _EagerSweeps.stretch(name, fn)
            _CAPTURES.add()
        replay, outs = entry.stretches[name]
        with span("bp.graph"):
            replay()
        _REPLAYS.add()
        self.replayed = True
        return outs

    def out(self, m):
        """The refresh's messages, copied out of the graphs' outputs."""
        return m.clone() if self.replayed else m
