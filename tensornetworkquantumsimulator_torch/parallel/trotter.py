"""Circuit → layer compiler for batched Trotter evolution.

Takes the tuple-circuit format (`gate_definitions.jl` conventions) and
compiles it into one layer over a :class:`~.engine.BatchedState`:

- runs of 1-site gates are fused into one per-vertex [V, d, d] matrix and
  applied as a single einsum;
- runs of 2-site gates are segmented into matchings (refreshing BP exactly
  where the reference's overlap-amortization would, `apply_gates.jl:60-85`),
  each matching bucketed by slot pair and applied as ONE batched simple
  update across its buckets.

The layer is an ``nn.Module``: its buffers hold the fused one-site gates,
the two-site gates, the bucket index tensors and the neighbour tables, so
``layer.to(device)`` (or ``.to(device, dtype)``) moves them once and no
index table is copied to the device per call.  Its body,
:class:`ColourGroupLayer`, is also the parametric layer's
(``ensemble.FieldLayer``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..devices import resolve_device
from ..models import channels as _channels
from ..models import gates as _gates
from ..utils.graphs import NamedGraph
from ..utils.lattices import _gate_vertices
from ..utils.profiling import span
from . import engine
from .engine import (
    BatchedState,
    GraphTables,
    apply_one_site,
    fold_members,
    graph_tables,
    local_expectations,
    member_indices,
    member_tables,
    unfold_members,
)
from .structure import BatchedGraphSpec, SlotPairBucket, compile_graph


@dataclasses.dataclass
class _OneSiteSegment:
    gate: np.ndarray  # [V, d, d] fused per-vertex matrices


@dataclasses.dataclass
class _TwoSiteSegment:
    buckets: tuple  # SlotPairBuckets
    gate: np.ndarray | None  # [d,d,d,d] when uniform across the segment
    gates_per_bucket: tuple | None  # per-bucket [B, d,d,d,d] otherwise
    needs_refresh: bool


class BatchedCircuit:
    """A tuple circuit compiled against a lattice for batched execution."""

    def __init__(
        self,
        circuit: Sequence,
        g: NamedGraph,
        spec: BatchedGraphSpec | None = None,
        d: int = 2,
        heisenberg: bool = False,
        picture: str | None = None,
    ):
        """``picture`` selects the transfer-matrix convention on d=4 Pauli
        sites: "heisenberg" (≡ heisenberg=True, adjoint maps for operator
        evolution) or "rho" (Schrödinger maps for density-matrix evolution,
        `models/channels.py`).  Noise-channel names (`channels.is_channel`)
        are accepted in either picture."""
        if heisenberg and picture not in (None, "heisenberg"):
            raise ValueError(
                f"heisenberg=True contradicts picture={picture!r}"
            )
        if picture is None:
            picture = "heisenberg" if heisenberg else None
        if picture not in (None, "heisenberg", "rho"):
            raise ValueError(f"unknown picture {picture!r}")
        if picture is not None and d != 4:
            raise ValueError("PTM pictures need d=4 Pauli sites")
        self.spec = spec if spec is not None else compile_graph(g)
        self.d = d
        pos = {v: i for i, v in enumerate(self.spec.vertices)}
        slot_of = {}
        for (iu, iv, su, sv) in self.spec.edges:
            slot_of[(iu, iv)] = su
            slot_of[(iv, iu)] = sv
        V = self.spec.num_vertices

        segments = []
        one_site = None  # accumulating [V, d, d]
        two_run: list = []  # (iu, iv, matrix)
        applied_any = False

        def flush_one_site():
            nonlocal one_site
            if one_site is not None:
                segments.append(_OneSiteSegment(gate=one_site))
                one_site = None

        def flush_two_run():
            nonlocal two_run, applied_any
            if not two_run:
                return
            # split the run into matchings at vertex overlaps (the
            # reference's affected-set refresh points)
            matchings = []
            current, used = [], set()
            for (iu, iv, mat) in two_run:
                if iu in used or iv in used:
                    matchings.append(current)
                    current, used = [], set()
                current.append((iu, iv, mat))
                used.update((iu, iv))
            if current:
                matchings.append(current)
            for matching in matchings:
                buckets: dict = {}
                for (iu, iv, mat) in matching:
                    su, sv = slot_of[(iu, iv)], slot_of[(iv, iu)]
                    buckets.setdefault((su, sv), []).append((iu, iv, mat))
                bs, gates = [], []
                for (su, sv), entries in sorted(buckets.items()):
                    bs.append(SlotPairBucket(
                        slot_u=su, slot_v=sv,
                        u_idx=tuple(e[0] for e in entries),
                        v_idx=tuple(e[1] for e in entries),
                    ))
                    gates.append(np.stack([e[2] for e in entries]))
                uniform = all(
                    np.array_equal(gp, gates[0][0][None].repeat(len(gp), 0))
                    for gp in gates
                )
                segments.append(_TwoSiteSegment(
                    buckets=tuple(bs),
                    gate=gates[0][0] if uniform else None,
                    gates_per_bucket=None if uniform else tuple(gates),
                    needs_refresh=applied_any,
                ))
                applied_any = True
            two_run = []

        for gate in circuit:
            name = gate[0]
            verts = _gate_vertices(gate[1])
            param = gate[2] if len(gate) > 2 else None
            if picture is None:
                mat = np.asarray(_gates.gate_matrix(name, param))
            elif _channels.is_channel(name):
                mat = _channels.channel_ptm(
                    name, param, nsites=len(verts),
                    heisenberg=(picture == "heisenberg"),
                )
            elif picture == "heisenberg":
                mat = np.array(_gates._ptm_cached(name[1:].upper(),
                                                  float(param)))
            else:
                mat = np.array(_gates._ptm_schrodinger_cached(
                    name, None if param is None else float(param)))
            if len(verts) == 1:
                flush_two_run()
                if one_site is None:
                    one_site = np.broadcast_to(
                        np.eye(d, dtype=mat.dtype), (V, d, d)
                    ).copy()
                if one_site.dtype != np.promote_types(one_site.dtype, mat.dtype):
                    one_site = one_site.astype(
                        np.promote_types(one_site.dtype, mat.dtype)
                    )
                i = pos[verts[0]]
                one_site[i] = mat @ one_site[i]
                applied_any = True
            elif len(verts) == 2:
                flush_one_site()
                iu, iv = pos[verts[0]], pos[verts[1]]
                if (iu, iv) not in slot_of:
                    raise ValueError(f"gate on non-edge {verts}")
                two_run.append((iu, iv, mat.reshape(d, d, d, d)))
            else:
                raise ValueError("only 1- and 2-site gates supported")
        flush_two_run()
        flush_one_site()
        self.segments = tuple(segments)


def _group_rows(x: torch.Tensor, sizes) -> torch.Tensor:
    """A colour group's per-edge rows [E, ΣB, ...] (each member's edges in
    bucket order, buckets of ``sizes``) in its update's order [E·ΣB, ...]:
    bucket by bucket, each member-major (as ``member_indices`` folds)."""
    if x.shape[0] == 1 or len(sizes) == 1:
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return torch.cat([p.reshape((-1,) + tuple(x.shape[2:]))
                      for p in x.split(list(sizes), dim=1)])


def _group_errors(err: torch.Tensor, E: int, sizes) -> list:
    """The inverse of :func:`_group_rows` for the update's errors [E·ΣB]:
    each bucket's [E, B], in bucket order."""
    return [e.reshape(E, -1) for e in err.split([E * b for b in sizes])]


class ColourGroupLayer(nn.Module):
    """The body of :class:`TrotterLayer` and ``ensemble.FieldLayer``:
    ``state -> (state, truncation_errors)``.

    It runs a plan of one-site steps and colour-group steps.  A colour-group
    step refreshes BP where the plan asks, then makes ONE
    :func:`~.engine.apply_color_group` call over the group's buckets, with
    a shared gate [d, d, d, d] or per-edge gates in :func:`_group_rows`
    order; a final refresh closes the layer.  The buffers hold the graph
    tables and each bucket's endpoints, so ``.to(device)`` moves them
    once.  A subclass fills the plan and builds the gates: ``_arguments``
    checks a call's parameters, ``_one_site_gate`` and ``_group_gate``
    build a step's gates from them."""

    def __init__(self, spec: BatchedGraphSpec, chi: int, cutoff: float,
                 normalize_tensors: bool, bp_maxiter: int,
                 bp_tolerance: float | None, bp_damping: float,
                 final_update: bool):
        super().__init__()
        self.spec, self.chi = spec, chi
        self.cutoff, self.normalize_tensors = cutoff, normalize_tensors
        self.bp_kwargs = dict(maxiter=bp_maxiter, tolerance=bp_tolerance,
                              damping=bp_damping)
        self.final_update = final_update
        tables = graph_tables(spec, "cpu")
        self.register_buffer("nbr", tables.nbr)
        self.register_buffer("nbr_slot", tables.nbr_slot)
        self.register_buffer("mask", tables.mask)
        # the plan names buffers, so it stays valid after .to(device):
        # ("one", key) or ("group", group, needs_refresh, key); per colour
        # group its buckets' (slot_u, slot_v, u, v) and their sizes
        self._plan = []
        self._groups = []

    def _buffer(self, name: str, array: np.ndarray) -> None:
        self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(array)))

    def _add_group(self, prefix: str, buckets, needs_refresh: bool,
                   key: str) -> None:
        plan = []
        for j, b in enumerate(buckets):
            names = tuple(f"{prefix}_b{j}_{k}" for k in "uv")
            for name, idx in zip(names, (b.u_idx, b.v_idx)):
                self._buffer(name, np.asarray(idx, dtype=np.int64))
            plan.append((b.slot_u, b.slot_v) + names)
        self._plan.append(("group", len(self._groups), needs_refresh, key))
        self._groups.append((tuple(plan),
                             tuple(len(b.u_idx) for b in buckets)))

    def forward(self, state: BatchedState, *params):
        """One realization: ``(state, *params) -> (state, errors)``; the
        compiled layer takes no parameters, a field layer its angles."""
        args = self._arguments(params, (None,) * len(params), 1,
                               state.tensors.device)
        state, errs = self._run(state, 1, args)
        return state, errs[0]

    def ensemble(self, estate: BatchedState, params=(), axes=()):
        """E stacked states ``estate`` ([E, V, ...]) in one batched program
        (the members folded into the vertex axis, BP stopping per member);
        ``axes[i]`` is 0 when ``params[i]`` has a leading ensemble axis and
        None when it is shared.  Returns (estate, errors [E, n])."""
        E = estate.tensors.shape[0]
        args = self._arguments(params, axes, E, estate.tensors.device)
        state, errs = self._run(fold_members(estate), E, args)
        return unfold_members(state, E), errs

    def _run(self, state: BatchedState, E: int, args):
        with span("layer"):
            return self._layer(state, E, args)

    def _layer(self, state: BatchedState, E: int, args):
        V, d = self.spec.num_vertices, state.tensors.shape[-1]
        tables = member_tables(GraphTables(self.nbr, self.nbr_slot, self.mask),
                               E, V)

        # BP and the update are looked up on the engine at each call, so a
        # wrapper installed there sees every call
        def refresh(st):
            return engine.bp_update(self.spec, st, tables=tables, members=E,
                                    **self.bp_kwargs)

        errs = []
        for step in self._plan:
            if step[0] == "one":  # [E·V, d, d]
                state = apply_one_site(state,
                                       self._one_site_gate(step[1], E, args))
                continue
            _, gi, needs_refresh, key = step
            if needs_refresh:
                state = refresh(state)
            plan, sizes = self._groups[gi]
            buckets = [SlotPairBucket(su, sv,
                                      member_indices(getattr(self, un), E, V),
                                      member_indices(getattr(self, vn), E, V))
                       for su, sv, un, vn in plan]
            gate = self._group_gate(key, sizes, E, d, args)
            state, err = engine.apply_color_group(
                state, buckets, gate.to(state.tensors.dtype), self.chi,
                self.cutoff, self.normalize_tensors)
            errs += _group_errors(err, E, sizes)
        if self.final_update:
            state = refresh(state)
        if not errs:
            return state, torch.zeros((E, 0), device=state.tensors.device)
        return state, torch.cat(errs, dim=1)


class TrotterLayer(ColourGroupLayer):
    """One compiled Trotter layer: ``state -> (state, truncation_errors)``,
    a colour-group step per matching of the circuit, its per-edge gates
    (where they differ) one [ΣB, d, d, d, d] buffer in bucket order."""

    def __init__(self, circuit: BatchedCircuit, chi: int, cutoff: float,
                 normalize_tensors: bool, bp_maxiter: int,
                 bp_tolerance: float | None, bp_damping: float,
                 final_update: bool):
        super().__init__(circuit.spec, chi, cutoff, normalize_tensors,
                         bp_maxiter, bp_tolerance, bp_damping, final_update)
        for i, seg in enumerate(circuit.segments):
            key = f"seg{i}_gate"
            if isinstance(seg, _OneSiteSegment):
                self._buffer(key, seg.gate)
                self._plan.append(("one", key))
                continue
            self._buffer(key, seg.gate if seg.gates_per_bucket is None
                         else np.concatenate(seg.gates_per_bucket))
            self._add_group(f"seg{i}", seg.buckets, seg.needs_refresh, key)

    def _arguments(self, params, axes, E, device):
        if params:
            raise TypeError("a compiled layer takes no arguments besides "
                            "the state")
        return ()

    def _one_site_gate(self, key, E, args):
        gate = getattr(self, key)  # [V, d, d], one copy per member
        return gate if E == 1 else gate.repeat(E, 1, 1)

    def _group_gate(self, key, sizes, E, d, args):
        gate = getattr(self, key)
        if gate.ndim == 4:  # one [d, d, d, d] gate for every edge
            return gate
        return _group_rows(gate.expand((E,) + tuple(gate.shape)), sizes)


def make_layer_fn(
    circuit: BatchedCircuit,
    chi: int,
    cutoff: float = 1e-12,
    normalize_tensors: bool = True,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    bp_damping: float = 0.0,
    final_update: bool = True,
    jit: bool = True,
    scan_groups: bool = False,
    device=None,
) -> TrotterLayer:
    """Build the layer module: ``layer(state) -> (state, truncation_errors)``.

    ``jit`` and ``scan_groups`` are accepted for signature parity with the
    JAX package and change nothing: PyTorch runs eagerly, and the scanned
    layer existed only to shrink TPU compiles (it is test-equivalent to the
    unrolled one).  The module lives on ``device`` (None: the package's
    default, CUDA)."""
    del jit, scan_groups
    layer = TrotterLayer(circuit, chi, cutoff, normalize_tensors, bp_maxiter,
                         bp_tolerance, bp_damping, final_update)
    return layer.to(resolve_device(device))


def make_expectation_fn(spec: BatchedGraphSpec, op: np.ndarray,
                        real_output: bool = False) -> Callable:
    """Per-vertex ⟨op⟩; ``real_output=True`` returns the real part."""
    op = np.asarray(op)

    def fn(state: BatchedState):
        out = local_expectations(spec, state, op)
        return out.real if real_output else out

    return fn
