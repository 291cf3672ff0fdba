"""Circuit → layer compiler for batched Trotter evolution.

Takes the tuple-circuit format (`gate_definitions.jl` conventions) and
compiles it into one layer over a :class:`~.engine.BatchedState`:

- runs of 1-site gates are fused into one per-vertex [V, d, d] matrix and
  applied as a single einsum;
- runs of 2-site gates are segmented into matchings (refreshing BP exactly
  where the reference's overlap-amortization would, `apply_gates.jl:60-85`),
  each matching bucketed by slot pair and applied as a batched simple
  update.

The layer is an ``nn.Module``: its buffers hold the fused one-site gates,
the two-site gates, the bucket index tensors and the neighbour tables, so
``layer.to(device)`` (or ``.to(device, dtype)``) moves them once and no
index table is copied to the device per call.
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
from .engine import (
    BatchedState,
    GraphTables,
    apply_color_group,
    apply_one_site,
    bp_update,
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


def _per_member(x: torch.Tensor, members: int) -> torch.Tensor:
    """Rows of ``x`` repeated once per ensemble member (member-major)."""
    return x if members == 1 else x.repeat((members,) + (1,) * (x.ndim - 1))


class TrotterLayer(nn.Module):
    """One compiled Trotter layer: ``state -> (state, truncation_errors)``."""

    def __init__(self, circuit: BatchedCircuit, chi: int, cutoff: float,
                 normalize_tensors: bool, bp_maxiter: int,
                 bp_tolerance: float | None, bp_damping: float,
                 final_update: bool):
        super().__init__()
        self.spec = circuit.spec
        self.chi, self.cutoff = chi, cutoff
        self.normalize_tensors = normalize_tensors
        self.bp_kwargs = dict(maxiter=bp_maxiter, tolerance=bp_tolerance,
                              damping=bp_damping)
        self.final_update = final_update
        tables = graph_tables(self.spec, "cpu")
        self.register_buffer("nbr", tables.nbr)
        self.register_buffer("nbr_slot", tables.nbr_slot)
        self.register_buffer("mask", tables.mask)
        # the plan names buffers, so it stays valid after .to(device)
        self._plan = []
        for i, seg in enumerate(circuit.segments):
            if isinstance(seg, _OneSiteSegment):
                self._buffer(f"seg{i}_gate", seg.gate)
                self._plan.append(("one", f"seg{i}_gate"))
                continue
            buckets = []
            for j, b in enumerate(seg.buckets):
                for side, idx in (("u", b.u_idx), ("v", b.v_idx)):
                    self._buffer(f"seg{i}_b{j}_{side}",
                                 np.asarray(idx, dtype=np.int64))
                buckets.append((b.slot_u, b.slot_v, f"seg{i}_b{j}_u",
                                f"seg{i}_b{j}_v"))
            if seg.gates_per_bucket is None:
                self._buffer(f"seg{i}_gate", seg.gate)
                gate_names = [f"seg{i}_gate"]
            else:
                gate_names = []
                for j, gb in enumerate(seg.gates_per_bucket):
                    self._buffer(f"seg{i}_b{j}_gate", gb)
                    gate_names.append(f"seg{i}_b{j}_gate")
            self._plan.append(("two", seg.needs_refresh, buckets, gate_names))

    def _buffer(self, name: str, array: np.ndarray) -> None:
        self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(array)))

    def forward(self, state: BatchedState):
        state, errs = self._run(state, 1)
        return state, errs[0]

    def ensemble(self, estate: BatchedState, params=(), axes=()):
        """E stacked states ``estate`` ([E, V, ...]) through the layer in
        one batched program (the members folded into the vertex axis, BP
        stopping per member).  Returns (estate, errors [E, n])."""
        if params:
            raise TypeError("a compiled layer takes no arguments besides "
                            "the state")
        E = estate.tensors.shape[0]
        state, errs = self._run(fold_members(estate), E)
        return unfold_members(state, E), errs

    def _run(self, state: BatchedState, E: int):
        with span("layer"):
            return self._layer(state, E)

    def _layer(self, state: BatchedState, E: int):
        V = self.spec.num_vertices
        tables = member_tables(GraphTables(self.nbr, self.nbr_slot, self.mask),
                               E, V)

        def refresh(st):
            return bp_update(self.spec, st, tables=tables, members=E,
                             **self.bp_kwargs)

        errs = []
        for step in self._plan:
            if step[0] == "one":  # [V, d, d], one copy per member
                state = apply_one_site(state, _per_member(
                    getattr(self, step[1]), E))
                continue
            _, needs_refresh, buckets, gate_names = step
            if needs_refresh:
                state = refresh(state)
            bks = [SlotPairBucket(su, sv,
                                  member_indices(getattr(self, un), E, V),
                                  member_indices(getattr(self, vn), E, V))
                   for (su, sv, un, vn) in buckets]
            gates = [getattr(self, gn) for gn in gate_names]
            if gates[0].ndim == 4:  # one [d, d, d, d] gate for every edge
                groups = [(bks, gates[0])]
            else:  # per-edge gates [B, ...], one copy per member
                groups = [((b,), _per_member(gate, E))
                          for b, gate in zip(bks, gates)]
            for group, gate in groups:
                state, err = apply_color_group(
                    state, group, gate, self.chi, self.cutoff,
                    self.normalize_tensors,
                )
                # errors come bucket by bucket, each member-major
                sizes = [len(b.u_idx) for b in group]
                errs += [e.reshape(E, -1) for e in err.split(sizes)]
        if self.final_update:
            state = refresh(state)
        if not errs:
            return state, torch.zeros((E, 0), device=state.tensors.device)
        return state, torch.cat(errs, dim=1)


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
