"""Multi-device boundary MPS: pipelined row-strand fitting over a mesh.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
sharded_bmps``.  The reference's boundary-MPS message update sweeps rows
in sequence (`boundarympscache.jl:321-360`): strand r+1 needs strand r,
but the upward and the downward chains are independent, and every row
scalar and expectation is independent once the strands exist.  Over a
1-D mesh axis of S shards holding ``nrows/S`` contiguous rows each:

- the upward and downward chains run as two wavefronts through the
  pipeline: at step t shard t extends the up chain over its rows and
  shard S-1-t the down chain, and each hands its carry on with one
  ``ppermute`` per step.  The reference runs the same fit on every device
  at every step and keeps the true one (SPMD); a single controller runs
  only the true fits, with the same exchanges;
- row scalars and expectations then run shard by shard; log Z is one
  ``psum`` of the shards' log contributions (the interface scalar ⟨m_up,
  m_dn⟩ below a shard's first row is computed on that shard from the
  received up carry and its own last down fit).

A shard's rows are built from the vertex tensors it holds: the input is a
sharded state's per-shard tensors (or one whole tensor), and a row vertex
held by another shard is copied in (counted as ``fetch``).  The fitting
kernel is ``boundarymps._fit_strand``, so the sharded evaluators agree
with the single-device ones to float roundoff.
"""

from __future__ import annotations

import numpy as np
import torch

from .boundarymps import (
    GridBMPSSpec,
    PlanarBMPSSpec,
    _edge_scalar,
    _fit_strand,
    _log_abs,
    _row_scalar_scaled,
    _scaled_ratio,
    _swap_up_down,
    identity_strand,
)
from .sharding import ShardedState, ShardMesh, _nbytes
from .structure import BatchedGraphSpec


class _HeldRows:
    """``tensors[i]`` for the vertex positions one shard's rows read, on
    that shard's device: the duck-typed tensor a row builder indexes."""

    def __init__(self, rows: dict, like: torch.Tensor, V: int, device):
        self._rows = rows
        self.shape = (V,) + tuple(like.shape[1:])
        self.ndim = like.ndim
        self.dtype = like.dtype
        self.device = device

    def __getitem__(self, i):
        return self._rows[int(i)]


def _source_tensors(tensors) -> list:
    if isinstance(tensors, ShardedState):
        return tensors.tensors
    if isinstance(tensors, torch.Tensor):
        return [tensors]
    return list(tensors)


def _make_sharded_bmps_fns(
    row_tensors_fn,
    row_positions,
    nrows: int,
    W: int,
    V: int,
    mesh: ShardMesh,
    axis: str,
    kmps: int,
    niters: int,
    tolerance="auto",
):
    """Shared builder: (norm_sqr_fn, expect_rowcol_fn) over any row
    provider, pipelined over ``mesh`` axis ``axis``; ``row_positions[r]``
    lists the vertex positions row r reads."""
    S = int(mesh.shape[axis])
    if nrows % S != 0:
        raise ValueError(
            f"{nrows} rows not divisible by {S} devices on axis {axis!r}"
        )
    Rl = nrows // S
    fwd = mesh.ring(axis, +1)
    bwd = mesh.ring(axis, -1)

    def rows_local(tensors):
        """Each shard's [Rl] rows, built on its device."""
        src = _source_tensors(tensors)
        Vs = src[0].shape[0]
        out = []
        for s in range(S):
            dev = mesh.devices[s]
            held, fetched = {}, 0
            for r in range(s * Rl, (s + 1) * Rl):
                for p in row_positions[r]:
                    t = src[p // Vs][p % Vs]
                    if p // Vs != s or t.device != dev:
                        fetched += _nbytes(t)
                        t = t.to(dev, copy=True)
                    held[p] = t
            if fetched:
                mesh.traffic.add("fetch", fetched)
            like = _HeldRows(held, src[0], V, dev)
            out.append([row_tensors_fn(like, r)
                        for r in range(s * Rl, (s + 1) * Rl)])
        return out

    def strands(rows):
        """Pipeline both chains: per shard its up / down strands, the up
        carry received below its first row, and the down fit of its first
        row (the strand into the row above)."""
        up = [None] * S
        dn = [None] * S
        recv_up = [None] * S
        bound_dn = [None] * S
        carry_up = [None] * S
        carry_dn = [None] * S
        for t in range(S):
            su, sd = t, S - 1 - t
            rows_u = rows[su]
            chi = rows_u[0].shape[1]
            dtype = rows_u[0].dtype
            cu = carry_up[su]
            if cu is None:
                cu = identity_strand(W, kmps, chi, dtype, mesh.devices[su])
            recv_up[su] = cu
            locs = []
            for j in range(Rl):
                locs.append(cu)  # m_up[s*Rl + j]
                if su * Rl + j < nrows - 1:
                    cu = _fit_strand(rows_u[j], cu, cu, niters, tolerance)
            up[su] = locs
            send = [None] * S
            send[su] = cu
            carry_up = mesh.ppermute(send, axis, fwd)

            rows_d = rows[sd]
            cd = carry_dn[sd]
            if cd is None:
                cd = identity_strand(W, kmps, chi, dtype, mesh.devices[sd])
            locs_d = [None] * Rl
            for j in range(Rl - 1, -1, -1):
                locs_d[j] = cd  # m_dn[s*Rl + j]
                if sd * Rl + j > 0:
                    cd = _fit_strand(_swap_up_down(rows_d[j]), cd, cd,
                                     niters, tolerance)
            dn[sd] = locs_d
            bound_dn[sd] = cd
            send = [None] * S
            send[sd] = cd
            carry_dn = mesh.ppermute(send, axis, bwd)
        return up, dn, recv_up, bound_dn

    def norm_sqr_fn(tensors):
        rows = rows_local(tensors)
        up, dn, recv_up, bound_dn = strands(rows)
        parts = []
        for s in range(S):
            vals = [_row_scalar_scaled(rows[s][j], up[s][j], dn[s][j])
                    for j in range(Rl)]
            log_z = torch.stack([_log_abs(v) for v in vals]).sum()
            phase = torch.angle(torch.stack([v for v, _ in vals])).sum()
            edges = [_edge_scalar(up[s][j + 1], dn[s][j])
                     for j in range(Rl - 1)]
            if s > 0:  # the interface below this shard's first row
                edges.append(_edge_scalar(recv_up[s], bound_dn[s]))
            if edges:
                edges = torch.stack(edges)
                log_z = log_z - torch.log(edges.abs()).sum()
                phase = phase - torch.angle(edges).sum()
            parts.append(torch.stack([log_z, phase]))
        total = mesh.psum(parts, axis)[0]
        return total[0], total[1]

    def expect_rowcol_fn(tensors, op):
        rows = rows_local(tensors)
        up, dn, _, _ = strands(rows)
        outs = []
        for s in range(S):
            o = torch.as_tensor(op).to(dtype=rows[s][0].dtype,
                                       device=mesh.devices[s])
            for j in range(Rl):
                denom = _row_scalar_scaled(rows[s][j], up[s][j], dn[s][j])
                num = torch.stack([_scaled_ratio(_row_scalar_scaled(
                    rows[s][j], up[s][j], dn[s][j], op=o, op_col=c), denom)
                    for c in range(W)])
                outs.append(num.real)
        return mesh.collect([x[None] for x in outs]).reshape(nrows, W)

    return norm_sqr_fn, expect_rowcol_fn


def make_sharded_grid_bmps(
    spec: BatchedGraphSpec,
    nx: int,
    ny: int,
    mesh: ShardMesh,
    axis: str = "r",
    kmps: int = 4,
    niters: int = 15,
    tolerance="auto",
):
    """Sharded boundary-MPS evaluators for an nx×ny grid state.

    Returns ``(norm_sqr_fn, expect_fn)`` matching `make_grid_bmps`:
    ``norm_sqr_fn(tensors) -> (log_abs_z, phase)``,
    ``expect_fn(tensors, op) -> [V]`` in row-major vertex order, where
    ``tensors`` is a sharded state (or its per-shard tensors, or one whole
    tensor); the results are on the mesh's first device."""
    gspec = GridBMPSSpec(spec, nx, ny)
    positions = [[r * ny + c for c in range(ny)] for r in range(nx)]
    norm_fn, expect_rc = _make_sharded_bmps_fns(
        gspec.row_tensors, positions, nx, ny, spec.num_vertices, mesh, axis,
        kmps, niters, tolerance
    )

    def expect_fn(tensors, op):
        return expect_rc(tensors, op).reshape(-1)

    return norm_fn, expect_fn


def make_sharded_planar_bmps(
    spec: BatchedGraphSpec,
    mesh: ShardMesh,
    axis: str = "r",
    kmps: int = 4,
    niters: int = 15,
    row_of=None,
    col_of=None,
    tolerance="auto",
):
    """Sharded boundary-MPS evaluators for any column-aligned planar
    lattice (heavy-hex, Lieb, comb — `make_planar_bmps` scope).

    Returns ``(norm_sqr_fn, expect_fn)`` with ``expect_fn`` output in
    ``spec.vertices`` order."""
    pspec = PlanarBMPSSpec(spec, row_of=row_of, col_of=col_of)
    positions = [[int(i) for i in pspec.vid[r] if i >= 0]
                 for r in range(pspec.nrows)]
    norm_fn, expect_rc = _make_sharded_bmps_fns(
        pspec.row_tensors, positions, pspec.nrows, pspec.W,
        spec.num_vertices, mesh, axis, kmps, niters, tolerance,
    )
    rows = np.array([pspec.rowcol[i][0] for i in range(spec.num_vertices)])
    cols = np.array([pspec.rowcol[i][1] for i in range(spec.num_vertices)])

    def expect_fn(tensors, op):
        rc = expect_rc(tensors, op)
        return rc[torch.as_tensor(rows, device=rc.device),
                  torch.as_tensor(cols, device=rc.device)]

    return norm_fn, expect_fn
