"""Sharded loop corrections: Z ≈ Z_BP · (1 + Σ_configs Π_components w)
on the sharded state, with no gather of the network.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
sharded_loopcorrection`` (reference: `loopcorrection.jl:3-16`):

- **Z_BP** (`abstractbeliefpropagationcache.jl:252-267`): vertex scalars
  are shard-local; edge pair scalars use the bond-bucket halo tables (one
  ``ppermute`` per cross-shard slot-pair bucket) and both log sums are
  ``psum``-reduced.
- **rescale** (`abstractbeliefpropagationcache.jl:269-291`): the same
  buckets pair-normalize the two stored messages of every edge — the
  cross-shard partner's correction travels back with one ``ppermute`` —
  then each shard normalizes its own vertices.
- **loop weights** (`loopcorrection.jl:19-91`): every leaf-free
  configuration component belongs to the strip shard holding its minimal
  vertex; the rows of the next shard that its configurations touch come in
  with one exchange (tensor and message rows), and the owner runs the
  single-device weight kernels (``loopcorrection._bucket_weights`` /
  ``_general_weights``) on its extended local state.  Components spanning
  more than two adjacent strips are refused at build time.
- **correction sum**: component weights are scalars, so one
  ``all_gather`` of the per-shard weight vectors makes the configuration
  products replicated — O(components) bytes, independent of χ.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import BatchedState, _select_rows, local_rdms
from .loopcorrection import (
    LoopConfigurations,
    _bucket_weights,
    _general_weights,
    _sandwich_vertex_scalars,
)
from .sharded_layer import strip_bond_buckets
from .sharding import ShardedBPSpec, ShardedState, ShardMesh, _long, check_mesh


def _build_loop_tables(sspec: ShardedBPSpec, configurations):
    """Assign each loop component to its owner shard and remap its vertex
    positions into the owner's extended-local index space
    ``[0, Vl + H)`` (local rows, then halo rows received from the next
    shard).  Returns per-bucket padded tables, the send table, and the
    old-flat-index → (S·total)-flat permutation used to re-point
    ``configurations.groups`` at the all_gathered weight vector."""
    spec = sspec.spec
    S = sspec.num_shards
    Vl = spec.num_vertices // S

    send: list = [[] for _ in range(S)]  # local rows shard s sends to s-1

    def owner_of(ivs):
        shards = sorted({int(p) // Vl for p in ivs})
        if len(shards) == 1:
            return shards[0]
        if len(shards) == 2:
            a, b = shards
            if (a + 1) % S == b:
                return a
            if (b + 1) % S == a:  # periodic wrap {0, S-1}
                return b
        raise ValueError(
            "loop configuration spans more than two adjacent strip "
            "shards: use wider strips (fewer shards) or a smaller "
            "max_configuration_size"
        )

    def remap(p, owner):
        p = int(p)
        if p // Vl == owner:
            return p % Vl
        lst = send[p // Vl]
        lp = p % Vl
        if lp not in lst:
            lst.append(lp)
        return Vl + lst.index(lp)

    all_buckets = [("c", idx, slots) for idx, slots in configurations.buckets]
    all_buckets += [
        ("g", idx, sig) for idx, sig in configurations.general_buckets
    ]

    bucket_tabs = []  # (kind, sig/slots, idx_tab [S, Pb, L], valid [S, Pb])
    row_lane = []  # per bucket: [(owner, lane)] per row
    for kind, idx, sig in all_buckets:
        per_shard: list = [[] for _ in range(S)]
        lanes = []
        for row in idx:
            owner = owner_of(row)
            lanes.append((owner, len(per_shard[owner])))
            per_shard[owner].append([remap(p, owner) for p in row])
        Pb = max(1, max(len(l) for l in per_shard))
        L = idx.shape[1]
        idx_tab = np.zeros((S, Pb, L), np.int32)
        valid = np.zeros((S, Pb), bool)
        for s, lst in enumerate(per_shard):
            for i, r in enumerate(lst):
                idx_tab[s, i] = r
                valid[s, i] = True
        bucket_tabs.append((kind, sig, idx_tab, valid))
        row_lane.append(lanes)

    H = max(1, max(len(l) for l in send))
    send_tab = np.zeros((S, H), np.int32)
    for s, lst in enumerate(send):
        send_tab[s, : len(lst)] = lst

    # old flat layout (batched): bucket rows in order; new: s*total + off + lane
    total = sum(t[3].shape[1] for t in bucket_tabs)
    perm = np.zeros(
        sum(len(lanes) for lanes in row_lane), np.int64
    )
    k = 0
    off = 0
    for (kind, sig, idx_tab, valid), lanes in zip(bucket_tabs, row_lane):
        for owner, lane in lanes:
            perm[k] = owner * total + off + lane
            k += 1
        off += idx_tab.shape[1]
    groups = {
        n: perm[g] for n, g in configurations.groups.items()
    }
    return bucket_tabs, send_tab, groups, total


class _LoopPlan:
    """`_build_loop_tables` as per-shard device tables: each bucket's valid
    rows, the halo send rows, and the configuration groups on the mesh's
    devices."""

    def __init__(self, mesh: ShardMesh, sspec, configurations):
        tabs, send_tab, groups, _ = _build_loop_tables(sspec,
                                                       configurations)
        devs = mesh.devices
        self.buckets = []
        for kind, sig, idx_tab, valid in tabs:
            n = valid.sum(1)
            self.buckets.append((kind, sig, [
                _long(idx_tab[s, :n[s]], d) for s, d in enumerate(devs)],
                idx_tab.shape[1]))
        self.send = [_long(send_tab[s], d) for s, d in enumerate(devs)]
        self.groups = [{k: _long(g, d) for k, g in groups.items()}
                       for d in devs]

    def weights(self, mesh, spec, ext_states, bra_conj=None):
        """Every shard's padded weight vector, all-gathered and flattened
        on every shard (None where the configuration space is empty)."""
        if not self.buckets:
            return None
        per = []
        for s, st in enumerate(ext_states):
            ws = []
            for kind, sig, idx, width in self.buckets:
                bc = None if bra_conj is None else bra_conj[s]
                if idx[s].shape[0]:
                    fn = _bucket_weights if kind == "c" else _general_weights
                    w = fn(spec, st, idx[s], sig, bc)
                else:
                    w = st.tensors.new_zeros((0,))
                ws.append(torch.cat([w, w.new_zeros(width - w.shape[0])]))
            per.append(torch.cat(ws))
        return [x.reshape(-1) for x in mesh.all_gather(per)]


def _halo_extend(mesh: ShardMesh, send, xs, left):
    """Each shard's rows followed by the rows the next shard sends it."""
    recv = mesh.ppermute([x[i] for x, i in zip(xs, send)], *left)
    return [torch.cat([x, r]) for x, r in zip(xs, recv)]


def _pair_normalize(mesh: ShardMesh, bond_buckets, messages, log_dtype=None):
    """Pair-normalize every edge's two stored messages through the
    bond-bucket halo tables (`beliefpropagationcache.jl:129-142`).
    Returns ``(messages, log_se)``: ``log_se`` is the psum'd Σ log⟨m, m̄⟩
    when ``log_dtype`` is given (the Z_BP edge part), else None."""
    S = mesh.num_shards
    messages = [m.clone() for m in messages]
    log_se = [torch.zeros((), dtype=log_dtype, device=m.device)
              for m in messages] if log_dtype is not None else None
    for b in bond_buckets:
        su, sv = b.slot_u, b.slot_v
        X = b.partner(mesh, [m[:, sv] for m in messages])  # u→v, at v
        newX = []
        for s in range(S):
            if b.n[s] == 0:
                newX.append(None)
                continue
            Y = messages[s][b.u[s], su]  # v→u message, stored at u (local)
            se = torch.einsum("eab,eab->e", X[s], Y)
            if log_se is not None:
                log_se[s] = log_se[s] + torch.log(se.to(log_dtype)).sum()
            inv_root = (1.0 / torch.sqrt(se.to(Y.dtype)))[:, None, None]
            messages[s][:, su] = _select_rows(messages[s][:, su],
                                              Y * inv_root, b.u_inv[s],
                                              b.u_wr[s])
            newX.append(X[s] * inv_root)
        if b.xfer is not None:
            newX = mesh.ppermute(newX, *b.xfer[1])
        for s in range(S):
            if newX[s] is not None:
                messages[s][:, sv] = _select_rows(messages[s][:, sv],
                                                  newX[s], b.v_inv[s],
                                                  b.v_wr[s])
    if log_se is not None:
        log_se = mesh.psum(log_se)
    return messages, log_se


def _vertex_normalize(spec, tensors, messages):
    """Each shard's tensors scaled to z_v = 1 on its pair-normalized
    messages (`abstractbeliefpropagationcache.jl:269-291`)."""
    out = []
    for t, m in zip(tensors, messages):
        zv2 = torch.einsum("vss->v", local_rdms(spec, BatchedState(t, m)))
        scale = 1.0 / torch.sqrt(zv2.to(t.dtype))
        out.append(t * scale.reshape((-1,) + (1,) * (t.ndim - 1)))
    return out


def _series(flat, groups):
    total = torch.zeros((), dtype=flat.dtype, device=flat.device)
    for _n, gidx in groups.items():
        total = total + torch.prod(flat[gidx], dim=1).sum()
    return total


def make_sharded_loopcorrections(
    sspec: ShardedBPSpec,
    mesh: ShardMesh,
    g,
    max_configuration_size: int = 4,
    configurations: LoopConfigurations | None = None,
    axis: str = "v",
):
    """Build ``z_fn(sstate) -> Z``, the loop-corrected partition function
    of the sharded state (the series of
    `loopcorrection.loopcorrected_partitionfunction`, matching it to float
    roundoff), a 0-dim tensor on the mesh's first device.  ``sstate`` must
    be at a BP fixed point (run the sharded BP update first)."""
    check_mesh(sspec, mesh, axis)
    spec = sspec.spec
    if configurations is None:
        configurations = LoopConfigurations(spec, g, max_configuration_size)
    plan = _LoopPlan(mesh, sspec, configurations)
    bond_buckets = strip_bond_buckets(sspec, mesh, axis)
    left = (axis, mesh.ring(axis, -1))

    def z_fn(sstate: ShardedState):
        tensors, messages = sstate.tensors, sstate.messages
        cdtype = torch.promote_types(tensors[0].dtype, torch.complex64)
        # Z_BP vertex part on the un-rescaled state
        log_zv = mesh.psum([
            torch.log(torch.einsum("vss->v", local_rdms(
                spec, BatchedState(t, m))).to(cdtype)).sum()
            for t, m in zip(tensors, messages)])
        messages, log_se = _pair_normalize(mesh, bond_buckets, messages,
                                           log_dtype=cdtype)
        zbp = torch.exp(log_zv[0] - log_se[0])
        tensors = _vertex_normalize(spec, tensors, messages)
        ext = [BatchedState(t, m) for t, m in zip(
            _halo_extend(mesh, plan.send, tensors, left),
            _halo_extend(mesh, plan.send, messages, left))]
        flat = plan.weights(mesh, spec, ext)
        corr = (torch.zeros((), dtype=cdtype, device=mesh.devices[0])
                if flat is None else _series(flat[0], plan.groups[0]))
        return (zbp * (1 + corr)).to(cdtype)

    return z_fn


def make_sharded_loopcorrected_expectations(
    sspec: ShardedBPSpec,
    mesh: ShardMesh,
    g,
    observables,
    max_configuration_size: int = 4,
    axis: str = "v",
):
    """``fn(sstate) -> [n_obs]`` of loop-corrected ⟨O⟩ on the sharded state
    — the SPMD counterpart of `loopcorrection.
    make_loopcorrected_expectations` (same norm-fixed-point series),
    on the mesh's first device.

    Everything runs in the rescaled gauge (z_v = s_e = 1, so Z_BP drops
    out of the ratio) with the halo discipline of
    :func:`make_sharded_loopcorrections`; per observable the site
    operators absorb into the owner shard's ket rows before the halo, the
    op-anchored numerator components run the weight kernels with the
    distinct bra layer on the extended state, and each op scalar is
    replicated with one ``psum``."""
    from ..measure import collectobservable
    from ..models.sites import op_matrix

    check_mesh(sspec, mesh, axis)
    spec = sspec.spec
    S = sspec.num_shards
    Vl = spec.num_vertices // S
    den = _LoopPlan(mesh, sspec, LoopConfigurations(
        spec, g, max_configuration_size))

    parsed = []
    for obs in observables:
        op_strings, verts, coeff = collectobservable(obs, g)
        iv = [spec.vertex_position(v) for v in verts]
        cfgs_num = LoopConfigurations(
            spec, g, max_configuration_size,
            allowed_leaves=verts, op_positions=iv,
        )
        num = _LoopPlan(mesh, sspec, cfgs_num)
        # per op: (string, owner shard, owner-local row)
        ops = [(o, p // Vl, p % Vl) for o, p in zip(op_strings, iv)]
        cov = ({} if cfgs_num.op_covered is None else
               {n: [torch.as_tensor(np.asarray(c), device=d)
                    for d in mesh.devices]
                for n, c in cfgs_num.op_covered.items()})
        parsed.append((ops, coeff, num, cov))

    bond_buckets = strip_bond_buckets(sspec, mesh, axis)
    left = (axis, mesh.ring(axis, -1))

    def _numer_series(flat, groups, cov, z_ops):
        """Π z_op + Σ_configs Π w × Π_{op ∉ config} z_op."""
        total = torch.prod(z_ops)
        one = torch.ones((), dtype=z_ops.dtype, device=z_ops.device)
        for n, gidx in groups.items():
            w = torch.prod(flat[gidx], dim=1).to(z_ops.dtype)
            if n in cov:
                w = w * torch.prod(torch.where(cov[n], one, z_ops[None, :]),
                                   dim=1)
            total = total + w.sum()
        return total

    def expect_fn(sstate: ShardedState):
        tensors, messages = sstate.tensors, sstate.messages
        cdtype = torch.promote_types(tensors[0].dtype, torch.complex64)
        d = tensors[0].shape[-1]
        dev0 = mesh.devices[0]

        messages, _ = _pair_normalize(mesh, bond_buckets, messages)
        tensors = _vertex_normalize(spec, tensors, messages)

        # denominator series (leaf-free, plain sandwich)
        ext = [BatchedState(t, m) for t, m in zip(
            _halo_extend(mesh, den.send, tensors, left),
            _halo_extend(mesh, den.send, messages, left))]
        flat = den.weights(mesh, spec, ext)
        denom = torch.ones((), dtype=cdtype, device=dev0)
        if flat is not None:
            denom = denom + _series(flat[0], den.groups[0]).to(cdtype)

        # numerators
        bra = [t.to(cdtype).conj() for t in tensors]
        m_c = [m.to(cdtype) for m in messages]
        outs = []
        for ops, coeff, num, cov in parsed:
            t_num = [t.to(cdtype) for t in tensors]
            for o, s, row in ops:
                if o in ("I", "Id"):
                    continue
                mat = torch.as_tensor(op_matrix(o, d)).to(
                    dtype=cdtype, device=mesh.devices[s])
                new = torch.einsum("...s,ps->...p", t_num[s][row], mat)
                t_num[s] = t_num[s].index_copy(
                    0, _long([row], mesh.devices[s]), new[None])
            # replicated op scalars (one psum each)
            zv = [_sandwich_vertex_scalars(t, b, m)
                  for t, b, m in zip(t_num, bra, m_c)]
            z_ops = []
            for o, s, row in ops:
                part = [torch.zeros((), dtype=cdtype, device=dv)
                        for dv in mesh.devices]
                part[s] = zv[s][row]
                z_ops.append(mesh.psum(part)[0])
            z_ops = torch.stack(z_ops)
            ext = [BatchedState(t, m) for t, m in zip(
                _halo_extend(mesh, num.send, t_num, left),
                _halo_extend(mesh, num.send, m_c, left))]
            bra_ext = _halo_extend(mesh, num.send, bra, left)
            flat = num.weights(mesh, spec, ext, bra_ext)
            if flat is None:
                numer = torch.prod(z_ops)
            else:
                numer = _numer_series(flat[0], num.groups[0],
                                      {n: c[0] for n, c in cov.items()},
                                      z_ops)
            outs.append(coeff * numer / denom)
        return torch.stack(outs)

    return expect_fn
