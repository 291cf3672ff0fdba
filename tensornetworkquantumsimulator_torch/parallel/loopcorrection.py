"""Batched loop corrections to BP on the PyTorch engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
loopcorrection`` (`src/MessagePassing/loopcorrection.jl`), covering the full
leaf-free configuration space at `max_configuration_size` parity with the
reference: simple cycles of any length, disjoint unions of cycles, and
branch-vertex components (thetas, figure-8s — see ``LoopConfigurations``
below).  The dominant lattice case, a single cycle, is an identical
dense computation per configuration

    w = Tr( E₀ A₀₁ E₁ A₁₂ E₂ A₂₃ E₃ A₃₀ )

where Eᵢ is the site transfer matrix of loop vertex i (all incoming BP
messages absorbed except on the two loop bonds) and A is the antiprojector
δ − m_e ⊗ m_ē at the BP fixed point (`loopcorrection.jl:19-63`), evaluated
on the *rescaled* cache (messages pair-normalized, vertices normalized —
`abstractbeliefpropagationcache.jl:269-291`).  Configurations sharing a slot
signature are batched into one chain of [P, χ², χ²] products.

The enumeration and bucketing (:class:`LoopConfigurations`,
:func:`find_plaquettes`) are host code and build the same tables as the JAX
package; the weights are einsums and batched matrix products on the state's
device.  No kernel of the port runs here.  ``jit=True`` has no meaning in
eager PyTorch: the flag is accepted and one implementation serves both
values.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import BatchedState, _absorb, _LETTERS, local_rdms
from .structure import BatchedGraphSpec


def _ix(idx, device) -> torch.Tensor:
    """Host vertex positions as a device index tensor."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device)
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def _edge_index(spec: BatchedGraphSpec, device) -> torch.Tensor:
    return _ix(np.asarray(spec.edges, dtype=np.int64).reshape(-1, 4), device)


# ---------------------------------------------------------------------------
# scalars and rescaling (`abstractbeliefpropagationcache.jl:252-291`)
# ---------------------------------------------------------------------------


def vertex_scalars(spec: BatchedGraphSpec, state: BatchedState) -> torch.Tensor:
    """z_v = contraction of the local norm factors with all incoming
    messages (`abstractbeliefpropagationcache.jl:21-27`), for every vertex."""
    rho = local_rdms(spec, state)  # [V, s, s']
    return torch.einsum("vss->v", rho)


def edge_scalars(spec: BatchedGraphSpec, state: BatchedState) -> torch.Tensor:
    """s_e = ⟨m_e, m_ē⟩ per edge (`beliefpropagationcache.jl:129-142`):
    both directions' messages live in the bond's (ket, bra) basis, so the
    pair scalar is the plain entrywise contraction."""
    edges = _edge_index(spec, state.messages.device)  # [E, 4] (iu, iv, su, sv)
    m_at_v = state.messages[edges[:, 1], edges[:, 3]]  # arriving at v (from u)
    m_at_u = state.messages[edges[:, 0], edges[:, 2]]  # arriving at u (from v)
    return torch.einsum("eab,eab->e", m_at_v, m_at_u)


def batched_partitionfunction(spec: BatchedGraphSpec, state: BatchedState):
    """Z_BP = Π_v z_v / Π_e s_e (`abstractbeliefpropagationcache.jl:252-267`,
    exp of the free energy), as a 0-dim complex tensor on the state's
    device (principal logarithms)."""
    cdtype = torch.promote_types(state.tensors.dtype, torch.complex64)
    zv = vertex_scalars(spec, state).to(cdtype)
    se = edge_scalars(spec, state).to(cdtype)
    return torch.exp(torch.log(zv).sum() - torch.log(se).sum())


def rescale(spec: BatchedGraphSpec, state: BatchedState) -> BatchedState:
    """Pair-normalize the messages (⟨m_e, m_ē⟩ = 1) then normalize each
    vertex so z_v = 1 — the batched equivalent of cache.rescale()
    (`abstractbeliefpropagationcache.jl:269-291`, messages
    `beliefpropagationcache.jl:129-142`).  Complex square roots carry the
    reference's sign handling (principal roots).  Out of place: each
    directed slot of an edge is scaled once, through a [V, D] table of
    factors."""
    edges = _edge_index(spec, state.messages.device)
    se = edge_scalars(spec, state)
    inv_root = 1.0 / torch.sqrt(se.to(state.messages.dtype))
    V, D = state.messages.shape[:2]
    scale = torch.ones((V, D), dtype=state.messages.dtype,
                       device=state.messages.device)
    scale = scale.index_put((edges[:, 1], edges[:, 3]), inv_root)
    scale = scale.index_put((edges[:, 0], edges[:, 2]), inv_root)
    state = BatchedState(state.tensors, state.messages * scale[..., None, None])

    zv = vertex_scalars(spec, state)
    vscale = 1.0 / torch.sqrt(zv.to(state.tensors.dtype))
    tensors = state.tensors * vscale.reshape(
        (-1,) + (1,) * (state.tensors.ndim - 1))
    return BatchedState(tensors, state.messages)


# ---------------------------------------------------------------------------
# plaquette discovery (host side)
# ---------------------------------------------------------------------------


def _slot_between(nbr, mask, iu: int, iv: int) -> int:
    for k in range(nbr.shape[1]):
        if mask[iu, k] and nbr[iu, k] == iv:
            return k
    raise ValueError(f"no bond between vertex positions {iu} and {iv}")


def find_plaquettes(spec: BatchedGraphSpec, g) -> list:
    """Chordless 4-cycles as slot-signature buckets.

    Returns a list of (signature, idx_array[P, 4], slots (4, 2)) where
    slots[i] = (slot to previous loop vertex, slot to next) for loop
    position i; plaquettes sharing a signature run as one batched chain."""
    from ..utils.graphs import unique_simplecycles_limited_length

    pos = {v: i for i, v in enumerate(spec.vertices)}
    nbr = spec.nbr_array()
    mask = spec.mask_array()
    buckets: dict = {}
    for cycle in unique_simplecycles_limited_length(g, 4):
        if len(cycle) != 4:
            continue
        ivs = [pos[v] for v in cycle]
        # chordless check (grids always pass; guards generic graphs)
        if any(
            mask[ivs[i], k] and nbr[ivs[i], k] == ivs[(i + 2) % 4]
            for i in range(2)
            for k in range(nbr.shape[1])
        ):
            continue
        slots = []
        for i in range(4):
            prev_i, next_i = ivs[(i - 1) % 4], ivs[(i + 1) % 4]
            slots.append(
                (
                    _slot_between(nbr, mask, ivs[i], prev_i),
                    _slot_between(nbr, mask, ivs[i], next_i),
                )
            )
        sig = tuple(slots)
        buckets.setdefault(sig, []).append(ivs)
    return [
        (sig, np.asarray(ivs_list, dtype=np.int32), sig)
        for sig, ivs_list in sorted(buckets.items())
    ]


# ---------------------------------------------------------------------------
# plaquette weights
# ---------------------------------------------------------------------------


def _branch_transfer(state: BatchedState, idx, open_slots, bra_conj=None):
    """Site transfer tensor with ``len(open_slots)`` loop bonds left open:
    ψ ψ̄ with incoming messages absorbed on every other slot.  Output is
    [P, χ², ..., χ²] with one flattened (ket, bra) pair per open slot, in
    ``open_slots`` order — the degree-≥3 generalization of
    :func:`_pair_transfer` for branch vertices of theta/figure-8
    configurations (`loopcorrection.jl:81-91`).  ``bra_conj`` optionally
    supplies a distinct (pre-conjugated) bra layer — the numerator
    sandwich of loop-corrected expectations."""
    D = state.degree
    idx = _ix(idx, state.tensors.device)
    t = state.tensors[idx]
    bc = t.conj() if bra_conj is None else bra_conj[idx]
    m = state.messages[idx]
    acc = t
    for k in range(D):
        if k not in open_slots:
            acc = _absorb(acc, m[:, k], 1 + k)
    lab = [_LETTERS[k] for k in range(D)]
    acc_lab, conj_lab = list(lab), list(lab)
    extra = iter(_LETTERS[D:])
    out = []
    for s in open_slots:
        a, b = next(extra), next(extra)
        acc_lab[s] = a
        conj_lab[s] = b
        out += [a, b]
    eq = f"v{''.join(acc_lab)}s,v{''.join(conj_lab)}s->v{''.join(out)}"
    e = torch.einsum(eq, acc, bc)
    chi = state.chi
    return e.reshape((e.shape[0],) + (chi * chi,) * len(open_slots))


def _pair_transfer(state: BatchedState, idx, slot_prev: int, slot_next: int,
                   bra_conj=None):
    """E[(k_prev a, bra b), (k_next c, bra d)] at the given vertices: ψ ψ̄
    with incoming messages absorbed on every slot except the two loop
    bonds (the batched form of the loop-vertex factors in
    `loopcorrection.jl:81-91`).  ``bra_conj`` as in
    :func:`_branch_transfer`."""
    D = state.degree
    idx = _ix(idx, state.tensors.device)
    t = state.tensors[idx]
    bc = t.conj() if bra_conj is None else bra_conj[idx]
    m = state.messages[idx]
    acc = t
    for k in range(D):
        if k != slot_prev and k != slot_next:
            acc = _absorb(acc, m[:, k], 1 + k)
    lab = [_LETTERS[k] for k in range(D)]
    acc_lab = list(lab)
    acc_lab[slot_prev] = "p"
    acc_lab[slot_next] = "r"
    conj_lab = list(lab)
    conj_lab[slot_prev] = "q"
    conj_lab[slot_next] = "t"
    eq = f"v{''.join(acc_lab)}s,v{''.join(conj_lab)}s->vpqrt"
    e = torch.einsum(eq, acc, bc)
    chi = e.shape[1]
    return e.reshape(e.shape[0], chi * chi, chi * chi)  # [(pq), (rt)]


def _bucket_weights(spec: BatchedGraphSpec, state: BatchedState, idx, slots,
                    bra_conj=None):
    """w for all length-L cycles of one slot signature:
    Tr Π_i (E_i · A_{i,i+1}).

    The antiprojector on loop edge v_i → v_{i+1} is
    A[(a,b),(a',b')] = δ_{aa'} δ_{bb'} − m̄[a,b] · m[a',b'] with
    m = message arriving at v_{i+1} (kept, "row") and m̄ = message arriving
    at v_i (sim'd side, "column") — `loopcorrection.jl:19-63`."""
    chi = state.chi
    idx = _ix(idx, state.tensors.device)
    L = idx.shape[1]
    es = []  # transfer matrices per loop position
    for i in range(L):
        es.append(
            _pair_transfer(
                state, idx[:, i], slots[i][0], slots[i][1], bra_conj
            )
        )

    def anti(i):
        j = (i + 1) % L
        # slot on v_j pointing back to v_i:
        return _antiprojector(state, idx[:, i], slots[i][1], idx[:, j],
                              slots[j][0])

    w = es[0]
    for i in range(L):
        w = torch.bmm(w, anti(i))
        if i < L - 1:
            w = torch.bmm(w, es[i + 1])
    return torch.diagonal(w, dim1=-2, dim2=-1).sum(-1)


def _antiprojector(state: BatchedState, idx_a, slot_a, idx_b, slot_b):
    """A = δ − m̄ ⊗ m on the loop edge a → b, rows on a's side
    (`loopcorrection.jl:19-63`; same convention as ``anti`` in
    :func:`_bucket_weights`): m̄ arrives at a through ``slot_a`` (from b),
    m arrives at b through ``slot_b`` (from a)."""
    chi = state.chi
    m_bwd = state.messages[idx_a, slot_a]
    m_fwd = state.messages[idx_b, slot_b]
    outer = torch.einsum("Pab,Pcd->Pabcd", m_bwd, m_fwd).reshape(
        m_bwd.shape[0], chi * chi, chi * chi)
    eye = torch.eye(chi * chi, dtype=state.tensors.dtype,
                    device=state.tensors.device)
    return eye[None] - outer


def _general_weights(spec: BatchedGraphSpec, state: BatchedState, idx, sig,
                     bra_conj=None):
    """Weights of P isomorphic general (branch-vertex) loop components.

    ``sig = (branch_slots, path_sigs)`` (see :class:`LoopConfigurations`):
    the component is a multigraph of branch vertices (loop-degree ≥ 3)
    joined by paths of degree-2 vertices.  Each path contracts to a
    [χ², χ²] matrix  A(u→x₁) E_{x₁} A(x₁→x₂) … E_{x_k} A(x_k→w)  and the
    component weight is one small einsum of the branch transfer tensors
    with the path matrices — the batched counterpart of the generic
    engine's free-form contraction (`loopcorrection.jl:81-91`)."""
    branch_slots, path_sigs = sig
    idx = _ix(idx, state.tensors.device)
    n_branch = len(branch_slots)
    b_tensors = [
        _branch_transfer(state, idx[:, bi], list(slots), bra_conj)
        for bi, slots in enumerate(branch_slots)
    ]
    port_letter = [dict() for _ in range(n_branch)]
    letters = iter(_LETTERS)
    operands, subs = [], []
    for (u_id, su, w_id, sw, interior) in path_sigs:
        # vertex-position columns for this path's interior are encoded in
        # the signature as absolute column indices
        p = None
        a_from, s_from = idx[:, u_id], su
        for (col, s_prev, s_next) in interior:
            a = _antiprojector(state, a_from, s_from, idx[:, col], s_prev)
            p = a if p is None else torch.bmm(p, a)
            e = _pair_transfer(state, idx[:, col], s_prev, s_next, bra_conj)
            p = torch.bmm(p, e)
            a_from, s_from = idx[:, col], s_next
        a = _antiprojector(state, a_from, s_from, idx[:, w_id], sw)
        p = a if p is None else torch.bmm(p, a)
        r, c = next(letters), next(letters)
        port_letter[u_id][su] = r
        port_letter[w_id][sw] = c
        operands.append(p)
        subs.append(f"P{r}{c}")
    for bi, slots in enumerate(branch_slots):
        operands.append(b_tensors[bi])
        subs.append("P" + "".join(port_letter[bi][s] for s in slots))
    return torch.einsum(",".join(subs) + "->P", *operands)


def loop_weights(spec: BatchedGraphSpec, state: BatchedState,
                 plaquettes) -> torch.Tensor:
    """Weights of every plaquette configuration on a *rescaled* state."""
    ws = []
    for _sig, idx, slots in plaquettes:
        ws.append(_bucket_weights(spec, state, idx, slots))
    if not ws:
        return torch.zeros((0,), dtype=state.tensors.dtype,
                           device=state.tensors.device)
    return torch.cat(ws)


# ---------------------------------------------------------------------------
# general loop configurations (cycles of any length + disjoint unions)
# ---------------------------------------------------------------------------


def _cycle_ivs(nxg, comp, pos):
    """Vertex-position sequence of a loop-degree-2 cycle component."""
    start = comp[0]
    seq = [start]
    prev, cur = None, start
    while True:
        nxt = [w for w in nxg.neighbors(cur) if w != prev][0]
        if nxt == start:
            break
        seq.append(nxt)
        prev, cur = cur, nxt
    return [pos[v] for v in seq]


def _general_structure(nxg, comp, pos, nbr, mask):
    """Deterministic (signature, vertex positions) for a component with
    branch vertices (loop-degree ≥ 3) and/or terminal vertices
    (loop-degree 1 — allowed only at observable vertices, the op-anchored
    excitation components of the numerator series; a terminal is just a
    one-port "branch" here).

    The walk is driven purely by slot numbers (start at the minimal-position
    branch vertex, explore ports in ascending slot order), so translated
    copies of the same motif on a regular lattice produce identical
    signatures and batch into one contraction.

    signature = (branch_open_slots, path_sigs) with
      branch_open_slots[b] = ascending slots of branch b's loop bonds,
      path_sigs entry = (u_id, slot_u, w_id, slot_w,
                         ((idx column, slot_prev, slot_next), ...))
    vertex positions = branches in discovery order, then path interiors in
    discovery order (matching the idx-column references in path_sigs)."""

    def slot(a, b):
        return _slot_between(nbr, mask, pos[a], pos[b])

    deg = {v: nxg.degree(v) for v in comp}
    branches = [v for v in comp if deg[v] != 2]  # junctions and terminals
    start = min(branches, key=lambda v: pos[v])
    b_id = {start: 0}
    b_order = [start]
    queue = [start]
    visited = set()
    interior_verts: list = []
    path_sigs: list = []
    n_branch = len(branches)
    while queue:
        u = queue.pop(0)
        for nb in sorted(nxg.neighbors(u), key=lambda x: slot(u, x)):
            if frozenset((u, nb)) in visited:
                continue
            su = slot(u, nb)
            visited.add(frozenset((u, nb)))
            prev, cur = u, nb
            interior = []
            while deg[cur] == 2:
                nxt = [w for w in nxg.neighbors(cur) if w != prev][0]
                col = n_branch + len(interior_verts)
                interior.append((col, slot(cur, prev), slot(cur, nxt)))
                interior_verts.append(cur)
                visited.add(frozenset((cur, nxt)))
                prev, cur = cur, nxt
            w = cur
            if w not in b_id:
                b_id[w] = len(b_order)
                b_order.append(w)
                queue.append(w)
            path_sigs.append((b_id[u], su, b_id[w], slot(w, prev), tuple(interior)))
    branch_open_slots = tuple(
        tuple(sorted(slot(b, x) for x in nxg.neighbors(b))) for b in b_order
    )
    sig = (branch_open_slots, tuple(path_sigs))
    ivs = [pos[v] for v in b_order] + [pos[v] for v in interior_verts]
    return sig, ivs


class LoopConfigurations:
    """Host-compiled loop-correction structure up to ``max_size`` edges.

    Mirrors `loopcorrection.jl:3-16`'s `edgeinduced_subgraphs_no_leaves`
    enumeration in full: configurations are vertex-disjoint unions of
    leaf-free connected components, and each configuration's weight
    factorizes into the product of its component weights.  Components fall
    into two batched classes:

    - *simple cycles* (every component vertex of loop-degree 2): plaquettes,
      dominoes, heavy-hex 12-cycles — a [χ², χ²] transfer-matrix chain trace
      (``_bucket_weights``);
    - *general components* with branch vertices of loop-degree ≥ 3 (thetas —
      two plaquettes sharing an edge, 7 edges on grids; figure-8s — two
      plaquettes sharing a vertex): a multigraph of branch vertices joined
      by degree-2 paths, contracted by ``_general_weights``.

    ``buckets``: [(idx [P, L], slots (L, 2))] per (length, slot-signature)
    for the cycle class; ``general_buckets``: [(idx [P, n_verts], sig)] per
    branch-structure signature; ``groups``: {n_components:
    [n_configs, n_components] indices into the flat weight vector (cycle
    buckets first, then general buckets)}.  ``n_skipped`` is retained for
    API compatibility and is always 0.  The tables are numpy arrays equal
    to the JAX package's; the sums move them to the weights' device once
    per device.
    """

    def __init__(self, spec: BatchedGraphSpec, g, max_size: int,
                 allowed_leaves=(), op_positions=None):
        import networkx as nx

        from ..utils.graphs import edgeinduced_subgraphs_no_leaves

        pos = {v: i for i, v in enumerate(spec.vertices)}
        nbr = spec.nbr_array()
        mask = spec.mask_array()

        comp_of_key: dict = {}  # frozenset(frozenset edge) -> component id
        comp_desc: list = []  # id -> ("cycle", ivs) | ("general", sig, ivs)
        configs: list = []
        for sub in edgeinduced_subgraphs_no_leaves(
            g, max_size, allowed_leaves=allowed_leaves
        ):
            nxg = sub.nx()
            comp_ids = []
            for comp in nx.connected_components(nxg):
                comp = list(comp)
                comp_edges = frozenset(
                    frozenset((u, v)) for u, v in nxg.edges(comp)
                )
                if comp_edges not in comp_of_key:
                    comp_of_key[comp_edges] = len(comp_desc)
                    if all(nxg.degree(v) == 2 for v in comp):
                        comp_desc.append(("cycle", _cycle_ivs(nxg, comp, pos)))
                    else:
                        sig, ivs = _general_structure(nxg, comp, pos, nbr, mask)
                        comp_desc.append(("general", sig, ivs))
                comp_ids.append(comp_of_key[comp_edges])
            configs.append(tuple(sorted(comp_ids)))

        # bucket cycles by (length, slot signature), generals by structure sig
        buckets: dict = {}
        gbuckets: dict = {}
        members: dict = {}  # ("c"|"g", sig) -> component ids, aligned w/ rows
        for cid, desc in enumerate(comp_desc):
            if desc[0] == "cycle":
                ivs = desc[1]
                L = len(ivs)
                slots = tuple(
                    (
                        _slot_between(nbr, mask, ivs[i], ivs[(i - 1) % L]),
                        _slot_between(nbr, mask, ivs[i], ivs[(i + 1) % L]),
                    )
                    for i in range(L)
                )
                buckets.setdefault((L, slots), []).append(ivs)
                members.setdefault(("c", (L, slots)), []).append(cid)
            else:
                _, sig, ivs = desc
                gbuckets.setdefault(sig, []).append(ivs)
                members.setdefault(("g", sig), []).append(cid)

        flat_pos = {}
        k = 0
        self.buckets = []
        for sig in sorted(buckets):
            self.buckets.append(
                (np.asarray(buckets[sig], dtype=np.int32), sig[1])
            )
            for cid in members[("c", sig)]:
                flat_pos[cid] = k
                k += 1
        self.general_buckets = []
        for sig in sorted(gbuckets):
            self.general_buckets.append(
                (np.asarray(gbuckets[sig], dtype=np.int32), sig)
            )
            for cid in members[("g", sig)]:
                flat_pos[cid] = k
                k += 1

        # per-component covered observable positions (numerator series)
        self.op_positions = (
            None if op_positions is None
            else np.asarray(list(op_positions), dtype=np.int32)
        )
        comp_cover = None
        if self.op_positions is not None:
            opset = {int(p): k for k, p in enumerate(self.op_positions)}
            comp_cover = []
            for desc in comp_desc:
                ivs = desc[1] if desc[0] == "cycle" else desc[2]
                comp_cover.append(
                    frozenset(opset[i] for i in ivs if i in opset)
                )

        self.groups = {}
        self.op_covered = {} if comp_cover is not None else None
        for cfg in configs:
            n = len(cfg)
            self.groups.setdefault(n, []).append(
                [flat_pos[c] for c in cfg]
            )
            if comp_cover is not None:
                cov = np.zeros(len(self.op_positions), dtype=bool)
                for c in cfg:
                    for k in comp_cover[c]:
                        cov[k] = True
                self.op_covered.setdefault(n, []).append(cov)
        self.groups = {
            n: np.asarray(lst, dtype=np.int32)
            for n, lst in sorted(self.groups.items())
        }
        if self.op_covered is not None:
            self.op_covered = {
                n: np.asarray(lst, dtype=bool)
                for n, lst in sorted(self.op_covered.items())
            }
        self.n_configurations = len(configs)
        self.n_skipped = 0
        self._on_device: dict = {}

    def device_tables(self, device) -> dict:
        """The index tables as tensors on ``device``, built once per device:
        ``buckets`` / ``general_buckets`` with device indices, ``groups`` and
        ``op_covered``."""
        device = torch.device(device)
        tabs = self._on_device.get(device)
        if tabs is None:
            tabs = {
                "buckets": [(_ix(i, device), s) for i, s in self.buckets],
                "general_buckets": [(_ix(i, device), s)
                                    for i, s in self.general_buckets],
                "groups": {n: _ix(i, device) for n, i in self.groups.items()},
                "op_covered": None if self.op_covered is None else {
                    n: torch.as_tensor(c, device=device)
                    for n, c in self.op_covered.items()},
            }
            self._on_device[device] = tabs
        return tabs

    def correction_sum(self, weights: torch.Tensor) -> torch.Tensor:
        """Σ_configs Π_components w — the loop series' correction term."""
        groups = self.device_tables(weights.device)["groups"]
        total = torch.zeros((), dtype=weights.dtype, device=weights.device)
        for _n, idx in groups.items():
            total = total + torch.prod(weights[idx], dim=1).sum()
        return total

    def numerator_sum(self, weights: torch.Tensor,
                      z_ops: torch.Tensor) -> torch.Tensor:
        """Σ_configs Π_components w × Π_{op ∉ config} z_op, PLUS the empty
        configuration's Π z_op — the numerator series of a loop-corrected
        expectation (requires ``op_positions`` at construction): an
        observable vertex outside a configuration contributes its local
        op-inserted BP scalar."""
        if self.op_covered is None:
            raise ValueError("built without op_positions")
        tabs = self.device_tables(weights.device)
        z_ops = z_ops.to(weights.dtype)
        one = torch.ones((), dtype=weights.dtype, device=weights.device)
        total = torch.prod(z_ops)
        for n, idx in tabs["groups"].items():
            w = torch.prod(weights[idx], dim=1)
            mult = torch.prod(
                torch.where(tabs["op_covered"][n], one, z_ops[None, :]),
                dim=1,
            )
            total = total + (w * mult).sum()
        return total


def _configuration_weights(spec, state, configurations, bra_conj=None):
    """The flat weight vector of every component of ``configurations``
    (cycle buckets first, then general buckets), or None if there is none."""
    tabs = configurations.device_tables(state.tensors.device)
    ws = []
    for idx, slots in tabs["buckets"]:
        ws.append(_bucket_weights(spec, state, idx, slots, bra_conj))
    for idx, sig in tabs["general_buckets"]:
        ws.append(_general_weights(spec, state, idx, sig, bra_conj))
    if not ws:
        return None
    return torch.cat(ws)


def loopcorrected_partitionfunction(
    spec: BatchedGraphSpec,
    state: BatchedState,
    g,
    plaquettes=None,
    max_configuration_size: int | None = None,
    configurations: LoopConfigurations | None = None,
):
    """Z ≈ Z_BP · (1 + Σ_configurations Π_cycles w) (`loopcorrection.jl:3-16`),
    batched.

    Default: plaquette (4-cycle) corrections only.  Pass
    ``max_configuration_size`` (or a precompiled
    ``configurations=LoopConfigurations(spec, g, n)`` to amortize the
    host-side enumeration) for the reference's full series over cycle-type
    configurations up to that edge count — grid dominoes, heavy-hex
    12-cycles, disjoint plaquette pairs, ….  ``g`` is the NamedGraph the
    spec was compiled from."""
    zbp = batched_partitionfunction(spec, state)
    rescaled = rescale(spec, state)
    if configurations is None and max_configuration_size is not None:
        configurations = LoopConfigurations(spec, g, max_configuration_size)
    if configurations is not None:
        weights = _configuration_weights(spec, rescaled, configurations)
        if weights is None:
            return zbp
        return zbp * (1 + configurations.correction_sum(weights))
    if plaquettes is None:
        plaquettes = find_plaquettes(spec, g)
    ws = loop_weights(spec, rescaled, plaquettes)
    return zbp * (1 + ws.sum())


# ---------------------------------------------------------------------------
# loop-corrected expectations: numerator Z from the op-inserted sandwich,
# denominator from the norm network, both with the full leaf-free
# configuration series (`expect.jl` via QuadraticForm +
# `loopcorrection.jl:3-16`)
# ---------------------------------------------------------------------------


def _sandwich_vertex_scalars(t_ket, t_bra_conj, messages):
    """Per-vertex sandwich scalar: all incoming messages absorbed into the
    ket, closed with the (pre-conjugated) bra — z_v^O of the op-inserted
    network at the norm fixed point."""
    D = t_ket.ndim - 2  # [V, chi*D, d]
    acc = t_ket
    for k in range(D):
        acc = _absorb(acc, messages[:, k], 1 + k)
    lab = "".join(_LETTERS[k] for k in range(D))
    return torch.einsum(f"v{lab}s,v{lab}s->v", acc, t_bra_conj)


def make_loopcorrected_expectations(
    spec: BatchedGraphSpec,
    g,
    observables,
    *,
    max_configuration_size: int = 4,
    jit: bool = True,
):
    """``fn(state) -> [n_obs]`` of loop-corrected ⟨O⟩ = Z_O^loops / Z^loops —
    BP-error-controlled observables, the batched counterpart of
    `measure._expect_loopcorrections` (same norm-fixed-point convention).

    Observables use the generic API shape ``(op_string(s), vertices[,
    coeff])`` (`expect.jl:160-176`).  Everything is evaluated at the
    state's own BP fixed point in the rescaled gauge — no per-observable
    BP re-convergence:

    - denominator = 1 + Σ leaf-free configurations;
    - numerator   = Π z_op + Σ configurations with leaves allowed at the
      observable vertices (op-anchored paths/tadpoles, batched through
      the same cycle/general contractions — a terminal vertex is a
      one-port branch), each times z_op for every uncovered observable
      vertex.

    The per-observable configuration spaces are enumerated once at
    factory time.  ``jit`` is accepted for the reference's signature; the
    eager function is the same for both values."""
    from ..measure import collectobservable
    from ..models.sites import op_matrix

    del jit
    cfgs_den = LoopConfigurations(spec, g, max_configuration_size)
    parsed = []
    # one enumeration per DISTINCT observable vertex set (several ops on
    # the same sites — e.g. X/Y/Z sweeps — share a configuration space)
    cfgs_cache: dict = {}
    for obs in observables:
        op_strings, verts, coeff = collectobservable(obs, g)
        iv = [spec.vertex_position(v) for v in verts]
        key = tuple(iv)  # ordered: op_covered columns align with z_ops
        cfgs_num = cfgs_cache.get(key)
        if cfgs_num is None:
            cfgs_num = LoopConfigurations(
                spec, g, max_configuration_size,
                allowed_leaves=verts, op_positions=iv,
            )
            cfgs_cache[key] = cfgs_num
        parsed.append((tuple(op_strings), tuple(iv), coeff, cfgs_num))

    def fn(state: BatchedState):
        dtype = state.tensors.dtype
        dev = state.tensors.device
        d = state.tensors.shape[-1]
        cdtype = torch.promote_types(dtype, torch.complex64)
        resc = rescale(spec, state)  # z_v = s_e = 1 gauge; Z_BP drops out
        wden = _configuration_weights(spec, resc, cfgs_den,
                                      resc.tensors.conj())
        corr_den = cfgs_den.correction_sum(wden) if wden is not None else 0.0
        denom = torch.as_tensor(1 + corr_den, device=dev).to(cdtype)

        t_resc = resc.tensors.to(cdtype)
        bra_conj = t_resc.conj()
        m_resc = resc.messages.to(cdtype)
        outs = []
        for op_strings, iv, coeff, cfgs_num in parsed:
            if coeff == 0:
                outs.append(torch.zeros((), dtype=cdtype, device=dev))
                continue
            t_num = t_resc
            for o, i in zip(op_strings, iv):
                if o in ("I", "Id"):
                    continue
                mat = torch.as_tensor(op_matrix(o, d), device=dev).to(cdtype)
                row = torch.einsum("...s,ps->...p", t_num[i], mat)
                t_num = t_num.index_copy(0, _ix([i], dev), row[None])
            zv = _sandwich_vertex_scalars(t_num, bra_conj, m_resc)
            z_ops = zv[_ix(iv, dev)]
            wnum = _configuration_weights(
                spec, BatchedState(t_num, m_resc), cfgs_num, bra_conj)
            if wnum is None:
                numer = torch.prod(z_ops)
            else:
                numer = cfgs_num.numerator_sum(wnum, z_ops)
            outs.append(coeff * numer.to(cdtype) / denom)
        return torch.stack(outs)

    return fn
