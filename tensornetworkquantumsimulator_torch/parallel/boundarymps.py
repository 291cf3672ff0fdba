"""Batched boundary-MPS engine for row-partitioned grid states.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
boundarymps`` (`boundarympscache.jl:261-360`): the one-site DMRG-style
fitting sweep that updates an inter-row message strand, with static shapes:
strand tensors live in a fixed ``[W, K, χ, χ, K]`` buffer (K = MPS bond
dimension; (χ, χ) = ket/bra legs of the inter-row lattice bonds) and every
local update is a chain of small einsums.  The reference's scans over
columns and its loop on the cost function are Python loops here, one QR of
a ``[K·χ², K]`` matrix per column and one host read per sweep for the
stopping test: at small K and χ the phase is bound by launches, not by the
device.

Scope: rectangular grids via :class:`GridBMPSSpec`, and any column-aligned
planar lattice (heavy-hex, Lieb, comb trees: every lattice the reference's
`partition_by="row"` handles, `boundarympscache.jl:139-167`) via
:class:`PlanarBMPSSpec`, which realizes the reference's pseudo-planar
bond-1 fill-in edges (`boundarympscache.jl:554-569`) as identity *wire*
tensors on a global column grid.  When vertex names don't provide aligned
columns (integer names, sheared/diagonal couplings), a valid assignment is
derived from the graph structure (:func:`derive_planar_columns`).

Conventions: rows are indexed by the first coordinate; a strand flowing
into row r carries the (ket, bra) pair of the bonds between r-1 and r.
Strand end bonds are kept at size K with content pinned to slice 0.

The Q factors' column phases differ between LAPACK, cuSOLVER and the
reference, so fitted strands agree only up to a gauge: the evaluators'
outputs and the extracted scales λ are what is comparable.
"""

from __future__ import annotations

import numpy as np
import torch

from .structure import BatchedGraphSpec


# ---------------------------------------------------------------------------
# host-side role tables
# ---------------------------------------------------------------------------


class GridBMPSSpec:
    """Axis-role bookkeeping for a nx×ny grid compiled by `compile_graph`."""

    def __init__(self, spec: BatchedGraphSpec, nx: int, ny: int):
        if spec.num_vertices != nx * ny:
            raise ValueError("spec does not match the grid size")
        if spec.degree < 4:
            raise ValueError(
                "grid boundary MPS needs the 4-slot layout (nx, ny >= 3); "
                "strips are not supported"
            )
        self.spec = spec
        self.nx, self.ny = nx, ny
        pos = {v: i for i, v in enumerate(spec.vertices)}
        nbr = spec.nbr_array()
        mask = spec.mask_array()
        D = spec.degree
        # role slots per vertex: [up, down, left, right]; dummies fill the rest
        self.perm = np.zeros((nx * ny, D), dtype=np.int64)
        for r in range(1, nx + 1):
            for c in range(1, ny + 1):
                v = (r, c)
                i = pos[v]
                want = [(r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)]
                slot_of = {}
                for k in range(D):
                    if mask[i, k]:
                        slot_of[spec.vertices[nbr[i, k]]] = k
                dummies = [k for k in range(D) if not mask[i, k]]
                roles = []
                for w in want:
                    if w in slot_of:
                        roles.append(slot_of[w])
                    else:
                        roles.append(dummies.pop())
                # leftover dummies (degree > 4 can't happen on a grid)
                if dummies:
                    raise ValueError("unexpected extra slots on a grid vertex")
                self.perm[i] = roles

    def row_tensors(self, tensors: torch.Tensor, r: int) -> torch.Tensor:
        """[W, u, d, l, rt, s] for row r (0-based)."""
        ny = self.ny
        D = tensors.ndim - 2
        out = []
        for c in range(ny):
            i = r * ny + c
            out.append(tensors[i].permute([int(k) for k in self.perm[i]]
                                          + [D]))
        return torch.stack(out)


def identity_strand(W: int, K: int, chi: int, dtype, device=None):
    """The boundary (vacuum) strand: δ(ket, bra) at MPS-bond slice (0, 0)."""
    m = torch.zeros((W, K, chi, chi, K), dtype=dtype, device=device)
    m[:, 0, :, :, 0] = torch.eye(chi, dtype=dtype, device=device)
    return m


def derive_planar_columns(spec: BatchedGraphSpec, row_of=None) -> dict:
    """Derive a column assignment that makes ``PlanarBMPSSpec`` feasible.

    The reference's boundary-MPS cache needs no column geometry at all: it
    sorts each row and threads pseudo-planar bond-1 edges through the gaps
    (`boundarympscache.jl:554-569`).  The batched engine, by contrast, lays
    rows out on a *global* column grid, so lattices whose vertex names do
    not directly provide aligned columns (integer names from
    ``build_graph_from_circuit``, sheared/diagonal couplings, …) need a
    column assignment derived from the graph structure.  This computes one:

    - inter-row edges force equal columns (union-find groups);
    - each row's induced subgraph must be a disjoint union of paths, whose
      traversal order gives strict ``col`` inequalities along the row;
    - path orientations and the order of a row's components are searched
      (backtracking, small per-lattice) so the resulting constraint digraph
      over groups is acyclic; a topological order then assigns columns.

    Feasibility requires each vertex to carry at most one bond to the row
    above and one to the row below (the reference's MPO strands allow more;
    such lattices are not supported).  Returns ``{vertex: column}``.
    Raises ``ValueError`` when no assignment exists.
    """
    import itertools

    if row_of is None:
        row_of = lambda v: float(v[0])  # noqa: E731
    verts = spec.vertices
    n = len(verts)
    row_vals = sorted({row_of(v) for v in verts})
    r_pos = {k: i for i, k in enumerate(row_vals)}
    row = [r_pos[row_of(v)] for v in verts]
    nrows = len(row_vals)

    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    within = [dict() for _ in range(nrows)]  # row -> {i: [nbrs]}
    up = [None] * n
    down = [None] * n
    for (iu, iv, _su, _sv) in spec.edges:
        ru, rv = row[iu], row[iv]
        if ru == rv:
            within[ru].setdefault(iu, []).append(iv)
            within[ru].setdefault(iv, []).append(iu)
        elif abs(ru - rv) == 1:
            lo, hi = (iu, iv) if ru < rv else (iv, iu)
            if down[lo] is not None or up[hi] is not None:
                raise ValueError(
                    "a vertex has two bonds to one adjacent row: the 4-role "
                    "batched layout cannot host it"
                )
            down[lo], up[hi] = hi, lo
            ra, rb = find(iu), find(iv)
            if ra != rb:
                parent[ra] = rb
        else:
            raise ValueError(
                f"edge {verts[iu]}–{verts[iv]} spans non-adjacent rows under "
                "this row_of: no path partition exists"
            )

    grp = [find(i) for i in range(n)]
    # a column group may hold at most one vertex per row
    seen = {}
    for i in range(n):
        key = (grp[i], row[i])
        if key in seen:
            raise ValueError(
                "two same-row vertices are chained to one column by "
                "inter-row edges: no planar column assignment exists"
            )
        seen[key] = i

    # per-row path components, in deterministic traversal order
    comps = []  # comps[r] = list of vertex-index lists
    for r in range(nrows):
        members = [i for i in range(n) if row[i] == r]
        adj = within[r]
        for i, nb in adj.items():
            if len(nb) > 2:
                raise ValueError(
                    f"row {row_vals[r]} induced subgraph is not a union of "
                    "paths (a vertex has 3 within-row neighbours)"
                )
        unvisited = set(members)
        row_comps = []
        for i in sorted(members):
            if i not in unvisited:
                continue
            if len(adj.get(i, [])) >= 2:
                continue  # start walks at endpoints / singletons only
            walk, prev, cur = [], None, i
            while True:
                walk.append(cur)
                unvisited.discard(cur)
                nxt = [w for w in adj.get(cur, []) if w != prev]
                if not nxt:
                    break
                prev, cur = cur, nxt[0]
            row_comps.append(walk)
        if unvisited:
            raise ValueError(
                f"row {row_vals[r]} induced subgraph contains a cycle: "
                "each partition must be a path (`utils.jl:2-16`)"
            )
        comps.append(row_comps)

    # backtracking over (component order, orientation) per row; the
    # constraint digraph over groups must stay acyclic
    succ = {}  # group -> set of groups that must sit at larger columns

    def acyclic():
        state = {}  # 0=visiting, 1=done

        def dfs(u):
            state[u] = 0
            for w in succ.get(u, ()):
                s = state.get(w)
                if s == 0:
                    return False
                if s is None and not dfs(w):
                    return False
            state[u] = 1
            return True

        return all(state.get(u) == 1 or dfs(u) for u in list(succ))

    budget = [200000]

    def place(r):
        if r == nrows:
            return True
        row_comps = comps[r]
        nperm = 1
        for k in range(2, len(row_comps) + 1):
            nperm *= k
        orders = (
            itertools.permutations(row_comps)
            if nperm <= 720
            else [tuple(row_comps)]  # cap: canonical order only
        )
        for perm in orders:
            orient_opts = [
                ((False, True) if len(c) > 1 else (False,)) for c in perm
            ]
            for orients in itertools.product(*orient_opts):
                budget[0] -= 1
                if budget[0] <= 0:
                    raise ValueError(
                        "column derivation search budget exhausted"
                    )
                chain = []
                for c, o in zip(perm, orients):
                    chain.extend(reversed(c) if o else c)
                new = []
                ok = True
                for a, b in zip(chain, chain[1:]):
                    ga, gb = grp[a], grp[b]
                    if ga == gb:
                        ok = False
                        break
                    new.append((ga, gb))
                if not ok:
                    continue
                added = []
                for ga, gb in new:
                    s = succ.setdefault(ga, set())
                    if gb not in s:
                        s.add(gb)
                        added.append((ga, gb))
                if acyclic() and place(r + 1):
                    return True
                for ga, gb in added:
                    succ[ga].discard(gb)
        return False

    if not place(0):
        raise ValueError(
            "no column assignment found: the lattice is not row-partitionable "
            "into aligned paths"
        )

    # longest-path layering over the group digraph -> compact columns:
    # col(b) = 1 + max col over predecessors satisfies every strict
    # inequality while packing unrelated groups into shared columns (two
    # same-row vertices are always chain-ordered, so they never collide)
    groups = sorted({grp[i] for i in range(n)})
    indeg = {g: 0 for g in groups}
    for u, ws in succ.items():
        for w in ws:
            indeg[w] += 1
    from heapq import heapify, heappop, heappush

    ready = [g for g in groups if indeg[g] == 0]
    heapify(ready)
    order = {}
    done = 0
    while ready:
        u = heappop(ready)
        order.setdefault(u, 0)
        done += 1
        for w in sorted(succ.get(u, ())):
            order[w] = max(order.get(w, 0), order[u] + 1)
            indeg[w] -= 1
            if indeg[w] == 0:
                heappush(ready, w)
    assert done == len(groups)
    return {verts[i]: order[grp[i]] for i in range(n)}


class PlanarBMPSSpec:
    """Column-aligned path-partition spec: batched boundary MPS beyond grids.

    The reference's :class:`BoundaryMPSCache` partitions any planar network
    into rows by one coordinate and fills non-adjacent within-row vertices
    with *pseudo planar edges* of bond dimension 1
    (`boundarympscache.jl:139-167`, `pseudo_planar_edges` `:554-569`) so each
    partition becomes a path.  The static-shape equivalent here: vertices are
    placed on a global (row, column) grid — rows sorted by ``float(v[0])``,
    columns by ``float(v[1])`` — and every empty grid position is filled
    with an identity *wire* tensor δ(left, right) (support pinned to index 0
    on its up/down/site legs).  A wire is exactly a bond-dimension-1
    pseudo-planar vertex: it transports whatever within-row bond passes
    through and is invisible to the inter-row strands, so the grid fitting
    machinery (`_fit_strand`, `_row_scalar_scaled`, `_edge_scalar`) runs
    unchanged on heavy-hex, Lieb, comb-tree, … lattices.

    Requirements (checked): every inter-row edge joins *adjacent* rows at
    *equal* column (true for all shipped lattices, where bridge vertices sit
    at the midpoint column), and within-row edges only cross empty
    positions.  Memory note: row tensors are materialized at the 4-role
    layout [χ,χ,χ,χ,d] regardless of vertex degree, so χ is bounded by device memory
    the same way the grid engine's χ is.
    """

    def __init__(self, spec: BatchedGraphSpec, row_of=None, col_of=None):
        if row_of is None:
            row_of = lambda v: float(v[0])
        if col_of is None:
            # coordinate columns first (all shipped lattices); when the
            # vertex names don't provide aligned columns, derive an
            # assignment from the graph structure (`derive_planar_columns`
            # — the batched analogue of the reference's pseudo-planar
            # fill-in, `boundarympscache.jl:554-569`)
            try:
                self._build(spec, row_of, lambda v: float(v[1]))
                return
            except (ValueError, TypeError, IndexError) as default_err:
                try:
                    cols = derive_planar_columns(spec, row_of)
                except ValueError:
                    raise default_err from None
                self._build(spec, row_of, lambda v: cols[v])
                return
        self._build(spec, row_of, col_of)

    def _build(self, spec: BatchedGraphSpec, row_of, col_of):
        self.spec = spec
        rows = sorted({row_of(v) for v in spec.vertices})
        cols = sorted({col_of(v) for v in spec.vertices})
        self.nrows, self.W = len(rows), len(cols)
        r_pos = {r: i for i, r in enumerate(rows)}
        c_pos = {c: i for i, c in enumerate(cols)}
        # vid[r][c] = vertex position in spec.vertices, or -1 for a wire
        self.vid = -np.ones((self.nrows, self.W), dtype=np.int64)
        self.rowcol = {}  # vertex position -> (r, c)
        for i, v in enumerate(spec.vertices):
            r, c = r_pos[row_of(v)], c_pos[col_of(v)]
            if self.vid[r, c] != -1:
                raise ValueError(f"two vertices at grid position {(r, c)}")
            self.vid[r, c] = i
            self.rowcol[i] = (r, c)
        # role_slot[i] = {role: tensor slot} for roles with real bonds;
        # roles: 0=up, 1=down, 2=left, 3=right
        self.role_slot = [dict() for _ in spec.vertices]
        for (iu, iv, su, sv) in spec.edges:
            (ru, cu), (rv, cv) = self.rowcol[iu], self.rowcol[iv]
            if ru == rv:
                if cu == cv:
                    raise ValueError("self-column edge")
                lo, hi = (iu, iv) if cu < cv else (iv, iu)
                slo, shi = (su, sv) if cu < cv else (sv, su)
                for c in range(min(cu, cv) + 1, max(cu, cv)):
                    if self.vid[ru, c] != -1:
                        raise ValueError(
                            "within-row edge crosses a real vertex: not a "
                            "path partition under this column ordering"
                        )
                roles = ((lo, 3, slo), (hi, 2, shi))
            elif abs(ru - rv) == 1 and cu == cv:
                up, dn = (iu, iv) if ru < rv else (iv, iu)
                sup, sdn = (su, sv) if ru < rv else (sv, su)
                roles = ((up, 1, sup), (dn, 0, sdn))
            else:
                raise ValueError(
                    f"edge {spec.vertices[iu]}–{spec.vertices[iv]} is not "
                    "row-adjacent and column-aligned, so this lattice has "
                    "no batched boundary-MPS path.  Pass row_of=/col_of= "
                    "that place bridge vertices at shared columns (how the "
                    "shipped heavy-hex lattices qualify)"
                )
            for (i, role, slot) in roles:
                if role in self.role_slot[i]:
                    raise ValueError("vertex has two bonds in one direction")
                self.role_slot[i][role] = slot

    def _vertex_block(self, tensors: torch.Tensor, i: int) -> torch.Tensor:
        """tensors[i] rearranged to the [u, d, l, r, s] role layout, missing
        roles carried by free dummy slots or size-1 axes padded to χ."""
        spec = self.spec
        D = spec.degree
        chi = tensors.shape[1]
        mask = spec.mask_array()
        used = set(self.role_slot[i].values())
        free = [k for k in range(D) if k not in used and not mask[i, k]]
        axes, missing = [], []
        for role in range(4):
            if role in self.role_slot[i]:
                axes.append(self.role_slot[i][role])
            elif free:
                axes.append(free.pop())
            else:
                missing.append(role)
        t = tensors[i].permute(axes + [k for k in range(D) if k not in axes]
                               + [D])
        # drop leftover dummy slots (support is at index 0 by construction)
        for _ in range(D - len(axes)):
            t = t[..., 0, :]
        for role in missing:
            t = t.unsqueeze(role)
            # pad pairs run from the last axis backwards
            pad = [0, 0] * (t.ndim - 1 - role) + [0, chi - 1]
            t = torch.nn.functional.pad(t, pad)
        return t  # [χ, χ, χ, χ, d]

    def row_tensors(self, tensors: torch.Tensor, r: int) -> torch.Tensor:
        """[W, u, d, l, rt, s] for row r, wires at empty positions."""
        chi = tensors.shape[1]
        d = tensors.shape[-1]
        wire = torch.zeros((chi,) * 4 + (d,), dtype=tensors.dtype,
                           device=tensors.device)
        wire[0, 0, :, :, 0] = torch.eye(chi, dtype=tensors.dtype,
                                        device=tensors.device)
        out = []
        for c in range(self.W):
            i = int(self.vid[r, c])
            out.append(wire if i < 0 else self._vertex_block(tensors, i))
        return torch.stack(out)


# ---------------------------------------------------------------------------
# fitting sweep
# ---------------------------------------------------------------------------


def _boundary_env(K: int, chi: int, dtype, device) -> torch.Tensor:
    """Environment beyond a strand's end: bonds pinned at slice 0, the dummy
    lattice links paired with δ."""
    env = torch.zeros((K, K, chi, chi), dtype=dtype, device=device)
    env[0, 0] = torch.eye(chi, dtype=dtype, device=device)
    return env


def _flip_row(row: torch.Tensor) -> torch.Tensor:
    """Reverse columns and swap left/right legs: an L→R sweep on the flipped
    arrays is an R→L sweep on the originals."""
    return torch.flip(row, [0]).permute(0, 1, 2, 4, 3, 5)


def _flip_strand(m: torch.Tensor) -> torch.Tensor:
    return torch.flip(m, [0]).permute(0, 4, 2, 3, 1)


# The fits and row scalars bring their environments to unit norm every
# RESCALE_EVERY columns.  A double layer shrinks by about one site's |ψ|²
# per column, so every second column keeps complex64 clear of underflow
# for any state whose columns shrink by less than 1e-19 each.  A rescale
# is three device operations, which these host-dispatch-bound loops pay in
# full: on an H100 the planar Eagle-127 ⟨Z⟩ took 42% longer than without
# rescaling when every column was rescaled, 16% with every second one.
RESCALE_EVERY = 2


def _unit(x, batch_dims: int = 0):
    """(x / ‖x‖, ‖x‖): ``x`` at unit norm over all but its leading
    ``batch_dims`` axes (one per sample), and the norm it had, in ``x``'s
    real precision.  A zero slice stays zero (its norm reads as the
    smallest normal number).  Three device operations; the logarithms of
    a whole loop's norms are taken once, by :func:`_log_sum`."""
    norm = torch.linalg.vector_norm(
        x.reshape(x.shape[:batch_dims] + (-1,)), dim=-1).clamp_min(
            torch.finfo(x.real.dtype).tiny)
    return x / norm.reshape(norm.shape + (1,) * (x.dim() - batch_dims)), norm


def _log_sum(norms):
    """Σ log of a list of norms (each [] or [S]), in float64."""
    return torch.log(torch.stack(norms).double()).sum(0)


def _half_sweep(psi_r, psib_r, m_r, n):
    """One L→R one-site sweep: right environments from the current
    (conjugated) strand, then each column updated and QR-gauged in turn.
    Returns (strand with a normalized final tensor, cost function, λ).

    The environments are brought to unit norm every RESCALE_EVERY columns
    (:func:`_unit`) and their scales carried as float64 logarithms: over a
    long row the environments of a double layer shrink by about one site's
    |ψ|² per column, and in 32 bits they underflow to zero within tens of
    columns (a 164-qubit heavy-hex row of χ=8 reaches 1e-19 in one row).
    The Q factors, the normalized strand and the cost function and λ (from
    the scales, taken together after the sweep) are what they would be
    without the rescaling, up to rounding."""
    W, K = n.shape[0], n.shape[1]
    chi = psi_r.shape[1]
    d_out = n.shape[2]
    one = torch.ones((), dtype=n.real.dtype, device=n.device)

    def rescaled(env, i, steps):
        """env at unit norm every RESCALE_EVERY-th step i; the norm taken
        off (one where none was) joins ``steps``."""
        step = one
        if i % RESCALE_EVERY == RESCALE_EVERY - 1:
            env, step = _unit(env)
        steps.append(step)
        return env

    # r_envs[c] = environment of columns STRICTLY right of c; r_steps[k]
    # the norm taken off it after column W-1-k
    r_envs, r_steps = [None] * W, []
    r_env = _boundary_env(K, chi, n.dtype, n.device)
    for c in range(W - 1, -1, -1):
        r_envs[c] = r_env
        if c == 0:
            break
        x1 = torch.einsum("Bbrt,auvb->Bartuv", r_env, m_r[c])
        x2 = torch.einsum("Bartuv,udlrs->Batvdls", x1, psi_r[c])
        x3 = torch.einsum("Batvdls,vemts->Badelm", x2, psib_r[c])
        r_env = rescaled(torch.einsum("Badelm,AdeB->Aalm", x3, n[c].conj()),
                         W - 1 - c, r_steps)

    l_env = _boundary_env(K, chi, n.dtype, n.device)
    qs, norms, l_steps = [], [], []
    for c in range(W):
        # X1[A,u,l,m,v,b] = L[A,a,l,m] M[a,u,v,b]
        x1 = torch.einsum("Aalm,auvb->Aulmvb", l_env, m_r[c])
        # X2[A,d,m,v,b,r,s] = X1 · ψ[u,d,l,r,s] over (u,l)
        x2 = torch.einsum("Aulmvb,udlrs->Admvbrs", x1, psi_r[c])
        # X3[A,d,e,b,r,t] = X2 · bra[v,e,m,t,s] over (v,m,s)
        x3 = torch.einsum("Admvbrs,vemts->Adebrt", x2, psib_r[c])
        # N_new[A,d,e,B] = X3 · R[B,b,r,t], short of the scales taken off
        # the environments
        n_new = torch.einsum("Adebrt,Bbrt->AdeB", x3, r_envs[c])
        norms.append(torch.linalg.vector_norm(n_new))
        if c == W - 1:
            break
        # QR-move the center rightward (one matrix per call)
        q, _ = torch.linalg.qr(n_new.reshape(K * d_out * d_out, K))
        q = q.reshape(K, d_out, d_out, K)
        qs.append(q)
        # next left env: X3 · conj(q)
        l_env = rescaled(torch.einsum("Adebrt,AdeB->Bbrt", x3, q.conj()), c,
                         l_steps)
    # keep the final (center) tensor unitless: normalize it
    norm = norms[-1]
    last = n_new / torch.where(norm == 0, torch.ones_like(norm), norm)
    # each column's extracted norm at its environments' scales: the log of
    # the left steps before it and of the right steps after it
    zero = torch.zeros(1, dtype=torch.float64, device=n.device)
    log_l, log_r = (torch.cat([zero, torch.log(torch.stack(st).double())
                               .cumsum(0)]) if st else zero
                    for st in (l_steps, r_steps))
    extracted = torch.stack(norms).double() * torch.exp(log_l
                                                        + log_r.flip(0))
    # cf: mean one-site extracted norm (the reference's cost function)
    return (torch.stack(qs + [last]), extracted.mean(),
            extracted[-1].to(norm.dtype))


def _fit_strand(
    psi_row, m_in, n0, niters: int, tolerance=None,
    psi_bra=None, return_scale: bool = False,
):
    """One-site ALS fitting of the outgoing strand N ≈ (row ∘ M_in)
    (`boundarympscache.jl:321-360`).  Returns the fitted strand,
    left-canonical with a normalized final tensor.

    With ``tolerance`` set, sweeps stop early once the mean extracted
    one-site norm stabilizes, the reference's cost-function criterion
    (|cf − prev_cf| < tolerance, `boundarympscache.jl:346-357`), with
    ``niters`` as the cap and one host read per sweep; ``"auto"`` is 1e-8
    for 64-bit scalars and 1e-5 for 32-bit; ``None`` keeps the fixed-sweep
    schedule.

    ``psi_bra`` overrides the bra layer (default ``conj(psi_row)``): the
    cross-row correlator threads operator-inserted rows through it.
    With ``return_scale`` the extracted scale λ = ‖center before
    normalization‖ is returned too: the true image satisfies
    row ∘ M ≈ λ·N with λ real ≥ 0 (the phase stays in the normalized
    center tensor), which makes telescoped λ-ratios exact scalars for
    path contractions across rows."""
    psib_row = psi_row.conj() if psi_bra is None else psi_bra
    flipped = (_flip_row(psi_row), _flip_row(psib_row), _flip_strand(m_in))
    if tolerance == "auto":
        tolerance = (1e-8 if n0.real.dtype == torch.float64 else 1e-5)

    n = n0
    lam = torch.ones((), dtype=n0.real.dtype, device=n0.device)
    prev_cf = 0.0
    for _ in range(niters):
        # proper ALS: alternate L→R and R→L one-site sweeps so the
        # environments on both sides of the update are isometric
        n, _, _ = _half_sweep(psi_row, psib_row, m_in, n)
        nf, cf, lam = _half_sweep(*flipped, _flip_strand(n))
        n = _flip_strand(nf)
        if tolerance is not None:
            cf = float(cf)
            if not abs(cf - prev_cf) > tolerance:
                break
            prev_cf = cf
    return (n, lam) if return_scale else n


# ---------------------------------------------------------------------------
# scalars
# ---------------------------------------------------------------------------


def _edge_scalar(m_up, m_dn):
    """⟨m_e, m_ē⟩ along one inter-row interface
    (`boundarympscache.jl:505-513`); messages are stored un-conjugated and
    the pairing contracts (u, v) directly."""
    K = m_up.shape[1]
    carry = torch.zeros((K, K), dtype=m_up.dtype, device=m_up.device)
    carry[0, 0] = 1.0
    for up, dn in zip(m_up, m_dn):
        x = torch.einsum("aA,auvb->Auvb", carry, up)
        carry = torch.einsum("Auvb,AuvB->bB", x, dn)
    return carry[0, 0]


def _row_scalar_scaled(psi_row, m_up, m_dn, op=None, op_col=None, ops=()):
    """Contract one row with its two incoming strands; optionally insert
    single-site operators at columns (`path_contract`): one via
    ``op``/``op_col``, any number via ``ops=((op, col), …)``; of several at
    one column the last wins.  Returns (value, float64 log-scale), the
    row's scalar being value · exp(log-scale): the carry is brought to
    unit norm every RESCALE_EVERY columns and after the last, so a long row
    does not underflow 32 bits (see :func:`_half_sweep`)."""
    K = m_up.shape[1]
    chi = psi_row.shape[1]
    at_col = {int(col): o for o, col in
              tuple(ops) + (((op, op_col),) if op is not None else ())}
    carry = _boundary_env(K, chi, psi_row.dtype, psi_row.device)
    steps = []
    for c, (psi, up, dn) in enumerate(zip(psi_row, m_up, m_dn)):
        # carry[a_up, a_dn, l, m]
        x = torch.einsum("aqlm,auvb->qlmuvb", carry, up)
        x = torch.einsum("qlmuvb,udlrs->qmvbdrs", x, psi)
        psi_b = psi.conj()
        if c in at_col:
            psi_b = torch.einsum("vemtz,zs->vemts", psi_b,
                                 at_col[c].to(psi.dtype))
        x = torch.einsum("qmvbdrs,vemts->qbdert", x, psi_b)
        carry = torch.einsum("qbdert,qdeQ->bQrt", x, dn)
        if (c % RESCALE_EVERY == RESCALE_EVERY - 1
                or c == len(psi_row) - 1):
            carry, step = _unit(carry)
            steps.append(step)
    # close the right dummy bonds (ket-bra trace) and the strand ends
    return torch.einsum("bQrr->bQ", carry)[0, 0], _log_sum(steps)


def _scaled_ratio(numer, denom):
    """numer / denom of two (value, log-scale) row scalars."""
    return numer[0] / denom[0] * torch.exp(numer[1] - denom[1]).to(
        numer[0].real.dtype)


def _log_abs(scaled):
    """log |value · exp(log-scale)| of a (value, log-scale) row scalar, in
    the value's real dtype."""
    value, log_scale = scaled
    return (torch.log(value.abs()) + log_scale).to(value.real.dtype)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _swap_up_down(row: torch.Tensor) -> torch.Tensor:
    return row.permute(0, 2, 1, 3, 4, 5)


def _strand_fitter(
    row_tensors_fn, nrows: int, W: int, kmps: int, niters: int,
    tolerance="auto",
):
    """Shared bottom-up/top-down strand fitting over any row provider.

    Returns ``(rows, m_up, m_dn, lam_up)``: ``lam_up[r]`` is the scale λ
    extracted by the fit producing ``m_up[r+1]`` (row r ∘ m_up[r] ≈
    λ·m_up[r+1]): the cross-row correlator telescopes ratios of these
    against an op-inserted chain's scales."""

    def _strands(tensors):
        chi = tensors.shape[1]
        vacuum = identity_strand(W, kmps, chi, tensors.dtype, tensors.device)
        rows = [row_tensors_fn(tensors, r) for r in range(nrows)]
        # upward pass: message into row r from r-1 (m_up[r])
        m_up = [vacuum]
        lam_up = []
        for r in range(nrows - 1):
            m, lam = _fit_strand(
                rows[r], m_up[-1], m_up[-1], niters, tolerance,
                return_scale=True,
            )
            m_up.append(m)
            lam_up.append(lam)
        # downward pass: message into row r from r+1 (m_dn[r]); the row
        # tensors need up/down swapped for the sweep direction
        m_dn = [None] * nrows
        m_dn[nrows - 1] = cur = vacuum
        for r in range(nrows - 1, 0, -1):
            cur = _fit_strand(_swap_up_down(rows[r]), cur, cur, niters,
                              tolerance)
            m_dn[r - 1] = cur
        return rows, m_up, m_dn, lam_up

    return _strands


def _make_bmps_fns(
    row_tensors_fn, nrows, W, out_positions, kmps, niters, tolerance="auto"
):
    """(norm_sqr_fn, expect_fn) over any row provider; ``out_positions``
    lists the (row, col) of each output vertex."""
    _strands = _strand_fitter(
        row_tensors_fn, nrows, W, kmps, niters, tolerance
    )

    def norm_sqr_fn(tensors):
        rows, m_up, m_dn, _ = _strands(tensors)
        vals = [_row_scalar_scaled(rows[r], m_up[r], m_dn[r])
                for r in range(nrows)]
        edges = [_edge_scalar(m_up[r + 1], m_dn[r]) for r in range(nrows - 1)]
        log_z = torch.stack([_log_abs(v) for v in vals]).sum()
        phase = torch.angle(torch.stack([v for v, _ in vals])).sum()
        if edges:
            edges = torch.stack(edges)
            log_z = log_z - torch.log(edges.abs()).sum()
            phase = phase - torch.angle(edges).sum()
        return log_z, phase

    def expect_fn(tensors, op):
        rows, m_up, m_dn, _ = _strands(tensors)
        op = torch.as_tensor(op).to(dtype=tensors.dtype,
                                    device=tensors.device)
        denoms = {}
        out = []
        for (r, c) in out_positions:
            if r not in denoms:
                denoms[r] = _row_scalar_scaled(rows[r], m_up[r], m_dn[r])
            numer = _row_scalar_scaled(rows[r], m_up[r], m_dn[r], op=op,
                                       op_col=c)
            out.append(_scaled_ratio(numer, denoms[r]).real)
        return torch.stack(out)

    return norm_sqr_fn, expect_fn


def make_grid_bmps(
    spec: BatchedGraphSpec,
    nx: int,
    ny: int,
    kmps: int,
    niters: int = 15,
    tolerance="auto",
):
    """Build boundary-MPS evaluators for an nx×ny grid state.

    Returns ``(norm_sqr_fn, expect_fn)``:
      - ``norm_sqr_fn(tensors) -> (log_abs_z, phase)``: boundary-MPS ⟨ψ|ψ⟩
      - ``expect_fn(tensors, op) -> [V]``: per-vertex ⟨op⟩ (real part)
    ``tensors`` is the BatchedState tensor array; the results live on its
    device.
    """
    gspec = GridBMPSSpec(spec, nx, ny)
    positions = [(r, c) for r in range(nx) for c in range(ny)]
    return _make_bmps_fns(
        gspec.row_tensors, nx, ny, positions, kmps, niters, tolerance
    )


def make_planar_bmps(
    spec: BatchedGraphSpec,
    kmps: int,
    niters: int = 15,
    row_of=None,
    col_of=None,
    tolerance="auto",
):
    """Boundary-MPS evaluators for any column-aligned planar lattice
    (heavy-hex, Lieb, comb, …): the batched counterpart of the reference's
    general `BoundaryMPSCache` (`boundarympscache.jl:139-194`).

    Returns ``(norm_sqr_fn, expect_fn)`` with ``expect_fn`` output in
    ``spec.vertices`` order."""
    pspec = PlanarBMPSSpec(spec, row_of=row_of, col_of=col_of)
    positions = [pspec.rowcol[i] for i in range(spec.num_vertices)]
    return _make_bmps_fns(
        pspec.row_tensors, pspec.nrows, pspec.W, positions, kmps, niters,
        tolerance,
    )


def _make_bmps_corr_fn(
    row_tensors_fn, nrows, W, kmps, niters, tolerance,
    pair_specs, real_output,
):
    _strands = _strand_fitter(
        row_tensors_fn, nrows, W, kmps, niters, tolerance
    )

    def corr_fn(tensors, op1, op2):
        rows, m_up, m_dn, lam_up = _strands(tensors)
        op1c, op2c = (torch.as_tensor(o).to(dtype=tensors.dtype,
                                            device=tensors.device)
                      for o in (op1, op2))

        def bra_row(r, c, which):
            # bra layer with the op applied at column c: the same ⟨z|O|s⟩
            # convention _row_scalar_scaled uses for insertions
            opm = op1c if which == 0 else op2c
            bra = rows[r].conj().clone()
            bra[c] = torch.einsum("udlrz,zs->udlrs", bra[c], opm)
            return bra

        denoms = {}

        def denom(r):
            if r not in denoms:
                denoms[r] = _row_scalar_scaled(rows[r], m_up[r], m_dn[r])
            return denoms[r]

        # op-inserted upward chains, memoized on the (row, col, op) of
        # the lower insertion so pairs sharing it (e.g. a light-cone
        # column of increasing distances) reuse the fitted prefix.  Each
        # chain entry r holds (strand into row r, ∏ λ_num/λ_den so far):
        # the fits normalize their strands, so the true image scale
        # telescopes as the ratio of op-chain λs to the plain chain's
        # lam_up: everything below the lower row and above the upper
        # row cancels between numerator and denominator exactly.
        chains = {}

        def chain_to(r1, c1, which, r2):
            key = (r1, c1, which)
            if key not in chains:
                m, lam = _fit_strand(
                    rows[r1], m_up[r1], m_up[r1], niters, tolerance,
                    psi_bra=bra_row(r1, c1, which), return_scale=True,
                )
                chains[key] = {r1 + 1: (m, lam / lam_up[r1])}
            ch = chains[key]
            top = max(ch)
            m, ratio = ch[top]
            for r in range(top, r2):
                m, lam = _fit_strand(
                    rows[r], m, m, niters, tolerance, return_scale=True
                )
                ratio = ratio * (lam / lam_up[r])
                ch[r + 1] = (m, ratio)
            return ch[r2]

        out = []
        for kind, pa, pb in pair_specs:
            if kind == "row":
                r, c1 = pa
                _r, c2 = pb
                numer = _row_scalar_scaled(
                    rows[r], m_up[r], m_dn[r], ops=((op1c, c1), (op2c, c2))
                )
                out.append(_scaled_ratio(numer, denom(r)))
            else:
                (r1, c1, w1) = pa
                (r2, c2, w2) = pb
                m_num, ratio = chain_to(r1, c1, w1, r2)
                op_hi = op1c if w2 == 0 else op2c
                numer = _row_scalar_scaled(
                    rows[r2], m_num, m_dn[r2], op=op_hi, op_col=c2
                )
                scaled = _scaled_ratio(numer, denom(r2))
                out.append(ratio.to(scaled.dtype) * scaled)
        vals = torch.stack(out)
        return vals.real if real_output else vals

    return corr_fn


def _pair_positions(spec, positions, pairs):
    """Resolve vertex pairs to row/col pair specs.  Same-row pairs
    contract both ops inside one row scalar; cross-row pairs are tagged
    with which op (0 = op1 at the first vertex, 1 = op2) sits at the
    lower/upper row so `corr_fn` can thread the op-inserted chain."""
    out = []
    for a, b in pairs:
        pa = positions[spec.vertex_position(a)]
        pb = positions[spec.vertex_position(b)]
        if pa == pb:
            raise ValueError(f"pair {(a, b)!r} maps to one position {pa}")
        if pa[0] == pb[0]:
            out.append(("row", pa, pb))
        else:
            lo, hi = sorted([(pa[0], pa[1], 0), (pb[0], pb[1], 1)])
            out.append(("cross", lo, hi))
    return out


def make_grid_bmps_correlations(
    spec: BatchedGraphSpec,
    nx: int,
    ny: int,
    kmps: int,
    pairs,
    niters: int = 15,
    tolerance="auto",
    real_output: bool = False,
):
    """Two-point correlators through the boundary-MPS environment:
    ``corr_fn(tensors, op1, op2) -> [len(pairs)]`` of ⟨op1_a op2_b⟩ for
    arbitrary vertex pairs.

    This is the loop-aware counterpart of the BP path correlator
    (`correlations.make_path_correlation_fn`): the environment comes
    from the fitted strands instead of BP messages, so short-loop
    correlations the BP tree approximation misses are captured
    (`boundarympscache.jl:321-360`, `expect.jl:121-157`).
    Same-row pairs insert both ops into one row scalar; cross-row pairs
    thread a second, op-inserted strand chain from the lower row to the
    upper one, telescoping the fits' extracted scales against the plain
    chain's so all common environment cancels exactly (chains are
    memoized on the lower insertion, so a light-cone column of pairs
    costs one chain)."""
    gspec = GridBMPSSpec(spec, nx, ny)
    positions = [(r, c) for r in range(nx) for c in range(ny)]
    return _make_bmps_corr_fn(
        gspec.row_tensors, nx, ny, kmps, niters, tolerance,
        _pair_positions(spec, positions, pairs), real_output,
    )


def make_planar_bmps_correlations(
    spec: BatchedGraphSpec,
    kmps: int,
    pairs,
    niters: int = 15,
    row_of=None,
    col_of=None,
    tolerance="auto",
    real_output: bool = False,
):
    """Boundary-MPS two-point correlators (same-row and cross-row) for
    any column-aligned planar lattice (heavy-hex, Lieb, comb, …): see
    :func:`make_grid_bmps_correlations`."""
    pspec = PlanarBMPSSpec(spec, row_of=row_of, col_of=col_of)
    positions = [pspec.rowcol[i] for i in range(spec.num_vertices)]
    return _make_bmps_corr_fn(
        pspec.row_tensors, pspec.nrows, pspec.W, kmps, niters,
        tolerance, _pair_positions(spec, positions, pairs), real_output,
    )
