"""A plain BP-gauged simple-update simulator for the benchmark's check.

Written from the method's description (Tindall et al., PRX Quantum 5,
010308 (2024); the simple update of Jiang, Weng and Xiang, PRL 101,
090603 (2008), in the BP gauge), not from the package under test, whose
names and modules it does not import.  The semantics it shares with the
configuration it checks:

- every vertex holds a tensor with ``D = max degree`` bond legs of size χ
  and a physical leg; a missing bond is a leg whose only nonzero index is
  0, with an identity message; a bond that holds k < χ values is padded
  with zeros;
- a message M[v, k] is the environment arriving at v through leg k, a χ×χ
  matrix (ket, bra); flooding BP updates every message at once, hermitizes
  it and divides it by the sum of its entries, and each member stops once
  the mean fidelity distance of its messages to the previous sweep falls
  to the tolerance, or after ``bp_maxiter`` sweeps;
- the simple update of an edge absorbs the square roots of its endpoints'
  other messages, reduces each endpoint by QR, applies the gate, splits by
  the singular values, keeps those whose tail Σσ² over the total exceeds
  ``cutoff`` (at most χ), restores the endpoints with the inverse roots
  (eigenvalues at or below 10·ε·λmax zeroed, ε of the configuration's
  precision), writes the kept values, normalized, as the edge's message,
  and normalizes both tensors;
- ⟨Z⟩ of a site is its one-site density matrix from all its messages.

It computes in complex128.  With ``tf32=True`` every contraction's
operands are rounded to TF32 (10 mantissa bits) first: the control that
the benchmark's limits are set against.  Decompositions stay in
complex128 there, so the control is, if anything, closer to the truth
than a program run at TF32 throughout.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

SMALL_ON_HOST = 64  # eigh on the host's LAPACK up to this n ...
HOST_THREADS = 8  # ... in this many chunks at once (LAPACK drops the GIL)
_POOL = concurrent.futures.ThreadPoolExecutor(HOST_THREADS)

PAULI = {
    "I": np.eye(2),
    "X": np.array([[0, 1], [1, 0]]),
    "Y": np.array([[0, -1j], [1j, 0]]),
    "Z": np.array([[1, 0], [0, -1]]),
}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each real component rounded to TF32 (8 exponent bits, 10
    mantissa bits, round to nearest), in ``x``'s dtype."""
    real = torch.view_as_real(x.resolve_conj()) if x.is_complex() else x
    bits = real.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    out = bits.view(torch.float32).to(real.dtype)
    return torch.view_as_complex(out) if x.is_complex() else out


def pauli_rotation(paulis: str, theta: torch.Tensor, dtype) -> torch.Tensor:
    """exp(-i θ/2 P) for the Pauli string P (P² = I): θ of any shape →
    [..., 2**n, 2**n]."""
    p = np.array([[1.0]])
    for c in paulis:
        p = np.kron(p, PAULI[c])
    p = torch.as_tensor(p, dtype=dtype, device=theta.device)
    half = theta.to(torch.float64) / 2
    eye = torch.eye(p.shape[0], dtype=dtype, device=theta.device)
    return (torch.cos(half)[..., None, None].to(dtype) * eye
            - 1j * torch.sin(half)[..., None, None].to(dtype) * p)


class Lattice:
    """Slot tables of a lattice given as vertex names and an edge list:
    each vertex takes its bonds in the order the edges are listed."""

    def __init__(self, vertices, edges):
        self.vertices = list(vertices)
        self.pos = {v: i for i, v in enumerate(self.vertices)}
        V = len(self.vertices)
        fill = [0] * V
        slots = []
        for u, v in edges:
            iu, iv = self.pos[u], self.pos[v]
            slots.append((iu, iv, fill[iu], fill[iv]))
            fill[iu] += 1
            fill[iv] += 1
        D = max(fill)
        nbr = np.tile(np.arange(V)[:, None], (1, D))
        nbr_slot = np.zeros((V, D), np.int64)
        mask = np.zeros((V, D), bool)
        for iu, iv, su, sv in slots:
            nbr[iu, su], nbr_slot[iu, su], mask[iu, su] = iv, sv, True
            nbr[iv, sv], nbr_slot[iv, sv], mask[iv, sv] = iu, su, True
        self.degree = D
        self.edges = [(u, v) for u, v in edges]
        self.slots = {frozenset((u, v)): s for (u, v), s in zip(edges, slots)}
        self.nbr, self.nbr_slot, self.mask = nbr, nbr_slot, mask

    def edge_index(self):
        """frozenset({u, v}) → position in the edge list."""
        return {frozenset(e): i for i, e in enumerate(self.edges)}

    def check_schedule(self, groups) -> None:
        """Raise unless ``groups`` (lists of edges as name pairs) cover every
        edge once and no two edges of a group share a vertex."""
        seen = set()
        for group in groups:
            touched = set()
            for u, v in group:
                key = frozenset((u, v))
                if key not in self.slots:
                    raise ValueError(f"schedule edge {u}-{v} is not a bond")
                if key in seen:
                    raise ValueError(f"schedule repeats edge {u}-{v}")
                if u in touched or v in touched:
                    raise ValueError(f"group shares a vertex at {u}-{v}")
                seen.add(key)
                touched.update((u, v))
        if len(seen) != len(self.slots):
            raise ValueError(f"schedule covers {len(seen)} of "
                             f"{len(self.slots)} edges")


class Reference:
    """The Trotter step of a field layer on ``E`` independent members.

    ``T``: [E, V, χ, ..., χ, d]; ``M``: [E, V, D, χ, χ]."""

    def __init__(self, lattice: Lattice, chi: int, *, cutoff: float,
                 bp_maxiter: int, bp_tolerance: float, root_eps: float,
                 normalize: bool, device, tf32: bool = False, d: int = 2):
        self.lat, self.chi, self.d = lattice, chi, d
        self.cutoff, self.maxiter, self.tol = cutoff, bp_maxiter, bp_tolerance
        self.root_eps, self.normalize = root_eps, normalize
        self.device, self.tf32 = torch.device(device), tf32
        self.dtype = torch.complex128
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.nbr, self.nbr_slot = as_t(lattice.nbr), as_t(lattice.nbr_slot)
        self.mask = as_t(lattice.mask)
        self.sweeps: list[int] = []  # sweeps of each refresh (slowest member)

    # -- arithmetic ----------------------------------------------------------

    def mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def _eigh(self, h):
        """The library eigh in complex128: small matrices on the host's
        LAPACK (the device's solver takes them one launch sequence each),
        the rest on the device."""
        if h.is_cuda and h.shape[-1] <= SMALL_ON_HOST:
            flat = h.reshape((-1,) + h.shape[-2:]).cpu()
            parts = list(_POOL.map(torch.linalg.eigh, flat.chunk(HOST_THREADS)))
            w = torch.cat([p[0] for p in parts]).reshape(h.shape[:-1])
            u = torch.cat([p[1] for p in parts]).reshape(h.shape)
            return w.to(h.device), u.to(h.device)
        return torch.linalg.eigh(h)

    def _absorb(self, t, m, leg):
        """Σ_l t[.., l (at ``leg``), ..] m[l, l'], batched on axis 0."""
        t2 = t.movedim(leg, -1)
        shape = t2.shape
        out = self.mm(t2.reshape(shape[0], -1, shape[-1]), m)
        return out.reshape(shape).movedim(-1, leg)

    def _roots(self, m):
        """(√m, 1/√m) of hermitian batches, small eigenvalues zeroed."""
        w, u = self._eigh(0.5 * (m + m.mH))
        wmax = w.abs().amax(-1, keepdim=True).clamp(min=self.root_eps)
        good = w > 10 * self.root_eps * wmax
        safe = torch.where(good, w, torch.ones_like(w))
        sq = torch.where(good, safe.sqrt(), torch.zeros_like(w))
        isq = torch.where(good, 1 / safe.sqrt(), torch.zeros_like(w))
        uh = u.mH
        return ((u * sq[..., None, :].to(u.dtype)) @ uh,
                (u * isq[..., None, :].to(u.dtype)) @ uh)

    # -- states --------------------------------------------------------------

    def product_state(self, members: int):
        """|0…0⟩ with identity messages."""
        V, D, chi = len(self.lat.vertices), self.lat.degree, self.chi
        T = torch.zeros((members, V) + (chi,) * D + (self.d,),
                        dtype=self.dtype, device=self.device)
        T[(slice(None), slice(None)) + (0,) * D + (0,)] = 1.0
        eye = torch.eye(chi, dtype=self.dtype, device=self.device)
        M = eye.expand(members, V, D, chi, chi).clone()
        return T, M

    # -- belief propagation --------------------------------------------------

    def _outgoing(self, T, M):
        """m_out[b, j]: the message vertex b sends through leg j."""
        B, D, chi = T.shape[0], self.lat.degree, self.chi
        outs = []
        for j in range(D):
            acc = T
            for k in range(D):
                if k != j:
                    acc = self._absorb(acc, M[:, k], 1 + k)
            a = acc.movedim(1 + j, 1).reshape(B, chi, -1)
            b = T.movedim(1 + j, 1).reshape(B, chi, -1)
            outs.append(self.mm(a, b.conj().transpose(1, 2)))
        return torch.stack(outs, 1)

    def _normalized(self, m):
        m = 0.5 * (m + m.mH)
        s = m.sum((-2, -1), keepdim=True)
        m = m / torch.where(s.abs() == 0, torch.ones_like(s), s)
        eye = torch.eye(self.chi, dtype=m.dtype, device=m.device)
        return torch.where(self.mask[..., None, None], m, eye)

    def _distance(self, a, b):
        """Mean fidelity distance over the real bonds, per member."""
        dot = (a.conj() * b).sum((-2, -1))
        nn = (torch.linalg.vector_norm(a, dim=(-2, -1))
              * torch.linalg.vector_norm(b, dim=(-2, -1)))
        f = (dot / torch.where(nn == 0, torch.ones_like(nn), nn)).abs() ** 2
        d = torch.where(self.mask, 1 - f, torch.zeros_like(f))
        return d.sum((-2, -1)) / self.mask.sum()

    def bp(self, T, M):
        E, V = T.shape[:2]
        flat = T.flatten(0, 1)
        active = torch.ones(E, dtype=torch.bool, device=T.device)
        sweeps = 0
        for _ in range(self.maxiter):
            out = self._outgoing(flat, M.flatten(0, 1)).unflatten(0, (E, V))
            new = self._normalized(out[:, self.nbr, self.nbr_slot])
            dist = self._distance(M, new)
            M = torch.where(active[:, None, None, None, None], new, M)
            active = active & (dist > self.tol)
            sweeps += 1
            if not bool(active.any()):
                break
        self.sweeps.append(sweeps)
        return M

    # -- one-site gates --------------------------------------------------------

    def one_site(self, T, gates):
        """gates [E, V, d, d] on every site."""
        E, V = T.shape[:2]
        t = T.reshape(E * V, -1, self.d)
        g = gates.reshape(E * V, self.d, self.d).transpose(1, 2)
        return self.mm(t, g).reshape(T.shape)

    # -- the simple update -------------------------------------------------

    def _split(self, mat):
        """(U, σ descending, V†) of each matrix from the eigendecomposition
        of its Gram matrix in complex128: σ² resolved to ~1e-16 of σmax²,
        far below the cutoff, so every kept value and vector is exact to
        about 1e-11.  A zero σ gets a zero vector (it is never kept)."""
        n1, n2 = mat.shape[-2:]
        if n2 <= n1:
            w, v = self._eigh(self._herm(self.mm(mat.mH, mat)))
            w, v = w.flip(-1), v.flip(-1)
            s = w.clamp(min=0).sqrt()
            us = self.mm(mat, v)
            safe = torch.where(s > 0, s, torch.ones_like(s))[..., None, :]
            u = torch.where((s > 0)[..., None, :], us / safe,
                            torch.zeros_like(us))
            return u, s, v.mH
        u, s, vh = self._split(mat.mH)
        return vh.mH, s, u.mH

    @staticmethod
    def _herm(m):
        return 0.5 * (m + m.mH)

    def _prep(self, t, slot, roots):
        """Absorb the roots on the non-gate legs and matricize to
        [B, χ^(D-1), χ·d] (gate leg and physical leg last)."""
        D = self.lat.degree
        others = [k for k in range(D) if k != slot]
        for r, k in zip(roots, others):
            t = self._absorb(t, r, 1 + k)
        t = t.permute([0] + [1 + k for k in others] + [1 + slot, D + 1])
        return t.reshape(t.shape[0], -1, self.chi * self.d)

    def _finish(self, q, fac, slot, inv_roots):
        D, chi, d = self.lat.degree, self.chi, self.d
        B = q.shape[0]
        t = self.mm(q, fac.reshape(B, fac.shape[1], d * chi))
        t = t.reshape((B,) + (chi,) * (D - 1) + (d, chi)).movedim(-1, -2)
        others = [k for k in range(D) if k != slot]
        order = others + [slot]
        t = t.permute([0] + [1 + order.index(k) for k in range(D)] + [D + 1])
        for r, k in zip(inv_roots, others):
            t = self._absorb(t, r, 1 + k)
        return t

    def _bucket(self, T, M, u_idx, v_idx, su, sv, gates):
        """Simple update of the edges (u_idx[i], v_idx[i]) of every member:
        returns new endpoint tensors, messages and truncation errors."""
        E = T.shape[0]
        D, chi, d = self.lat.degree, self.chi, self.d
        tu, tv = T[:, u_idx].flatten(0, 1), T[:, v_idx].flatten(0, 1)
        mu, mv = M[:, u_idx].flatten(0, 1), M[:, v_idx].flatten(0, 1)
        B = tu.shape[0]
        env = torch.stack([mu[:, k] for k in range(D) if k != su]
                          + [mv[:, k] for k in range(D) if k != sv])
        roots, inv_roots = self._roots(env)
        qu, ru = torch.linalg.qr(self._prep(tu, su, roots[:D - 1]))
        qv, rv = torch.linalg.qr(self._prep(tv, sv, roots[D - 1:]))
        r1, r2 = ru.shape[1], rv.shape[1]
        a = ru.reshape(B, r1, chi, d).permute(0, 1, 3, 2).reshape(B, r1 * d, chi)
        b = rv.reshape(B, r2, chi, d).permute(0, 2, 1, 3).reshape(B, chi, r2 * d)
        theta = self.mm(a, b).reshape(B, r1, d, r2, d)  # [x, c, y, z]
        theta = theta.permute(0, 1, 3, 2, 4).reshape(B, r1 * r2, d * d)
        g = gates.reshape(B, d * d, d * d)  # [(p q), (c z)]
        theta = self.mm(theta, g.transpose(1, 2))  # [(x y), (p q)]
        theta = theta.reshape(B, r1, r2, d, d).permute(0, 1, 3, 2, 4)
        u, s, vh = self._split(theta.reshape(B, r1 * d, r2 * d))
        p = s * s
        total = p.sum(-1, keepdim=True)
        safe = torch.where(total == 0, torch.ones_like(total), total)
        tail = p.flip(-1).cumsum(-1).flip(-1)
        keep = tail / safe > self.cutoff
        keep[:, 0] = True
        keep &= torch.arange(s.shape[-1], device=s.device) < chi
        err = torch.where(keep, torch.zeros_like(p), p).sum(-1) / safe[:, 0]
        k = min(chi, s.shape[-1])
        s_kept = torch.where(keep, s, torch.zeros_like(s))[:, :k]
        u, vh = u[:, :, :k], vh[:, :k, :]
        if k < chi:
            s_kept = torch.cat([s_kept, s_kept.new_zeros(B, chi - k)], -1)
            u = torch.cat([u, u.new_zeros(B, u.shape[1], chi - k)], -1)
            vh = torch.cat([vh, vh.new_zeros(B, chi - k, vh.shape[2])], -2)
        root_s = s_kept.sqrt().to(u.dtype)
        x = u * root_s[:, None, :]
        y = root_s[:, :, None] * vh
        fac_u = x.reshape(B, r1, d, chi)
        fac_v = y.transpose(1, 2).reshape(B, r2, d, chi)
        tu_new = self._finish(qu, fac_u, su, inv_roots[:D - 1])
        tv_new = self._finish(qv, fac_v, sv, inv_roots[D - 1:])
        if self.normalize:
            s_norm = torch.linalg.vector_norm(s_kept, dim=-1, keepdim=True)
            s_kept = s_kept / torch.where(s_norm == 0, torch.ones_like(s_norm),
                                          s_norm)
            tu_new, tv_new = self._unit(tu_new), self._unit(tv_new)
        msg = torch.diag_embed(s_kept).to(self.dtype)
        un = lambda x: x.unflatten(0, (E, -1))  # noqa: E731
        return un(tu_new), un(tv_new), un(msg), un(err)

    @staticmethod
    def _unit(t):
        n = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=-1)
        n = torch.where(n == 0, torch.ones_like(n), n)
        return t / n.reshape((-1,) + (1,) * (t.ndim - 1)).to(t.dtype)

    def group_update(self, T, M, group, gates):
        """The simple update of every edge of one colour group (name pairs,
        no shared vertex); ``gates`` [E, len(group), d², d²]."""
        buckets: dict = {}
        for i, (u, v) in enumerate(group):
            iu, iv, su, sv = self.lat.slots[frozenset((u, v))]
            if self.lat.vertices[iu] != u:  # the edge listed as (v, u)
                iu, iv, su, sv = iv, iu, sv, su
                gates = gates.clone()
                gates[:, i] = _swap_sites(gates[:, i], self.d)
            buckets.setdefault((su, sv), []).append((i, iu, iv))
        T, M = T.clone(), M.clone()
        errs = []
        for (su, sv), items in sorted(buckets.items()):
            pos = [i for i, _, _ in items]
            u_idx = torch.as_tensor([iu for _, iu, _ in items], device=T.device)
            v_idx = torch.as_tensor([iv for _, _, iv in items], device=T.device)
            tu, tv, msg, err = self._bucket(T, M, u_idx, v_idx, su, sv,
                                            gates[:, pos])
            T[:, u_idx], T[:, v_idx] = tu, tv
            M[:, u_idx, su], M[:, v_idx, sv] = msg, msg
            errs.append(err)
        return T, M, torch.cat(errs, 1)

    # -- the step and the readout ------------------------------------------------

    def step(self, T, M, site_gates, schedule, bond_gates):
        """One Trotter step: ``site_gates`` [E, V, d, d]; ``schedule`` the
        colour groups (lists of name pairs); ``bond_gates`` one
        [E, len(group), d², d²] per group."""
        T = self.one_site(T, site_gates)
        for group, gates in zip(schedule, bond_gates):
            M = self.bp(T, M)
            T, M, _ = self.group_update(T, M, group, gates)
        return T, self.bp(T, M)

    def z(self, T, M):
        """⟨Z⟩ per site, [E, V], float64."""
        E, V = T.shape[:2]
        acc = T.flatten(0, 1)
        m = M.flatten(0, 1)
        for k in range(self.lat.degree):
            acc = self._absorb(acc, m[:, k], 1 + k)
        a = acc.reshape(E * V, -1, self.d)
        t = T.reshape(E * V, -1, self.d)
        rho = self.mm(a.transpose(1, 2), t.conj())  # [s, z]
        diag = torch.diagonal(rho, dim1=-2, dim2=-1).real
        z = (diag[:, 0] - diag[:, 1]) / diag.sum(-1)
        return z.reshape(E, V)


def _swap_sites(g, d):
    """A two-site gate [.., d², d²] with its two sites exchanged."""
    shape = g.shape
    g = g.reshape(shape[:-2] + (d, d, d, d))
    return g.transpose(-4, -3).transpose(-2, -1).reshape(shape)
