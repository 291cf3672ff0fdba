"""Gate application: the circuit-evolution hot path of the generic engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.apply``
(`src/Apply/apply_gates.jl` and `simple_update.jl` / `full_update.jl`):
gates are applied by simple-update SVD with BP message environments,
re-running BP lazily only when a 2-site gate overlaps previously-affected
vertices (the amortization trick at `apply_gates.jl:60-85`).

This engine is eager: one torch call per contraction and factorization, on
the state's device.  Each two-site gate reads its singular values to the
host once (the truncation rank); nothing else in a gate waits for the
device.  The batched fast path lives in `parallel/`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .engines.beliefpropagation import (
    BeliefPropagationCache,
    default_bp_update_kwargs,
)
from .models import gates as _gates
from .models.tensornetwork import TensorNetworkState
from .ops.index import commoninds, unioninds, uniqueinds
from .ops.linalg import pseudo_sqrt_inv_sqrt, qr_factor, svd_truncated
from .ops.paths import contraction_sequence
from .ops.tensor import Tensor, apply_op, as_torch_dtype, contract, contract_pair
from .utils.graphs import NamedEdge

DEFAULT_APPLY_KWARGS = dict(maxdim=None, cutoff=None, normalize_tensors=True)


def simple_update(
    o: Tensor,
    psi,
    verts: Sequence,
    envs=None,
    normalize_tensors: bool = True,
    maxdim=None,
    cutoff=None,
):
    """Simple update of one or two site tensors under a gate
    (`simple_update.jl:17-68`).

    Returns ``(updated_tensors, s_values, err)``; ``s_values`` carries the
    kept singular values on (bond, bond') for the cache's new edge message.
    """
    if len(verts) == 1:
        updated = [apply_op(o, psi[verts[0]])]
        s_values, err = None, 0.0
    else:
        v1, v2 = verts
        t1, t2 = psi[v1], psi[v2]
        envs_v1 = [m for m in envs if commoninds(m.inds, t1.inds)]
        envs_v2 = [m for m in envs if commoninds(m.inds, t2.inds)]
        for env in envs_v1 + envs_v2:
            if env.ndim != 2:
                raise ValueError("simple_update environments must be matrices")
        sq1 = [pseudo_sqrt_inv_sqrt(m) for m in envs_v1]
        sq2 = [pseudo_sqrt_inv_sqrt(m) for m in envs_v2]

        psi1 = contract([t1] + [s for s, _ in sq1])
        psi2 = contract([t2] + [s for s, _ in sq2])
        s1 = commoninds(t1.inds, o.inds)
        s2 = commoninds(t2.inds, o.inds)
        lind1 = uniqueinds(uniqueinds(psi1.inds, psi2.inds), s1)
        lind2 = uniqueinds(uniqueinds(psi2.inds, psi1.inds), s2)
        q1, r1 = qr_factor(psi1, lind1)
        q2, r2 = qr_factor(psi2, lind2)
        rb1 = commoninds(q1.inds, r1.inds)
        oR = apply_op(o, contract_pair(r1, r2))
        x, y, s_values, err, _bond = svd_truncated(
            oR,
            unioninds(rb1, s1),
            maxdim=maxdim,
            cutoff=cutoff,
            ortho="none",
        )
        q1 = contract([q1] + [i.dag() for _, i in sq1])
        q2 = contract([q2] + [i.dag() for _, i in sq2])
        updated = [contract_pair(q1, x), contract_pair(q2, y)]
        if normalize_tensors and s_values is not None:
            s_values = s_values.normalize()

    if normalize_tensors:
        updated = [t.normalize() for t in updated]
    return updated, s_values, err


def apply_gate_inplace(
    gate: Tensor,
    psi_bpc: BeliefPropagationCache,
    verts=None,
    apply_kwargs: dict | None = None,
):
    """Apply one gate to the cache, refreshing the gate edge's messages with
    the SVD spectrum (`apply_gates.jl:95-122`)."""
    kwargs = dict(DEFAULT_APPLY_KWARGS)
    if apply_kwargs:
        kwargs.update(apply_kwargs)
    normalize_tensors = kwargs.pop("normalize_tensors", True)
    if verts is None:
        verts = psi_bpc.network().vertices_of_tensor(gate)
    envs = None if len(verts) == 1 else psi_bpc.incoming_messages(list(verts))
    updated, s_values, err = simple_update(
        gate,
        psi_bpc.network(),
        verts,
        envs=envs,
        normalize_tensors=normalize_tensors,
        **kwargs,
    )
    if len(verts) == 2:
        # the SVD spectrum is the new fixed-point message on the gate edge
        # (singular values are non-negative, so the reference's sign fix
        # at `apply_gates.jl:108-115` is the identity here)
        e = NamedEdge(verts[0], verts[1])
        psi_bpc.setmessage(e, s_values.dag())
        psi_bpc.setmessage(e.reverse(), s_values)
    for t, v in zip(updated, verts):
        psi_bpc.setindex_preserve(t, v)
    return psi_bpc, err


def adapt_gate(gate: Tensor, dtype) -> Tensor:
    """Coerce gate dtype to the state's (`apply_gates.jl:37-40`): a complex
    gate on a real state makes the state complex, at the state's
    precision."""
    dtype = as_torch_dtype(dtype)
    if gate.dtype.is_complex:
        target = torch.promote_types(dtype, torch.complex64)
        if dtype in (torch.float64, torch.complex128):
            target = torch.complex128
        return gate.astype(target)
    return gate.astype(dtype)


def apply_gates(
    circuit,
    psi,
    apply_kwargs: dict | None = None,
    bp_update_kwargs: dict | None = None,
    update_cache: bool = True,
    verbose: bool = False,
    gate_vertices=None,
):
    """Apply a circuit via simple update with amortized BP refreshes
    (`apply_gates.jl:13-92`).

    - on a TensorNetworkState: returns ``(state, truncation_errors)``
    - on a BeliefPropagationCache: returns ``(cache, truncation_errors)``
    """
    if isinstance(psi, TensorNetworkState):
        bp_kw = bp_update_kwargs or default_bp_update_kwargs(psi)
        psi_bpc = BeliefPropagationCache(psi).update(**bp_kw)
        psi_bpc, errors = apply_gates(
            circuit,
            psi_bpc,
            apply_kwargs=apply_kwargs,
            bp_update_kwargs=bp_update_kwargs,
            update_cache=update_cache,
            verbose=verbose,
            gate_vertices=gate_vertices,
        )
        return psi_bpc.network(), errors

    psi_bpc = psi.copy()
    bp_kw = bp_update_kwargs or default_bp_update_kwargs(psi_bpc.network())

    if gate_vertices is None:
        converted = _gates.to_tensors(circuit, psi_bpc.network().siteinds(),
                                      device=psi_bpc.network().device())
        tensors = [t for t, _ in converted]
        gate_vertices = [
            vs if vs is not None else psi_bpc.network().vertices_of_tensor(t)
            for t, vs in converted
        ]
    else:
        tensors = list(circuit)

    dtype = psi_bpc.scalartype()
    affected: set = set()
    errors = np.zeros(len(tensors))
    for i, gate in enumerate(tensors):
        verts = gate_vertices[i]
        needs_refresh = len(verts) >= 2 and any(v in affected for v in verts)
        if update_cache and needs_refresh:
            if verbose:
                print("Updating BP cache")
            psi_bpc = psi_bpc.update(**bp_kw)
            affected = set()
        gate = adapt_gate(gate, dtype)
        psi_bpc, errors[i] = apply_gate_inplace(
            gate, psi_bpc, verts=verts, apply_kwargs=apply_kwargs
        )
        affected.update(verts)

    if update_cache:
        psi_bpc = psi_bpc.update(**bp_kw)
    return psi_bpc, errors


apply_circuit = apply_gates


# ---------------------------------------------------------------------------
# full update (`src/Apply/full_update.jl`) — ALS optimization in the full
# environment; used by boundary-MPS truncation (`truncate.jl:55`).
# ---------------------------------------------------------------------------


def full_update(
    o: Tensor,
    psi,
    verts,
    envs,
    nfullupdatesweeps: int = 10,
    symmetrize: bool = False,
    maxdim=None,
    cutoff=None,
    solver: str = "auto",
):
    """Two-site full update: QR-split both sites, ALS-optimize the reduced
    factors against the environment, recombine (`full_update.jl:8-55`)."""
    v1, v2 = verts
    t1, t2 = psi[v1], psi[v2]
    s1 = psi.uniqueinds(v1)  # dangling (site) indices
    s2 = psi.uniqueinds(v2)
    lind1 = uniqueinds(uniqueinds(t1.inds, t2.inds), s1)
    lind2 = uniqueinds(uniqueinds(t2.inds, t1.inds), s2)
    q1, r1 = qr_factor(t1, lind1)
    q2, r2 = qr_factor(t2, lind2)

    extended_envs = list(envs) + [q1, q1.dag().prime(), q2, q2.dag().prime()]
    p_cur, q_cur = _optimise_p_q(
        r1,
        r2,
        extended_envs,
        o,
        nfullupdatesweeps=nfullupdatesweeps,
        maxdim=maxdim,
        cutoff=cutoff,
        solver=solver,
    )
    if symmetrize:
        x, y, s_values, err, _ = svd_truncated(
            contract_pair(p_cur, q_cur),
            list(p_cur.inds),
            maxdim=maxdim,
            cutoff=cutoff,
            ortho="none",
        )
        p_cur, q_cur = x, y
    return [contract_pair(q1, p_cur), contract_pair(q2, q_cur)]


def _contract_noprime(ts):
    seq = contraction_sequence(ts, alg="optimal")
    return contract(ts, seq).noprime()


def fidelity(envs, p_cur, q_cur, p_prev, q_prev, gate):
    """|⟨gate·(p_prev q_prev), p_cur q_cur⟩|² / (norms) — the full-update
    cost diagnostic (`full_update.jl:56-98`)."""
    from .ops.index import commoninds as _common

    p_sind = _common(p_cur.inds, gate.inds)[0]
    q_sind = _common(q_cur.inds, gate.inds)[0]
    p_sim, q_sim = p_sind.sim(), q_sind.sim()
    gate_sq = contract_pair(
        gate, gate.dag().replaceinds([p_sind, q_sind], [p_sim, q_sim])
    )
    term1 = contract(
        [
            p_prev,
            q_prev,
            p_prev.dag().prime().replaceind(p_sind.prime(), p_sim),
            q_prev.dag().prime().replaceind(q_sind.prime(), q_sim),
            gate_sq,
        ]
        + list(envs),
        contraction_sequence(
            [
                p_prev,
                q_prev,
                p_prev.dag().prime().replaceind(p_sind.prime(), p_sim),
                q_prev.dag().prime().replaceind(q_sind.prime(), q_sim),
                gate_sq,
            ]
            + list(envs),
            alg="optimal",
        ),
    ).scalar()
    ts2 = [
        p_cur,
        q_cur,
        p_cur.dag().prime().replaceind(p_sind.prime(), p_sind),
        q_cur.dag().prime().replaceind(q_sind.prime(), q_sind),
    ] + list(envs)
    term2 = contract(ts2, contraction_sequence(ts2, alg="optimal")).scalar()
    ts3 = [p_prev, q_prev, p_cur.dag().prime(), q_cur.dag().prime(), gate] + list(
        envs
    )
    term3 = contract(ts3, contraction_sequence(ts3, alg="optimal")).scalar()
    f = term3 / np.sqrt(term1 * term2)
    return f * np.conj(f)


def _optimise_p_q(
    p, q, envs, o, nfullupdatesweeps=10, maxdim=None, cutoff=None,
    solver="auto",
):
    """ALS sweeps solving M x = b per site (`full_update.jl:102-163`).

    ``solver``: "dense" matricizes the normal operator and solves by
    least squares (exact, O(n³) — fine for small reduced factors);
    "cg" runs matrix-free conjugate gradient on the hermitian-PSD
    environment operator, the analogue of the reference's KrylovKit
    `linsolve` (`full_update.jl:129-140`) that scales to large χ;
    "auto" switches to CG once the unknown exceeds 64 entries."""
    opq = apply_op(o, contract_pair(p, q))
    x, y, _s, _err, _bond = svd_truncated(
        opq, list(p.inds), maxdim=maxdim, cutoff=cutoff, ortho="left"
    )
    p_cur, q_cur = x, y

    def b_vec(r):
        return _contract_noprime([p, q, o, r.dag().prime()] + list(envs))

    def solve_for(x_cur, other):
        # environment of x: contract everything except x
        s_other = [i for i in other.inds if i.plev == 0 and _is_dangling(i, envs, x_cur)]
        other_dag = other.dag().prime().replaceinds(
            [i.prime() for i in s_other], s_other
        )
        rhs = b_vec(other)
        xin = list(rhs.inds)
        xout = [i.prime() for i in xin]
        dsz = int(np.prod([i.dim for i in xin]))
        bvec = rhs.array(tuple(xin)).reshape(dsz)
        from .ops.tensor import delta as _delta

        use_cg = solver == "cg" or (solver == "auto" and dsz > 64)
        if use_cg:
            # matrix-free CG on the hermitian-PSD environment operator —
            # never materializes the dsz×dsz matrix (KrylovKit-linsolve
            # parity, `full_update.jl:129-140`)
            op_factors = [other, other_dag] + list(envs)
            touched = set().union(*(f.inds for f in op_factors))
            deltas = [
                _delta((i, i.prime()), dtype=rhs.dtype, device=rhs.device)
                for i in xin
                if i not in touched
            ]

            def matvec(vec):
                xt = Tensor(
                    vec.reshape(tuple(i.dim for i in xin)), tuple(xin)
                )
                out = contract([xt] + op_factors + deltas)
                return out.array(tuple(xout)).reshape(dsz)

            x0 = (x_cur.array(tuple(xin)).reshape(dsz)
                  if set(x_cur.inds) == set(xin) else None)
            sol = _cg_hermitian(matvec, bvec, x0=x0)
            return Tensor(sol.reshape(tuple(i.dim for i in xin)), tuple(xin))

        m_tensor = contract([other, other_dag] + list(envs))
        # m_tensor has x's inds (unprimed) and their primes, except legs of x
        # that touch nothing else (its site leg) — the operator is the
        # identity there, so extend with δ(i, i')
        present = set(m_tensor.inds)
        for i in xin:
            if i not in present:
                m_tensor = contract_pair(
                    m_tensor, _delta((i, i.prime()), dtype=m_tensor.dtype,
                                     device=m_tensor.device)
                )
        mat = m_tensor.array(tuple(xout) + tuple(xin)).reshape(dsz, dsz)
        sol = _lstsq_min_norm(mat, bvec.to(mat.dtype))
        return Tensor(sol.reshape(tuple(i.dim for i in xin)), tuple(xin))

    for _ in range(nfullupdatesweeps):
        p_cur = solve_for(p_cur, q_cur)
        q_cur = solve_for(q_cur, p_cur)
    return p_cur, q_cur


def _lstsq_min_norm(mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution of mat·x = b, as numpy's
    ``lstsq(rcond=None)`` gives it: singular values below
    eps·max(m, n)·σ_max count as zero.  Through an SVD, so it runs alike on
    every device (CUDA's ``torch.linalg.lstsq`` solves full-rank systems
    only)."""
    u, sv, vh = torch.linalg.svd(mat, full_matrices=False)
    eps = torch.finfo(sv.dtype).eps
    keep = sv > eps * max(mat.shape) * sv.max()
    inv = torch.where(keep, 1 / torch.where(keep, sv, torch.ones_like(sv)),
                      torch.zeros_like(sv)).to(mat.dtype)
    return vh.conj().T @ (inv * (u.conj().T @ b))


def _cg_hermitian(matvec, b, x0=None, tol=1e-12, maxiter=None):
    """Conjugate gradient for hermitian-PSD operators (possibly singular:
    iterates stay in the Krylov space of b, i.e. range(M), so the
    pseudo-solution is reached without regularization).  Each iteration
    reads its residual to the host to decide whether to stop."""
    n = b.shape[0]
    if maxiter is None:
        maxiter = 4 * n
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b - matvec(x)
    p = r.clone()
    rs = torch.vdot(r, r)
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0:
        return x * 0
    for _ in range(maxiter):
        if float(torch.sqrt(rs.abs())) <= tol * bnorm:
            break
        mp = matvec(p)
        denom = torch.vdot(p, mp)
        if float(denom.abs()) <= 1e-300:
            break
        alpha = rs / denom
        x = x + alpha * p
        r = r - alpha * mp
        rs_new = torch.vdot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def _is_dangling(ind, envs, x_cur):
    for e in envs:
        if ind in e.inds:
            return False
    return ind not in x_cur.inds
