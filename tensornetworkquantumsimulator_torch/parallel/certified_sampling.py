"""Batched certified sampling for grid and column-aligned planar states.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
certified_sampling`` (`sampling.jl:48-75, 209-298, 300-332`): a whole batch
of bitstrings is drawn and each one certified with an independent
re-contraction of ⟨x|ψ⟩ (the `sample_certified` flavour).  Where the
reference maps one sample's program over PRNG keys, every per-sample tensor
here carries a leading sample axis (the ``x`` of the einsums) and the scans
over columns are Python loops.

Per sample (all shapes static):

1. *norm strands*: boundary-MPS messages of ⟨ψ|ψ⟩ fitted bottom-up
   (``boundarymps._fit_strand``, shared by all samples) give the
   environment below each row;
2. *conditional sampling*: rows top-to-bottom; per row, right environments
   are built right-to-left, then a left-to-right pass samples each site's
   conditional RDM diagonal (``sampling._draw``), projects the site, and
   pushes the left environment forward;
3. *projected strand*: the sampled row is absorbed into a single-layer ket
   strand, densified and re-truncated at a fixed projected rank (QR/SVD
   sweeps);
4. *certification*: ⟨x|ψ⟩ is re-contracted from the raw tensors and
   combined with log q into p(x)/q(x).

Leg conventions per column: projected strand from above P (a, u, A) and its
conjugate P̄ (b, v, B); norm strand from below N (q, d_ket, e_bra, Q);
ψ (u, d, l, r, s), ψ̄ (v, e, m, t, z).  Left/right environments carry
(strand bonds a/b/q, ket link, bra link).

``logq`` and ``log_poverq`` are accumulated in the state's real dtype (the
reference accumulates them in float32 whatever the state's).
"""

from __future__ import annotations

import numpy as np
import torch

from .boundarymps import (
    GridBMPSSpec,
    PlanarBMPSSpec,
    _fit_strand,
    _swap_up_down,
    identity_strand,
)
from .cuda_linalg import library_qr
from .sampling import _draw
from .structure import BatchedGraphSpec


# ---------------------------------------------------------------------------
# single-layer (ket) strand machinery
# ---------------------------------------------------------------------------


def _single_truncate(strand: torch.Tensor, K: int):
    """[S, W, A, p, B] -> ([S, W, K, p, K], log_norm [S]): QR (L→R) + SVD
    (R→L) sweeps; the result is unit-normalized with the magnitude logged.

    The QR of a column runs one sample per call (``library_qr``): strands
    padded to a common bond have zero and equal columns, on which the
    batched QR of small complex matrices returns NaN on CUDA."""
    S, W, A, p, B = strand.shape
    D = max(A, B, K)
    # pad both bonds to D (pad pairs run from the last axis backwards)
    strand = torch.nn.functional.pad(strand, (0, D - B, 0, 0, 0, D - A))

    r = torch.eye(D, dtype=strand.dtype, device=strand.device).expand(S, D, D)
    qs = []
    for c in range(W):
        t = torch.einsum("xab,xbpc->xapc", r, strand[:, c])
        q, r = library_qr(t.reshape(S, D * p, D))
        qs.append(q.reshape(S, D, p, D))
    qs[-1] = torch.einsum("xapb,xbc->xapc", qs[-1], r)

    # right end bond is pinned to slot 0 (strand-end convention)
    w = torch.zeros((S, D, K), dtype=strand.dtype, device=strand.device)
    w[:, 0, 0] = 1.0
    ts = [None] * W
    for c in range(W - 1, -1, -1):
        t = torch.einsum("xapb,xbk->xapk", qs[c], w)
        # min(D, p·K) ≥ K singular values, so K are always there to keep
        u, s, vh = torch.linalg.svd(t.reshape(S, D, p * K),
                                    full_matrices=False)
        w = u[..., :K] * s[:, None, :K].to(u.dtype)
        ts[c] = vh[:, :K].reshape(S, K, p, K)
    # w [D(left boundary), K] hangs off position 0's pinned end: keep its
    # slot-0 row and store the result back at left-bond slot 0
    first = torch.einsum("xk,xkpc->xpc", w[:, 0], ts[0])
    norm = torch.linalg.vector_norm(first.reshape(S, -1), dim=-1)
    safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    ts[0] = torch.zeros_like(ts[0])
    ts[0][:, 0] = first / safe[:, None, None].to(first.dtype)
    return torch.stack(ts, dim=1), torch.log(safe)


def _e0_strand(S: int, W: int, K: int, chi: int, dtype, device):
    """Single-layer boundary strand of every sample: all legs pinned to
    index 0 (an expanded view, never written)."""
    p0 = torch.zeros((W, K, chi, K), dtype=dtype, device=device)
    p0[:, 0, 0, 0] = 1.0
    return p0.expand(S, W, K, chi, K)


def _push_projected(strand, row, K: int):
    """Absorb a site-projected row into the ket strand and re-truncate.

    strand: [S, W, A, χ(u), B]; row: [S, W, u, d, l, r].
    Returns ([S, W, K, χ(d), K], log_norm [S])."""
    S, W, A, chi, B = strand.shape
    fat = torch.einsum("xwaub,xwudlr->xwaldbr", strand, row)
    return _single_truncate(fat.reshape(S, W, A * chi, chi, B * chi), K)


def _close_projected(strand, row):
    """Contract the final (site-projected) row into the strand, pinning its
    dummy down/right legs to index 0; returns the amplitudes [S]."""
    S, W, A, chi, B = strand.shape
    carry = torch.zeros((S, A, chi), dtype=strand.dtype, device=strand.device)
    carry[:, 0, 0] = 1.0
    for c in range(W):
        # strand column (a, u, b); row column (u, d, l, rr) with d dummy
        x = torch.einsum("xal,xaub->xlub", carry, strand[:, c])
        carry = torch.einsum("xlub,xulr->xbr", x, row[:, c, :, 0])
    return carry[:, 0, 0]


# ---------------------------------------------------------------------------
# environment transfer steps (double layer, see module docstring for legs)
# ---------------------------------------------------------------------------


def _renv_step(renv, p_c, n_c, psi_c):
    """R[c] from R[c+1] with the site traced."""
    x1 = torch.einsum("xABQrt,xauA->xuBQrta", renv, p_c)
    x2 = torch.einsum("xuBQrta,udlrs->xBQtadls", x1, psi_c)
    x3 = torch.einsum("xBQtadls,qdeQ->xBtalsqe", x2, n_c)
    x4 = torch.einsum("xBtalsqe,vemts->xBalqvm", x3, psi_c.conj())
    return torch.einsum("xBalqvm,xbvB->xabqlm", x4, p_c.conj())


def _lenv_step(lenv, p_c, n_c, psip_c):
    """L[c+1] from L[c] with the projected site tensors absorbed."""
    y1 = torch.einsum("xabqlm,xauA->xbqlmuA", lenv, p_c)
    y2 = torch.einsum("xbqlmuA,xudlr->xbqmAdr", y1, psip_c)
    y3 = torch.einsum("xbqmAdr,qdeQ->xbmArQe", y2, n_c)
    y4 = torch.einsum("xbmArQe,xvemt->xbArQvt", y3, psip_c.conj())
    return torch.einsum("xbArQvt,xbvB->xABQrt", y4, p_c.conj())


def _local_rdm(lenv, renv, p_c, n_c, psi_c):
    """ρ[x, s(ket), z(bra)] at one column."""
    z1 = torch.einsum("xabqlm,xauA->xbqlmuA", lenv, p_c)
    z2 = torch.einsum("xbqlmuA,udlrs->xbqmAdrs", z1, psi_c)
    z3 = torch.einsum("xbqmAdrs,qdeQ->xbmArsQe", z2, n_c)
    z4 = torch.einsum("xbmArsQe,vemtz->xbArsQvtz", z3, psi_c.conj())
    z5 = torch.einsum("xbArsQvtz,xbvB->xArsQtzB", z4, p_c.conj())
    return torch.einsum("xArsQtzB,xABQrt->xsz", z5, renv)


def _env_init(S: int, kp: int, kn: int, chi: int, dtype, device):
    """Boundary environment of every sample: strand end-bonds pinned at 0,
    dummy lattice ket/bra links paired with δ (an expanded view)."""
    env = torch.zeros((kp, kp, kn, chi, chi), dtype=dtype, device=device)
    env[0, 0, 0] = torch.eye(chi, dtype=dtype, device=device)
    return env.expand(S, kp, kp, kn, chi, chi)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def make_grid_certified_sampler(
    spec: BatchedGraphSpec,
    nx: int,
    ny: int,
    norm_rank: int,
    projected_rank: int,
    niters: int = 12,
):
    """Build ``sampler(tensors, nsamples, generator=None) -> (bits
    [n, nx, W], logq [n], log_poverq [n])`` for a grid BatchedState
    (gauged/normalized states give the best-conditioned strands);
    ``generator`` is a ``torch.Generator`` on the tensors' device.

    ``exp(log_poverq)`` = |⟨x|ψ⟩|²/q(x): constant across samples iff the
    sampling distribution q is exact, so its spread certifies sample quality
    (`sampling.jl:300-332`)."""
    gspec = GridBMPSSpec(spec, nx, ny)
    return _make_certified_sampler(
        gspec.row_tensors, nx, ny, norm_rank, projected_rank, niters
    )


def make_planar_certified_sampler(
    spec: BatchedGraphSpec,
    norm_rank: int,
    projected_rank: int,
    niters: int = 12,
    row_of=None,
    col_of=None,
):
    """Certified sampler for any column-aligned planar lattice (heavy-hex,
    Lieb, comb, …): the batched counterpart of the reference's
    `sample_certified` on general partitions (`sampling.jl:202-207,
    300-332`).

    Returns ``sampler(tensors, nsamples, generator=None) -> (bits [n, V],
    logq [n], log_poverq [n])`` with bits in ``spec.vertices`` order.  Wire
    (padding) positions sample bit 0 with probability 1 and contribute
    nothing to log q or the certificate."""
    pspec = PlanarBMPSSpec(spec, row_of=row_of, col_of=col_of)
    grid_sampler = _make_certified_sampler(
        pspec.row_tensors, pspec.nrows, pspec.W, norm_rank, projected_rank,
        niters,
    )
    rows_idx = np.asarray([pspec.rowcol[i][0]
                           for i in range(spec.num_vertices)])
    cols_idx = np.asarray([pspec.rowcol[i][1]
                           for i in range(spec.num_vertices)])

    def sampler(tensors, nsamples, generator=None):
        bits, logq, log_poverq = grid_sampler(tensors, nsamples, generator)
        return bits[:, rows_idx, cols_idx], logq, log_poverq

    return sampler


def _make_certified_sampler(
    row_tensors_fn,
    nx: int,
    ny: int,
    norm_rank: int,
    projected_rank: int,
    niters: int = 12,
):
    W = ny

    def norm_strands(tensors):
        rows = [row_tensors_fn(tensors, r) for r in range(nx)]
        m_dn = [None] * nx
        m_dn[nx - 1] = cur = identity_strand(
            W, norm_rank, tensors.shape[1], tensors.dtype, tensors.device)
        for r in range(nx - 1, 0, -1):
            cur = _fit_strand(_swap_up_down(rows[r]), cur, cur, niters,
                              "auto")
            m_dn[r - 1] = cur
        return rows, m_dn

    def sample_row(row, n_strand, p_strand, generator):
        """Sample all columns of one row of every sample; returns (bits
        [S, W], psp [S, W, u, d, l, r], logq [S])."""
        S = p_strand.shape[0]
        chi = row.shape[1]
        kp, kn = p_strand.shape[2], n_strand.shape[1]
        # renvs[c] = environment of columns > c
        renvs = [None] * W
        renv = _env_init(S, kp, kn, chi, row.dtype, row.device)
        for c in range(W - 1, -1, -1):
            renvs[c] = renv
            renv = _renv_step(renv, p_strand[:, c], n_strand[c], row[c])

        lenv = _env_init(S, kp, kn, chi, row.dtype, row.device)
        logq = torch.zeros(S, dtype=row.real.dtype, device=row.device)
        bits, psps = [], []
        for c in range(W):
            p_c, n_c, psi_c = p_strand[:, c], n_strand[c], row[c]
            rho = _local_rdm(lenv, renvs[c], p_c, n_c, psi_c)
            probs = torch.clamp(torch.diagonal(rho, dim1=-2, dim2=-1).real,
                                min=0.0)
            total = probs.sum(-1, keepdim=True)
            probs = probs / torch.where(total == 0, torch.ones_like(total),
                                        total)
            bit = _draw(probs + 1e-30, generator)
            q = probs.gather(1, bit[:, None])[:, 0]
            psip = (torch.movedim(psi_c, -1, 0)[bit]
                    / torch.sqrt(q).to(row.dtype)[:, None, None, None, None])
            lenv = _lenv_step(lenv, p_c, n_c, psip)
            logq = logq + torch.log(q)
            bits.append(bit)
            psps.append(psip)
        return torch.stack(bits, dim=1), torch.stack(psps, dim=1), logq

    def certify(tensors, bits):
        """log |⟨x|ψ⟩|² from scratch (bits: [S, nx, W])."""
        S = bits.shape[0]
        kc = projected_rank
        strand = _e0_strand(S, W, kc, tensors.shape[1], tensors.dtype,
                            tensors.device)
        log_amp = torch.zeros(S, dtype=tensors.real.dtype,
                              device=tensors.device)
        cols = torch.arange(W, device=tensors.device)
        for r in range(nx):
            row = row_tensors_fn(tensors, r)  # [W,u,d,l,rr,s]
            sel = torch.movedim(row, -1, 1)[cols[None, :], bits[:, r]]
            if r < nx - 1:
                strand, ln = _push_projected(strand, sel, kc)
                log_amp = log_amp + ln
            else:
                amp = _close_projected(strand, sel)
                log_amp = log_amp + torch.log(amp.abs() + 1e-30)
        return 2.0 * log_amp

    def sampler(tensors, nsamples: int, generator=None):
        rows, m_dn = norm_strands(tensors)
        p_strand = _e0_strand(nsamples, W, projected_rank, tensors.shape[1],
                              tensors.dtype, tensors.device)
        logq = torch.zeros(nsamples, dtype=tensors.real.dtype,
                           device=tensors.device)
        bits_rows = []
        for r in range(nx):
            bits, psps, lq = sample_row(rows[r], m_dn[r], p_strand, generator)
            logq = logq + lq
            bits_rows.append(bits)
            if r < nx - 1:
                p_strand, _ = _push_projected(p_strand, psps, projected_rank)
        bits_all = torch.stack(bits_rows, dim=1)  # [S, nx, W]
        log_p = certify(tensors, bits_all)
        return bits_all, logq, log_p - logq

    return sampler


# ---------------------------------------------------------------------------
# multi-device: the sample batch split over a mesh
# ---------------------------------------------------------------------------


def make_sharded_sampler(sampler, mesh, axis: str = "s"):
    """Run a certified sampler over the SAMPLE axis of a mesh.

    Sampling is independent across draws, so the state is copied to every
    shard and each shard draws and certifies its own block of ``nsamples
    / S`` samples with its own ``torch.Generator`` (``generators``, one
    per shard on its device; None: the default generators), with no
    exchange between shards.  The strand-fitting preamble is recomputed
    per shard.  The same draws give the same bits, logq and certificates
    as the single-device sampler.  Returns ``sharded(tensors, nsamples,
    generators=None) -> (bits, logq, log_poverq)`` on the mesh's first
    device, shard 0's block first."""
    from .sampling import _split_samples

    del axis  # one sample axis: the mesh's shards in order

    def sharded(tensors, nsamples: int, generators=None):
        n, gens = _split_samples(mesh, nsamples, generators)
        outs = [sampler(t, n, g)
                for t, g in zip(mesh.broadcast(tensors), gens)]
        return tuple(mesh.collect([o[k] for o in outs]) for k in range(3))

    return sharded
