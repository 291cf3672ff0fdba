"""Batched sampling: conditional bitstring generation on the BP path.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.sampling``
(`sampling.jl:3-46`).  The reference maps one sample's conditioning chain
over PRNG keys; here every tensor carries an explicit leading sample axis
``[S, …]`` and the chain is a Python loop over vertices (project →
flooding-BP refresh → next).  For the BP refresh the S samples are S
members of an ensemble folded into the vertex axis
(``engine.fold_members`` / ``member_tables``), so one sweep updates every
sample's messages at once.

Samplers take the number of samples and a ``torch.Generator`` on the
state's device where the reference takes a key array.  Every random draw
goes through :func:`_draw`, so a test can force a chain of outcomes and
read the conditional probabilities it was offered.
"""

from __future__ import annotations

import torch

from .engine import (
    _LETTERS,
    _absorb,
    BatchedState,
    bp_iteration,
    default_batched_tolerance,
    graph_tables,
    identity_messages,
    member_tables,
)
from .overlap import _sandwich_bp, sandwich_sweeps
from .structure import BatchedGraphSpec


def _draw(probs: torch.Tensor, generator: torch.Generator | None):
    """One categorical draw per row of ``probs`` [S, d] (non-negative, not
    necessarily normalized) → outcomes [S] int64."""
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _local_rdm_at(spec: BatchedGraphSpec, tensors, messages, v: int):
    """ρ[S, s, s'] at vertex ``v`` of every sample (tensors [S, V, χ.., d],
    messages [S, V, D, χ, χ])."""
    D = spec.degree
    t = tensors[:, v]
    acc = t
    for k in range(D):
        acc = _absorb(acc, messages[:, v, k], 1 + k)
    lab = "".join(_LETTERS[k] for k in range(D))
    return torch.einsum(f"v{lab}s,v{lab}z->vsz", acc, t.conj())


def _samples_of(x: torch.Tensor, nsamples: int) -> torch.Tensor:
    """``nsamples`` writable copies of ``x`` along a new leading axis."""
    return x.expand((nsamples,) + tuple(x.shape)).clone()


def make_bp_sampler(
    spec: BatchedGraphSpec,
    refresh_iters: int = 5,
    jit: bool = True,
):
    """Build ``sampler(state, nsamples, generator=None) -> bitstrings
    [nsamples, V]`` (int64, ``spec.vertices`` order).

    ``state`` should hold converged BP messages (and ideally a
    gauged/normalized state).  Each sample runs the reference's conditional
    chain: sample the local RDM's diagonal, project the site, refresh BP a
    few flooding iterations, move to the next vertex.  ``jit`` is accepted
    for the reference's signature and ignored."""
    del jit
    V = spec.num_vertices

    def sampler(state: BatchedState, nsamples: int,
                generator: torch.Generator | None = None):
        dev = state.tensors.device
        tables = member_tables(graph_tables(spec, dev), nsamples, V)
        tensors = _samples_of(state.tensors, nsamples)
        messages = _samples_of(state.messages, nsamples)
        d = tensors.shape[-1]
        configs = []
        for v in range(V):
            rho = _local_rdm_at(spec, tensors, messages, v)
            probs = torch.clamp(torch.diagonal(rho, dim1=-2, dim2=-1).real,
                                min=0.0)
            probs = probs / probs.sum(-1, keepdim=True)
            config = _draw(probs + 1e-30, generator)
            configs.append(config)
            # project: ψ_v ← ψ_v ⋅ e_config (site axis is last)
            proj = torch.nn.functional.one_hot(config, d).to(tensors.dtype)
            tensors[:, v] *= proj.reshape((nsamples,) + (1,) * spec.degree
                                          + (d,))
            if v == V - 1:
                break  # the refreshed messages would be discarded
            folded = tensors.flatten(0, 1)
            m = messages.flatten(0, 1)
            for _ in range(refresh_iters):
                m = bp_iteration(spec, BatchedState(folded, m), tables)
            messages = m.unflatten(0, (nsamples, V))
        return torch.stack(configs, dim=1)

    return sampler


# ---------------------------------------------------------------------------
# density-matrix (noisy-state) sampling
# ---------------------------------------------------------------------------


def make_rho_sampler(
    spec: BatchedGraphSpec,
    chi: int,
    dtype: torch.dtype,
    *,
    refresh_iters: int = 8,
    init_maxiter: int = 60,
    tolerance: float | None = None,
    jit: bool = True,
):
    """Build ``sampler(state, nsamples, generator=None) -> (bitstrings
    [S, V], logps [S])`` drawing computational-basis bitstrings from a
    batched density-matrix ("PauliRho", d=4) coefficient state.

    The flat linear-functional network Tr[ρ·⊗w_v] is the engine's ψ̄ϕ
    sandwich against a bond-1 product bra (trace vector [1,0,0,0] per
    site), so ONE sandwich-BP fixed point, shared by the whole sample
    batch, seeds a loop over vertices: local projector weights →
    categorical draw → swap the bra's site vector to the chosen projector
    [1,0,0,±1]/2 → a fixed number of flooding refresh iterations.

    ``logps[i]`` telescopes the conditional probabilities:
    log(⟨x|ρ|x⟩ / Tr ρ) wherever BP is exact (trees); ``refresh_iters``
    should cover the graph diameter for tree-exactness.  ``jit`` is
    accepted for the reference's signature and ignored."""
    del jit
    V, D = spec.num_vertices, spec.degree
    if tolerance is None:
        tolerance = default_batched_tolerance(dtype)
    rdt = torch.empty((), dtype=dtype).real.dtype
    tiny = torch.finfo(rdt).tiny

    def sampler(state: BatchedState, nsamples: int,
                generator: torch.Generator | None = None):
        t_ket = state.tensors
        dev = t_ket.device
        single = graph_tables(spec, dev)
        tables = member_tables(single, nsamples, V)
        bra0 = torch.zeros((V,) + (chi,) * D + (4,), dtype=t_ket.dtype,
                           device=dev)
        bra0[(slice(None),) + (0,) * D + (0,)] = 1.0
        # diagonal projectors Π_b = (I + (−1)^b Z)/2 as Pauli site vectors
        proj = torch.tensor([[0.5, 0.0, 0.0, 0.5], [0.5, 0.0, 0.0, -0.5]],
                            dtype=t_ket.dtype, device=dev)
        m0 = identity_messages(V, D, chi, t_ket.dtype, dev)
        m_init = _sandwich_bp(spec, t_ket, bra0, m0, init_maxiter, tolerance,
                              0.0, single)

        ket = t_ket.expand((nsamples,) + tuple(t_ket.shape))  # a view
        ket_folded = ket.flatten(0, 1)  # the one copy, [S·V, χ.., 4]
        bra_c = _samples_of(bra0, nsamples)
        m = _samples_of(m_init, nsamples)
        logp = torch.zeros(nsamples, dtype=rdt, device=dev)
        configs = []
        for v in range(V):
            # absorb incoming sandwich messages into ρ_v's ket tensor; the
            # bra side is the one-hot (0,)*D bond slot, so the local scalar
            # against any site vector w is acc[(0,)*D] · w
            acc = ket[:, v]
            for k in range(D):
                acc = _absorb(acc, m[:, v, k], 1 + k)
            vec = acc[(slice(None),) + (0,) * D]  # [S, 4]
            w = (vec @ proj.T).real  # [S, 2]
            # the two weights share one (possibly negative-scaled) flat
            # environment: only the ratio matters.  Divide the common sign
            # out first, then clip any residual negative weight (loopy-BP
            # artifact) and renormalize; a fully degenerate pair (sum 0)
            # is a uniform draw.
            s = w.sum(-1, keepdim=True)
            wc = torch.clamp(torch.where(s < 0, -w, w), min=0.0)
            tot = wc.sum(-1, keepdim=True)
            p = torch.where(tot > 0, wc / torch.clamp(tot, min=tiny),
                            torch.full_like(wc, 0.5))
            config = _draw(p, generator)
            configs.append(config)
            logp = logp + torch.log(torch.clamp(
                p.gather(1, config[:, None])[:, 0], min=tiny))
            bra_c[(slice(None), v) + (0,) * D] = proj[config]
            if v == V - 1:
                break  # the refreshed messages would be discarded
            m = sandwich_sweeps(spec, ket_folded, bra_c.flatten(0, 1),
                                m.flatten(0, 1), refresh_iters,
                                tables=tables).unflatten(0, (nsamples, V))
        return torch.stack(configs, dim=1), logp

    return sampler


def _split_samples(mesh, nsamples: int, generators):
    """Per-shard sample counts and generators of a sampler sharded over
    the sample axis."""
    S = mesh.num_shards
    if nsamples % S != 0:
        raise ValueError(f"{nsamples} samples not divisible by {S} shards")
    if generators is None:
        generators = [None] * S
    if len(generators) != S:
        raise ValueError(f"{len(generators)} generators for {S} shards")
    return nsamples // S, list(generators)


def make_sharded_rho_sampler(sampler, mesh, axis: str = "s"):
    """Run a :func:`make_rho_sampler` sampler over the SAMPLE axis of a
    mesh — the density-matrix counterpart of
    ``certified_sampling.make_sharded_sampler``.

    Draws are independent, so every shard draws its own block of
    ``nsamples / S`` samples from a copy of the (replicated) state, with
    its own ``torch.Generator`` (``generators``, one per shard on its
    device; None: the default generators), and recomputes the initial
    sandwich fixed point itself.  The same draws give the same bitstrings
    and logps as the single-device sampler.  Returns ``sharded(state,
    nsamples, generators=None) -> (bitstrings [n, V], logps [n])`` on the
    mesh's first device, shard 0's block first."""
    del axis  # one sample axis: the mesh's shards in order

    def sharded(state: BatchedState, nsamples: int, generators=None):
        n, gens = _split_samples(mesh, nsamples, generators)
        t = mesh.broadcast(state.tensors)
        m = mesh.broadcast(state.messages)
        outs = [sampler(BatchedState(ti, mi), n, g)
                for ti, mi, g in zip(t, m, gens)]
        return (mesh.collect([o[0] for o in outs]),
                mesh.collect([o[1] for o in outs]))

    return sharded
