"""Sampling bitstrings from tensor-network states (`src/sampling.jl`).

The counterpart of ``tensornetworkquantumsimulator_tpu.sampling``.  Three
entry points mirroring the reference:
- :func:`sample` — bitstrings only (`sampling.jl:112-117`)
- :func:`sample_directly_certified` — p/q computed on the fly (`:157-162`)
- :func:`sample_certified` — independent re-contraction certification (`:202-207`)

The BP sampler conditions vertex-by-vertex, re-running BP after each
projection; the boundary-MPS sampler sweeps partitions, pushing the
projected MPS through with `generic_apply` and accumulating log q and the
first-trace p/q estimate.

Draws.  Where the JAX package draws from a module numpy generator, the
samplers here take ``generator=`` (a ``torch.Generator``; None: the module
generator, which :func:`seed_sampler` seeds).  Every draw goes through
:func:`_draw`, so a test can force a chain of outcomes.  The conditional
probabilities are copied to the host once per vertex, as the JAX package
reads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .engines.beliefpropagation import BeliefPropagationCache
from .engines.boundarymps import BoundaryMPSCache, PartitionEdge
from .engines.mps import generic_apply, merge_internal_tensors, mps_truncate
from .gauge import gauge_and_scale, symmetrize_and_normalize
from .models.tensornetwork import TensorNetworkState
from .ops.paths import contraction_sequence
from .ops.tensor import Tensor, constant, contract, contract_pair, onehot
from .utils.checks import algorithm_check
from .utils.graphs import NamedEdge

# the module generator (a CPU generator: draws are taken on the host)
_GENERATOR = torch.Generator().manual_seed(0)


def seed_sampler(n: int):
    _GENERATOR.manual_seed(int(n))


def _draw(probs: np.ndarray, generator: torch.Generator | None) -> int:
    """One categorical draw from normalized host probabilities."""
    p = torch.from_numpy(np.ascontiguousarray(probs, dtype=np.float64))
    g = generator if generator is not None else _GENERATOR
    return int(torch.multinomial(p, 1, generator=g)[0])


def _sample_weights(probs, generator=None) -> int:
    probs = np.clip(np.asarray(probs, dtype=np.float64), 0.0, None)
    total = probs.sum()
    if total <= 0:
        raise ValueError("degenerate sampling distribution")
    return _draw(probs / total, generator)


def _local_rdm(cache, v):
    tensors = cache.incoming_messages(v)
    psiv = cache.network()[v]
    tensors = tensors + [psiv, psiv.dag().prime()]
    seq = contraction_sequence(tensors, alg="optimal")
    return contract(tensors, seq)


def _rho_diag_probs(rho: Tensor):
    s_inds = [i for i in rho.inds if i.plev == 0]
    s = s_inds[0]
    arr = rho.numpy((s, s.prime()))  # the one host read of the vertex
    tr = np.trace(arr)
    diag = np.real(np.diagonal(arr)) / np.real(tr)
    return s, diag, tr


def _sample_bp(
    psi: TensorNetworkState,
    nsamples: int,
    bp_update_kwargs: dict | None = None,
    gauge_state: bool = True,
    generator: torch.Generator | None = None,
    **kwargs,
):
    """Sequential conditional BP sampling (`sampling.jl:3-46`)."""
    bp_cache = BeliefPropagationCache(psi).update(**(bp_update_kwargs or {}))
    if gauge_state:
        bp_cache = symmetrize_and_normalize(bp_cache)
    results = []
    vertices = psi.vertices()
    for _ in range(nsamples):
        projected = bp_cache.copy()
        bitstring = {}
        for k, v in enumerate(vertices):
            rho = _local_rdm(projected, v)
            s, probs, _tr = _rho_diag_probs(rho)
            config = _sample_weights(probs, generator)
            bitstring[v] = config
            p = onehot(s, config, dtype=projected.scalartype(),
                       device=projected.network().device())
            projected.setindex_preserve(
                contract_pair(projected.network()[v], p), v
            )
            if k != len(vertices) - 1:
                projected = projected.update(**(bp_update_kwargs or {}))
        results.append(dict(bitstring=bitstring))
    return results, psi


def _sample_boundarymps(
    psi: TensorNetworkState,
    nsamples: int,
    projected_mps_bond_dimension: int,
    norm_mps_bond_dimension: int,
    norm_cache_message_update_kwargs: dict | None = None,
    partition_by: str = "row",
    gauge_state: bool = True,
    generator: torch.Generator | None = None,
    **kwargs,
):
    """Boundary-MPS sampling (`sampling.jl:48-75`)."""
    cache = BoundaryMPSCache(
        psi, norm_mps_bond_dimension, gauge_state=gauge_state, partition_by=partition_by
    )
    pg = cache.partitions_graph()
    leaves = pg.leaf_vertices()
    seq = [PartitionEdge(e.src, e.dst) for e in pg.a_star(leaves[-1], leaves[0])]
    upd = dict(norm_cache_message_update_kwargs or {})
    upd["normalize"] = False
    cache = cache.update(
        edge_sequence=seq, maxiter=1, message_update_alg="orthogonal", **upd
    )
    results = []
    for _ in range(nsamples):
        poverq, logq, bits = _get_one_sample(
            cache, seq, projected_mps_bond_dimension=projected_mps_bond_dimension,
            generator=generator,
        )
        results.append(dict(poverq=poverq, logq=logq, bitstring=bits))
    return results, psi


def _get_one_sample(
    norm_cache: BoundaryMPSCache, seq, projected_mps_bond_dimension: int,
    generator: torch.Generator | None = None,
):
    """`sampling.jl:209-255`."""
    cache = norm_cache.copy()
    cutoff, maxdim = 1.0e-10, projected_mps_bond_dimension
    bitstring: dict = {}
    p_over_q = None
    logq = 0.0
    partitions = [e.dst for e in reversed(seq)] + [seq[0].src]
    incoming_mps = None
    for i, partition in enumerate(partitions):
        pq, _logq, bitstring = _sample_partition(cache, partition, bitstring,
                                                 generator)
        p_over_q = pq  # the reference keeps the latest partition's first
        # trace (`sampling.jl:227-231`)
        logq += _logq
        if i < len(partitions) - 1:
            next_partition = partitions[i + 1]
            pe = PartitionEdge(partition, next_partition)
            mpo = [cache.network()[v] for v in cache.partition_vertices(partition)]
            if incoming_mps is None:
                out = mps_truncate(
                    merge_internal_tensors(mpo), maxdim=maxdim, cutoff=cutoff
                )
            else:
                out = generic_apply(
                    mpo, incoming_mps, normalize=False, maxdim=maxdim, cutoff=cutoff
                )
            es = cache.sorted_edges(pe)
            if len(out) != len(es):
                raise RuntimeError("projected strand length mismatch")
            for k, e in enumerate(es):
                cache.setmessage(e, [out[k], out[k].dag().prime()])
            incoming_mps = out
        if i > 1:
            cache.delete_interpartition_messages_inplace(
                PartitionEdge(partitions[i - 2], partitions[i - 1])
            )
    return p_over_q, logq, bitstring


def _sample_partition(cache: BoundaryMPSCache, partition, bitstring: dict,
                      generator: torch.Generator | None = None):
    """Sequential conditional sampling inside one partition
    (`sampling.jl:258-298`)."""
    g = cache.partition_graph(partition)
    if g.nv() == 1:
        seq, vs = [], g.vertices()
    else:
        leaves = g.leaf_vertices()
        seq = g.a_star(leaves[-1], leaves[0])
        cache.update_partition_inplace(seq)
        vs = [e.dst for e in reversed(seq)] + [leaves[-1]]
    prev_v = None
    traces = []
    logq = 0.0
    for v in vs:
        if prev_v is not None:
            cache.update_partition_inplace([NamedEdge(prev_v, v)])
        rho = _local_rdm(cache, v)
        s, probs, tr = _rho_diag_probs(rho)
        traces.append(tr)
        config = _sample_weights(probs, generator)
        bitstring[v] = config
        q = probs[config]
        logq += math.log(q)
        p = onehot(s, config, dtype=cache.scalartype(),
                   device=cache.network().device())
        new_t = contract_pair(cache.network()[v], p) * (1.0 / math.sqrt(q))
        cache.setindex_preserve(new_t, v)
        prev_v = v
    cache.delete_partition_messages_inplace(partition)
    return traces[0], logq, bitstring


# ---------------------------------------------------------------------------
# density-matrix (noisy-state) sampling
# ---------------------------------------------------------------------------


def sample_density_matrix(
    rho: TensorNetworkState,
    nsamples: int,
    bp_update_kwargs: dict | None = None,
    generator: torch.Generator | None = None,
):
    """Draw computational-basis bitstrings from a density-matrix
    ("PauliRho") coefficient network (`models/channels.py`).

    No reference counterpart (the reference samples wavefunctions only,
    `sampling.jl:3-46`); the same sequential conditional scheme applies
    through the LINEAR functional Tr[ρ·⊗Π]: the flat network with site
    legs dotted by the trace vector [1,0,0,0] contracts to Tr[ρ], the
    diagonal projector Π_b = (I+(−1)ᵇZ)/2 is the site vector
    [1,0,0,(−1)ᵇ]/2, and conditioning on sampled bits is exactly
    re-dotting their site legs — Tr[Π_b ρ Π_b ⊗ O] = Tr[ρ (Π_b ⊗ O)].
    BP runs on the flat network (tree-exact, like the wavefunction
    sampler), re-updated after each projection.

    Returns a list of ``{"bitstring": {v: 0|1}, "logp": float}`` where
    ``logp`` is the log of the product of conditional probabilities — the
    telescoped value is ``log(⟨x|ρ|x⟩ / Tr ρ)`` whenever BP is exact on
    the graph (equal to log ⟨x|ρ|x⟩ only for trace-normalized states;
    per-gate tensor rescaling during evolution changes Tr ρ).
    """
    from .models.tensornetwork import TensorNetwork

    upd = dict(bp_update_kwargs or {})
    g = rho.graph()
    verts = rho.vertices()
    site_of = {v: rho.siteinds(v)[0] for v in verts}
    dt, dev = rho.scalartype(), rho.device()
    if any(site_of[v].dim != 4 for v in verts):
        raise ValueError("sample_density_matrix needs Pauli-4 ('PauliRho') sites")

    def _dotted(v, vec):
        data = constant(("pauli4", tuple(vec)), lambda: np.asarray(vec), dt,
                        dev)
        return contract_pair(rho[v], Tensor(data, (site_of[v],)))

    trace_net = TensorNetwork({v: _dotted(v, [1.0, 0, 0, 0]) for v in verts}, g.copy())
    base = BeliefPropagationCache(trace_net).update(**upd)

    results = []
    for _ in range(nsamples):
        projected = base.copy()
        bitstring: dict = {}
        logp = 0.0
        for k, v in enumerate(verts):
            msgs = projected.incoming_messages(v)
            # re-dot ρ_v's open site leg with both projectors and take the
            # local scalars as (unnormalized) conditional weights
            weights = []
            for b in (0, 1):
                t = _dotted(v, [0.5, 0, 0, 0.5 * (1 - 2 * b)])
                seq = contraction_sequence(msgs + [t], alg="optimal")
                weights.append(np.real(contract(msgs + [t], seq).scalar()))
            # the two weights share one (possibly negative-scaled) flat-BP
            # environment; only their ratio is meaningful
            total = weights[0] + weights[1]
            if total == 0.0:
                raise ValueError("degenerate sampling distribution")
            probs = [w / total for w in weights]
            config = _sample_weights(probs, generator)
            bitstring[v] = config
            logp += math.log(max(probs[config], 1e-300))
            projected.setindex_preserve(
                _dotted(v, [0.5, 0, 0, 0.5 * (1 - 2 * config)]), v
            )
            if k != len(verts) - 1:
                projected = projected.update(**upd)
        results.append(dict(bitstring=bitstring, logp=logp))
    return results


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def sample(psi: TensorNetworkState, nsamples: int, alg: str = None, **kwargs):
    """Draw bitstrings (`sampling.jl:112-117`).  Returns a list of
    {vertex: 0..d-1} dicts.  ``generator=`` picks the draws' generator."""
    try:
        s0 = psi.siteinds(psi.vertices()[0])[0]
    except (IndexError, KeyError):
        s0 = None
    if s0 is not None and s0.hastag("PauliRho"):
        raise ValueError(
            "wavefunction samplers square the state; density-matrix "
            "('PauliRho') networks sample from diag(rho) via "
            "sample_density_matrix(rho, n)"
        )
    algorithm_check(psi, "sample", alg)
    results, _ = _sample_impl(alg, psi, nsamples, **kwargs)
    return [r["bitstring"] for r in results]


def _sample_impl(alg, psi, nsamples, **kwargs):
    kwargs.pop("gauge_and_scale", None)  # tolerated, as in the reference
    if alg == "bp":
        return _sample_bp(psi, nsamples, **kwargs)
    if alg == "boundarymps":
        return _sample_boundarymps(psi, nsamples, **kwargs)
    raise ValueError(f"unknown sampling alg {alg!r}")


def sample_directly_certified(
    psi: TensorNetworkState,
    nsamples: int,
    alg: str = None,
    projected_mps_bond_dimension: int | None = None,
    **kwargs,
):
    """Samples with on-the-fly p/q certification (`sampling.jl:157-162`)."""
    algorithm_check(psi, "sample", alg)
    if projected_mps_bond_dimension is None:
        projected_mps_bond_dimension = 5 * psi.maxvirtualdim()
    results, _ = _sample_impl(
        alg,
        psi,
        nsamples,
        projected_mps_bond_dimension=projected_mps_bond_dimension,
        **kwargs,
    )
    return results


def sample_certified(
    psi: TensorNetworkState,
    nsamples: int,
    alg: str = None,
    certification_mps_bond_dimension: int | None = None,
    certification_cache_message_update_kwargs: dict | None = None,
    **kwargs,
):
    """Samples certified by independent re-contraction of |⟨x|ψ⟩|²/q
    (`sampling.jl:202-207, 300-332`)."""
    algorithm_check(psi, "sample", alg)
    if certification_mps_bond_dimension is None:
        certification_mps_bond_dimension = 5 * psi.maxvirtualdim()
    results, psi = _sample_impl(alg, psi, nsamples, **kwargs)
    return certify_samples(
        psi,
        results,
        alg=alg,
        certification_mps_bond_dimension=certification_mps_bond_dimension,
        certification_cache_message_update_kwargs=certification_cache_message_update_kwargs,
        gauge_state=False,
    )


def certify_samples(psi, results, alg="boundarymps", **kwargs):
    return [
        certify_sample(psi, r["bitstring"], r["logq"], **kwargs) for r in results
    ]


def certify_sample(
    psi: TensorNetworkState,
    bitstring: dict,
    logq: float,
    certification_mps_bond_dimension: int,
    certification_cache_message_update_kwargs: dict | None = None,
    gauge_state: bool = True,
):
    """`sampling.jl:300-332`: project ψ onto the bitstring and contract
    |⟨x|ψ⟩|²/q with a fresh flat boundary-MPS cache."""
    if gauge_state:
        psi = gauge_and_scale(psi)
    psi_proj = psi.tensornetwork().copy()
    s = psi.siteinds()
    nv = len(psi.vertices())
    qv = math.sqrt(math.exp(logq / nv))
    dtype = psi.scalartype()
    for v in psi.vertices():
        p = onehot(s[v][0], bitstring[v], dtype=dtype, device=psi.device())
        psi_proj.setindex_preserve(
            contract_pair(psi_proj[v], p) * (1.0 / qv), v
        )
    cache = BoundaryMPSCache(psi_proj, certification_mps_bond_dimension)
    upd = dict(certification_cache_message_update_kwargs or {})
    upd.setdefault("normalize", False)
    cache = cache.update(message_update_alg="ITensorMPS", **upd)
    poverq = cache.partitionfunction()
    poverq = poverq * np.conj(poverq)
    return dict(poverq=float(np.real(poverq)), bitstring=bitstring)
