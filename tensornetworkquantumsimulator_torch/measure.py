"""Measurement layer: `expect`, `norm_sqr`, `inner`, `reduced_density_matrix`.

The counterpart of ``tensornetworkquantumsimulator_tpu.measure``
(`src/expect.jl`, `src/norm_sqr.jl`, `src/inner.jl`, `src/rdm.jl`).
Observables are tuples ``(op_string(s), vertices, coeff=1)``; every backend
("exact", "bp", "boundarymps", "loopcorrections") shares the
`norm_factors`-based numerator/denominator construction.
:func:`collectobservable` also parses the batched engine's observables.
"""

from __future__ import annotations

import numpy as np

from .engines.beliefpropagation import (
    BeliefPropagationCache,
    default_bp_update_kwargs,
)
from .models.forms import BilinearForm
from .models.tensornetwork import TensorNetwork, TensorNetworkState
from .ops.paths import contraction_sequence
from .ops.tensor import Tensor, constant, contract, delta
from .utils.checks import algorithm_check, collect_vertices, default_alg
from .utils.graphs import NamedGraph


# ---------------------------------------------------------------------------
# observables
# ---------------------------------------------------------------------------


def collectobservable(obs: tuple, g: NamedGraph):
    """Parse ``(ops, vertices[, coeff])`` (`expect.jl:160-176`)."""
    coeff = 1 if len(obs) == 2 else obs[-1]
    verts = collect_vertices(obs[1], g)
    op = obs[0]
    if isinstance(op, str):
        op_strings = list(op)
    elif isinstance(op, (list, tuple)) and all(isinstance(o, str) for o in op):
        op_strings = list(op)
    else:
        raise ValueError(
            "Invalid observable: expected a string (one pauli character per "
            "vertex) or a list of strings (one per vertex)."
        )
    if len(op_strings) != len(verts):
        raise ValueError("Invalid observable: need as many operators as vertices.")
    return op_strings, verts, coeff


def observables_vertices(observable, g: NamedGraph):
    if isinstance(observable, tuple):
        return collect_vertices(observable[1], g)
    out = []
    for obs in observable:
        for v in collect_vertices(obs[1], g):
            if v not in out:
                out.append(v)
    return out


def _first(v):
    return v[0] if isinstance(v, tuple) else v


def _last(v):
    return v[-1] if isinstance(v, tuple) else v


def boundarymps_partitioning(observable, g: NamedGraph) -> str:
    """Row vs column partitioning so each observable stays inside one
    partition (`expect.jl:181-195`)."""
    observables = [observable] if isinstance(observable, tuple) else list(observable)
    partitioning = None
    for o in observables:
        vs = observables_vertices(o, g)
        if all(_first(v) == _first(vs[0]) for v in vs) and partitioning in ("row", None):
            partitioning = "row"
        elif all(_last(v) == _last(vs[0]) for v in vs) and partitioning in ("col", None):
            partitioning = "col"
        else:
            raise ValueError(
                "Observables must align in a single column or row for "
                "BoundaryMPS measurements."
            )
    return partitioning


# ---------------------------------------------------------------------------
# expect
# ---------------------------------------------------------------------------


def expect(psi, observable, alg: str | None = None, **kwargs):
    """⟨ψ|O|ψ⟩/⟨ψ|ψ⟩ with the chosen backend (`expect.jl:36-157`).

    Density-matrix ("PauliRho") networks route to `pauli_expectation`:
    the physical expectation there is the LINEAR functional Tr[ρP]/Tr[ρ],
    not the quadratic sandwich this function computes on wavefunctions."""
    if isinstance(psi, TensorNetworkState):
        try:
            s0 = psi.siteinds(psi.vertices()[0])[0]
        except (IndexError, KeyError):
            s0 = None
        if s0 is not None and s0.hastag("PauliRho"):
            return pauli_expectation(psi, observable, alg=alg, **kwargs)
    if alg is None:
        alg = default_alg(psi)
    algorithm_check(psi, "expect", alg)
    single = isinstance(observable, tuple)
    observables = [observable] if single else list(observable)
    out = _expect_impl(alg, psi, observables, **kwargs)
    return out[0] if single else out


def _expect_impl(alg, psi, observables, **kwargs):
    if alg == "exact":
        return _expect_exact(psi, observables, **kwargs)
    if alg == "bp":
        if isinstance(psi, TensorNetworkState):
            cache_update_kwargs = kwargs.pop(
                "cache_update_kwargs", None
            ) or default_bp_update_kwargs(psi)
            psi = BeliefPropagationCache(psi).update(**cache_update_kwargs)
        return [_expect_bp(psi, obs) for obs in observables]
    if alg == "boundarymps":
        from .engines.boundarymps import expect_boundarymps

        return expect_boundarymps(psi, observables, **kwargs)
    if alg == "loopcorrections":
        return _expect_loopcorrections(psi, observables, **kwargs)
    raise ValueError(f"unknown alg {alg!r}")


def _expect_loopcorrections(
    psi, observables, max_configuration_size=4, **kwargs
):
    """Loop-corrected ⟨O⟩ = Z_O^loops / Z^loops, both series evaluated at
    the SINGLE norm-network BP fixed point (rescaled gauge, z_v = s_e = 1):

    - denominator = 1 + Σ leaf-free configurations (`loopcorrection.jl:3-16`);
    - numerator   = Π_v∈obs z_v^O  +  Σ configurations whose leaves (if
      any) sit on OBSERVABLE vertices — op-anchored excitation paths and
      tadpoles — each weighted by z_v^O for every observable vertex the
      configuration does not cover.

    The leaf relaxation is exactly the set of non-vanishing terms of the
    δ = m m̄ + (δ − m m̄) expansion of the op-inserted network at the norm
    fixed point: a configuration leaf at a NON-observable vertex is
    annihilated by the fixed-point condition, one at an op vertex is not.
    Re-converging a separate numerator cache (a per-observable BP run)
    both costs more and measures worse — it breaks the environment
    cancellation between numerator and denominator (measured on random
    3×3/χ=2 states: re-updated-cache ⟨Z⟩ landed 0.38 from exact where this
    series lands 0.005, with plain BP at 0.046).  The reference *exports*
    `expect_loopcorrect` (`TensorNetworkQuantumSimulator.jl:48`) but never
    defines it; this is the real implementation."""
    from .engines.loopcorrection import _weight
    from .models.forms import QuadraticForm
    from .utils.graphs import edgeinduced_subgraphs_no_leaves

    if not isinstance(psi, TensorNetworkState):
        raise TypeError("loop-corrected expect needs a TensorNetworkState")
    cache_update_kwargs = kwargs.pop(
        "cache_update_kwargs", None
    ) or default_bp_update_kwargs(psi)
    g = psi.graph()
    cache = BeliefPropagationCache(psi).update(**cache_update_kwargs)
    cache = cache.rescale()  # z_v = 1, s_e = 1 gauge; Z_BP drops out
    denom = 1 + sum(
        _weight(cache, eg)
        for eg in edgeinduced_subgraphs_no_leaves(g, max_configuration_size)
    )
    out = []
    for obs in observables:
        op_strings, vs, coeff = collectobservable(obs, g)
        if coeff == 0:
            out.append(0)
            continue
        qf = QuadraticForm(cache.network(), _op_string_fn(op_strings, vs))
        num_cache = BeliefPropagationCache(qf)
        for e in g.edges():
            num_cache.setmessage(e, cache.message(e))
            num_cache.setmessage(e.reverse(), cache.message(e.reverse()))
        z_ops = {v: num_cache.vertex_scalar(v) for v in vs}
        numer = np.prod(list(z_ops.values()))  # the empty configuration
        for eg in edgeinduced_subgraphs_no_leaves(
            g, max_configuration_size, allowed_leaves=vs
        ):
            mult = np.prod(
                [z_ops[v] for v in vs if not eg.has_vertex(v)] or [1.0]
            )
            numer = numer + _weight(num_cache, eg) * mult
        out.append(coeff * numer / denom)
    return out


def _expect_exact(psi: TensorNetworkState, observables, **kwargs):
    denom = norm_sqr(psi, alg="exact")
    g = psi.graph()
    out = []
    for obs in observables:
        op_strings, vs, coeff = collectobservable(obs, g)
        if coeff == 0:
            out.append(0)
            continue
        op_f = _op_string_fn(op_strings, vs)
        tensors = psi.norm_factors(psi.vertices(), op_strings=op_f)
        seq = contraction_sequence(tensors, alg="einexpr")
        numer = contract(tensors, seq).scalar()
        out.append(coeff * numer / denom)
    return out


def _op_string_fn(op_strings, vs):
    table = {v: o for v, o in zip(vs, op_strings)}
    return lambda v: table.get(v, "I")


def _expect_bp(cache: BeliefPropagationCache, obs):
    """Numerator/denominator over the Steiner tree connecting the observable
    vertices plus incoming messages (`expect.jl:58-83`)."""
    g = cache.graph()
    op_strings, obs_vs, coeff = collectobservable(obs, g)
    if coeff == 0:
        return 0
    if len(obs_vs) == 1:
        steiner_vs = obs_vs
    else:
        steiner_vs = cache.network().steiner_tree(obs_vs).vertices()

    incoming = cache.incoming_messages(list(steiner_vs))
    denom_tensors = cache.network().norm_factors(steiner_vs) + incoming
    seq = contraction_sequence(denom_tensors, alg="optimal")
    denom = contract(denom_tensors, seq).scalar()

    op_f = _op_string_fn(op_strings, obs_vs)
    numer_tensors = cache.network().norm_factors(steiner_vs, op_strings=op_f) + incoming
    seq = contraction_sequence(numer_tensors, alg="optimal")
    numer = contract(numer_tensors, seq).scalar()
    return coeff * numer / denom


# ---------------------------------------------------------------------------
# norm_sqr
# ---------------------------------------------------------------------------


def norm_sqr(psi, alg: str | None = None, **kwargs):
    """⟨ψ|ψ⟩ (`norm_sqr.jl:47-88`)."""
    if alg is None:
        alg = default_alg(psi)
    algorithm_check(psi, "norm_sqr", alg)

    if isinstance(psi, BeliefPropagationCache) or _is_bmps_cache(psi):
        return _norm_sqr_cache(alg, psi, **kwargs)

    if alg == "exact":
        tensors = psi.norm_factors(psi.vertices())
        seq = contraction_sequence(tensors, alg="einexpr")
        return contract(tensors, seq).scalar()
    if alg in ("bp", "loopcorrections"):
        cache_update_kwargs = kwargs.pop(
            "cache_update_kwargs", None
        ) or default_bp_update_kwargs(psi)
        cache = BeliefPropagationCache(psi).update(**cache_update_kwargs)
        return _norm_sqr_cache(alg, cache, **kwargs)
    if alg == "boundarymps":
        from .engines.boundarymps import BoundaryMPSCache

        mps_bond_dimension = kwargs.pop("mps_bond_dimension")
        partition_by = kwargs.pop("partition_by", "row")
        cache_update_kwargs = kwargs.pop("cache_update_kwargs", {})
        cache = BoundaryMPSCache(psi, mps_bond_dimension, partition_by=partition_by)
        cache = cache.update(**cache_update_kwargs)
        return _norm_sqr_cache(alg, cache, **kwargs)
    raise ValueError(f"unknown alg {alg!r}")


def _is_bmps_cache(psi):
    from .engines.boundarymps import BoundaryMPSCache

    return isinstance(psi, BoundaryMPSCache)


def _norm_sqr_cache(alg, cache, max_configuration_size=None, **kwargs):
    tn = cache.network()
    if alg in ("bp", "boundarymps"):
        z = cache.partitionfunction()
    elif alg == "loopcorrections":
        from .engines.loopcorrection import loopcorrected_partitionfunction

        z = loopcorrected_partitionfunction(cache, max_configuration_size)
    else:
        raise ValueError(f"unknown alg {alg!r}")
    if isinstance(tn, TensorNetworkState):
        return z
    if isinstance(tn, TensorNetwork):
        return z * z
    return z


def norm(psi, alg: str | None = None, **kwargs):
    z = norm_sqr(psi, alg=alg, **kwargs)
    out = np.sqrt(z)
    return complex(out) if np.iscomplexobj(out) else float(out)


# ---------------------------------------------------------------------------
# inner
# ---------------------------------------------------------------------------


def inner(psi: TensorNetworkState, phi: TensorNetworkState, alg: str, **kwargs):
    """⟨ψ|ϕ⟩ via a BilinearForm (`inner.jl:53-98`)."""
    algorithm_check(psi, "inner", alg)
    algorithm_check(phi, "inner", alg)
    blf = BilinearForm(psi, phi)
    if alg == "exact":
        tensors = blf.bp_factors(blf.vertices())
        seq = contraction_sequence(tensors, alg="einexpr")
        return contract(tensors, seq).scalar()
    if alg in ("bp", "loopcorrections"):
        cache_update_kwargs = kwargs.pop("cache_update_kwargs", {})
        cache = BeliefPropagationCache(blf).update(**cache_update_kwargs)
        if alg == "bp":
            return cache.partitionfunction()
        from .engines.loopcorrection import loopcorrected_partitionfunction

        return loopcorrected_partitionfunction(
            cache, kwargs.pop("max_configuration_size", None)
        )
    if alg == "boundarymps":
        from .engines.boundarymps import BoundaryMPSCache

        mps_bond_dimension = kwargs.pop("mps_bond_dimension")
        partition_by = kwargs.pop("partition_by", "row")
        cache_update_kwargs = kwargs.pop("cache_update_kwargs", {})
        cache = BoundaryMPSCache(blf, mps_bond_dimension, partition_by=partition_by)
        cache = cache.update(**cache_update_kwargs)
        return cache.partitionfunction()
    raise ValueError(f"unknown alg {alg!r}")


# ---------------------------------------------------------------------------
# Pauli-4 picture expectations (Heisenberg operators / density matrices)
# ---------------------------------------------------------------------------


def _pauli_weight_state(tns, vec_of):
    """Bond-dim-1 product state over ``tns``'s own Pauli-4 site indices,
    with per-vertex 4-vectors from ``vec_of(v)`` (host-side numpy)."""
    from .models.tensornetwork import tensornetworkstate

    dtype = next(iter(tns.tensors().values())).data.dtype
    return tensornetworkstate(dtype, vec_of, tns.graph(), tns.siteinds(),
                              device=tns.device())


def _pauli_ops_check(op_strings, obs):
    from .models.sites import PAULI_BASIS_STATES

    ops = [o.upper() for o in op_strings]
    bad = [o for o in ops if o not in PAULI_BASIS_STATES]
    if bad:
        raise ValueError(
            f"observable {obs!r}: Pauli-4 expectations take I/X/Y/Z "
            f"characters, got {bad}"
        )
    return ops


def pauli_expectation(rho, observable, alg: str | None = None, **kwargs):
    """⟨P_string⟩ = Tr[ρ P]/Tr[ρ] on a density-matrix ("PauliRho") network.

    ``observable`` follows the `expect` tuple format: ``(ops, verts[, coeff])``
    or a list thereof; ops are Pauli characters.  Tr[ρ P] is the LINEAR
    functional contracting ρ's coefficient network against per-site basis
    vectors (e_P on the support, e_I = trace elsewhere).  Under
    ``alg="bp"`` (default) ONE flat-network BP fixed point serves every
    observable: each value is a Steiner-tree numerator/denominator ratio
    at the shared messages, exactly mirroring the quadratic `expect`
    (`expect.jl:58-83`); other algs (exact/boundarymps/loopcorrections)
    evaluate each functional with `inner`.  No reference counterpart
    (the reference has no density-matrix picture)."""
    from .models.sites import PAULI_BASIS_STATES

    alg = alg if alg is not None else "bp"
    g = rho.graph()
    single = isinstance(observable, tuple)
    obs_list = [observable] if single else list(observable)

    if alg != "bp":
        trace = inner(
            _pauli_weight_state(rho, lambda v: "I"), rho, alg=alg, **dict(kwargs)
        )
        out = []
        for obs in obs_list:
            op_strings, verts, coeff = collectobservable(obs, g)
            at = dict(zip(verts, _pauli_ops_check(op_strings, obs)))
            w = _pauli_weight_state(
                rho, lambda v: PAULI_BASIS_STATES[at.get(v, "I")]
            )
            num = inner(w, rho, alg=alg, **dict(kwargs))
            out.append(coeff * num / trace)
        return out[0] if single else out

    # alg="bp": one flat-network fixed point shared by every observable
    from .models.tensornetwork import TensorNetwork
    from .ops.tensor import contract_pair

    verts = rho.vertices()
    site_of = {v: rho.siteinds(v)[0] for v in verts}
    if any(site_of[v].dim != 4 for v in verts):
        raise ValueError("pauli_expectation needs Pauli-4 ('PauliRho') sites")
    dt = rho.scalartype()
    dev = rho.device()

    def _dotted(v, vec):
        data = constant(("pauli4", tuple(vec)), lambda: np.asarray(vec), dt,
                        dev)
        return contract_pair(rho[v], Tensor(data, (site_of[v],)))

    flat = TensorNetwork(
        {v: _dotted(v, [1.0, 0, 0, 0]) for v in verts}, g.copy()
    )
    cache = BeliefPropagationCache(flat).update(
        **kwargs.pop("cache_update_kwargs", {})
    )
    out = []
    for obs in obs_list:
        op_strings, obs_vs, coeff = collectobservable(obs, g)
        ops = _pauli_ops_check(op_strings, obs)
        at = dict(zip(obs_vs, ops))
        if len(obs_vs) == 1:
            steiner_vs = list(obs_vs)
        else:
            steiner_vs = list(cache.network().steiner_tree(obs_vs).vertices())
        incoming = cache.incoming_messages(steiner_vs)
        denom_tensors = [cache.network()[v] for v in steiner_vs] + incoming
        seq = contraction_sequence(denom_tensors, alg="optimal")
        denom = contract(denom_tensors, seq).scalar()
        numer_tensors = [
            _dotted(v, PAULI_BASIS_STATES[at[v]]) if v in at
            else cache.network()[v]
            for v in steiner_vs
        ] + incoming
        seq = contraction_sequence(numer_tensors, alg="optimal")
        numer = contract(numer_tensors, seq).scalar()
        out.append(coeff * numer / denom)
    return out[0] if single else out


def heisenberg_expectation(op, initial_state="0", alg: str | None = None, **kwargs):
    """Tr[ρ₀ O] for a Heisenberg-picture ("Pauli") operator network.

    ``initial_state`` is a per-vertex product: a string, a callable
    ``v -> local``, or a dict — each local accepted by
    `sites.pauli_coefficients` (state strings, 2-vectors, 2×2 ρ, or Pauli
    4-vectors).  Wraps the ``inner(weights, op)`` pattern of
    `examples/2dIsing_dynamics_Heisenbergpicture.jl` as API."""
    from .models.sites import pauli_coefficients

    alg = alg if alg is not None else "bp"
    if callable(initial_state):
        f = initial_state
    elif isinstance(initial_state, dict):
        f = lambda v: initial_state[v]  # noqa: E731
    else:
        f = lambda v: initial_state  # noqa: E731
    w = _pauli_weight_state(op, lambda v: pauli_coefficients(f(v)))
    return inner(w, op, alg=alg, **kwargs)


def purity(rho, alg: str | None = None, **kwargs):
    """Tr[ρ²]/Tr[ρ]² of a density-matrix network: with ρ = ⊗-network of
    Pauli coefficients c, Tr[ρ²] = Σ_P c_P² / 2ⁿ = `norm_sqr`(c)/2ⁿ.
    The second Rényi entropy is −log₂ of this value."""
    alg = alg if alg is not None else "bp"
    n = len(rho.vertices())
    z = norm_sqr(rho, alg=alg, **dict(kwargs))
    trace = inner(_pauli_weight_state(rho, lambda v: "I"), rho, alg=alg, **dict(kwargs))
    return np.real(z) / (2.0**n) / np.real(trace) ** 2


# ---------------------------------------------------------------------------
# reduced density matrices
# ---------------------------------------------------------------------------


def normalize_rdm(rho: Tensor) -> Tensor:
    """Normalize to unit trace (`rdm.jl:1-8`)."""
    tr = rho
    for i in [i for i in rho.inds if i.plev == 0]:
        tr = tr * delta((i, i.prime()), dtype=rho.dtype, device=rho.device)
    return rho * (1.0 / tr.scalar())


def reduced_density_matrix(psi, verts, alg: str | None = None, normalize: bool = True, **kwargs):
    """RDM on a vertex set (`rdm.jl:24-115`)."""
    if alg is None:
        alg = default_alg(psi)
    algorithm_check(psi, "rdm", alg)
    g = psi.graph()
    verts = collect_vertices(verts, g)

    if alg == "exact":
        op_f = lambda v: "ρ" if v in verts else "I"
        tensors = psi.norm_factors(psi.vertices(), op_strings=op_f)
        seq = contraction_sequence(tensors, alg="einexpr")
        rho = contract(tensors, seq)
        return normalize_rdm(rho) if normalize else rho

    if alg == "bp":
        if isinstance(psi, TensorNetworkState):
            cache_update_kwargs = kwargs.pop(
                "cache_update_kwargs", None
            ) or default_bp_update_kwargs(psi)
            psi = BeliefPropagationCache(psi).update(**cache_update_kwargs)
        cache = psi
        steiner_vs = (
            verts
            if len(verts) == 1
            else cache.network().steiner_tree(verts).vertices()
        )
        op_f = lambda v: "ρ" if v in verts else "I"
        tensors = cache.network().norm_factors(steiner_vs, op_strings=op_f)
        tensors += cache.incoming_messages(list(steiner_vs))
        seq = contraction_sequence(tensors, alg="optimal")
        rho = contract(tensors, seq)
        return normalize_rdm(rho) if normalize else rho

    if alg == "boundarymps":
        from .engines.boundarymps import rdm_boundarymps

        return rdm_boundarymps(psi, verts, normalize=normalize, **kwargs)
    raise ValueError(f"unknown alg {alg!r}")


rdm = reduced_density_matrix
