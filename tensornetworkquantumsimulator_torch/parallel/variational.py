"""Gradient-based variational ground states on the batched engine.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.
variational``: PyTorch autograd differentiates the BP energy functional

    E(psi) = sum_t c_t * <psi|h_t|psi>_BP / <psi|psi>_BP

end to end — through a fixed number of flooding-BP sweeps, the per-site /
per-bond environment contractions and the normalization quotients — and a
``torch.optim`` optimizer minimizes it over the vertex tensors.

Design notes:

- BP runs a fixed number of sweeps (:func:`bp_sweeps`, a Python loop over
  ``engine.bp_iteration``), not ``engine.bp_update``'s tolerance loop.  The
  reference wraps each sweep in ``jax.checkpoint``; here every sweep's
  intermediates stay on the autograd tape, since the states this path runs
  (χ ≤ 4 on the 5×5 grid and on Eagle-127) hold well under a gigabyte of
  tape, so no ``torch.utils.checkpoint`` is used.
- Every energy evaluation warm-starts from the previous step's messages,
  detached (the reference's ``stop_gradient``): gradients see a fixed
  number of refinement sweeps from an already-converged point.
- Complex states are optimized as complex parameters.  ``torch.optim.Adam``
  treats a complex parameter as its (re, im) pair, elementwise, and the
  gradient autograd returns for a real loss is ∂E/∂re + i·∂E/∂im: the same
  steps as the reference's optax Adam over (re, im) float leaves
  (``_split_params``).
- With ``TNQS_BP_KERNEL=1`` the outgoing messages of a degree-3 state take
  the einsum chain while autograd records (``engine._outgoing_messages``):
  K3 has no backward.  The same energy under ``torch.no_grad()`` takes K3.
- The step loop is a Python loop with no host read inside: the energies
  stay on the device until the caller reads them.
- :func:`ensemble_ground_state` folds E realizations into the vertex axis
  of one state (a graph of E disjoint copies) and minimizes the sum of the
  member energies: the members share every launch, and since Adam is
  elementwise each member takes the steps of its own single run.

Entry points take their device from the state they are given.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .engine import (
    BatchedState,
    bond_expectations,
    bp_iteration,
    graph_tables,
    identity_messages,
    local_expectations,
)
from .structure import BatchedGraphSpec


class Hamiltonian(NamedTuple):
    """Sum of 1-site and nearest-neighbor 2-site terms.

    site_terms: tuple of (op [d,d], coeffs) — coeffs broadcastable to [V]
    bond_terms: tuple of (op_u [d,d], op_v [d,d], coeffs) — coeffs
        broadcastable to [num_edges], in ``spec.edges`` order.
    """

    site_terms: tuple
    bond_terms: tuple


def tfim_hamiltonian(J: float = 1.0, hx: float = 3.0) -> Hamiltonian:
    """H = -J sum_<ij> Z_i Z_j - hx sum_i X_i (the reference's
    `examples/2dIsing_dynamics.jl:41-70` Hamiltonian)."""
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    z = np.array([[1.0, 0.0], [0.0, -1.0]])
    return Hamiltonian(
        site_terms=((x, -hx),),
        bond_terms=((z, z, -J),),
    )


def heisenberg_hamiltonian(Jx: float = 1.0, Jy: float = 1.0, Jz: float = 1.0) -> Hamiltonian:
    """H = sum_<ij> Jx X_i X_j + Jy Y_i Y_j + Jz Z_i Z_j.

    Y is imaginary, so states must be complex."""
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    y = np.array([[0.0, -1.0j], [1.0j, 0.0]])
    z = np.array([[1.0, 0.0], [0.0, -1.0]])
    return Hamiltonian(
        site_terms=(),
        bond_terms=((x, x, Jx), (y, y, Jy), (z, z, Jz)),
    )


def bp_sweeps(
    spec: BatchedGraphSpec,
    state: BatchedState,
    num_sweeps: int,
    damping: float = 0.0,
    tables=None,
) -> BatchedState:
    """``num_sweeps`` flooding-BP sweeps as a loop autograd can cross (the
    differentiable counterpart of `engine.bp_update`'s tolerance loop;
    semantics follow `abstractbeliefpropagationcache.jl:198-222` with a
    fixed iteration budget instead of a tolerance exit)."""
    if tables is None:
        tables = graph_tables(spec, state.tensors.device)
    msgs = state.messages
    for _ in range(num_sweeps):
        new = bp_iteration(spec, BatchedState(state.tensors, msgs), tables)
        if damping:
            new = damping * msgs + (1.0 - damping) * new
        msgs = new
    return BatchedState(state.tensors, msgs)


def _coefficients(coeffs, vals: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(coeffs), device=vals.device).to(
        vals.real.dtype)


def _member_energies(spec: BatchedGraphSpec, ham: Hamiltonian,
                     state: BatchedState, members: int = 1) -> torch.Tensor:
    """[members] BP energies of ``members`` copies of a graph folded into
    ``spec`` (member-major vertices and edges; 1: the plain energy)."""
    e = torch.zeros((members,), dtype=state.tensors.real.dtype,
                    device=state.tensors.device)
    for op, coeffs in ham.site_terms:
        vals = local_expectations(spec, state, op)
        terms = (_coefficients(coeffs, vals) * vals).real
        e = e + terms.reshape(members, -1).sum(-1)
    for op_u, op_v, coeffs in ham.bond_terms:
        vals = bond_expectations(spec, state, op_u, op_v)
        terms = (_coefficients(coeffs, vals) * vals).real
        e = e + terms.reshape(members, -1).sum(-1)
    return e


def energy(spec: BatchedGraphSpec, ham: Hamiltonian, state: BatchedState):
    """BP energy functional: every term is an independently normalized BP
    expectation (`expect.jl:58-83` batched over sites/edges)."""
    return _member_energies(spec, ham, state)[0]


def make_energy_fn(
    spec: BatchedGraphSpec,
    ham: Hamiltonian,
    bp_sweeps_per_eval: int = 15,
    damping: float = 0.0,
) -> Callable:
    """fn(tensors, messages0) -> (energy, converged_messages).

    ``messages0`` is the warm start; gradients flow through the
    ``bp_sweeps_per_eval`` refinement sweeps and the expectation
    quotients, not into the warm start itself (detached)."""
    return _energy_fn(spec, ham, bp_sweeps_per_eval, damping, 1)


def _energy_fn(spec, ham, sweeps, damping, members):
    """fn(tensors, messages0) -> ([members] energies, messages), with the
    graph tables built once per device."""
    tables: dict = {}

    def fn(tensors, messages0):
        dev = tensors.device
        if dev not in tables:
            tables[dev] = graph_tables(spec, dev)
        st = BatchedState(tensors, messages0.detach())
        st = bp_sweeps(spec, st, sweeps, damping, tables[dev])
        e = _member_energies(spec, ham, st, members)
        return (e[0] if members == 1 else e), st.messages

    return fn


def _optimizer(optimizer, params: list, learning_rate: float):
    if optimizer is None:
        return torch.optim.Adam(params, lr=learning_rate)
    return optimizer(params)


def _descend(efn, tensors, messages, steps, learning_rate, optimizer):
    """``steps`` optimizer steps on ``tensors`` against ``efn``'s energy
    (summed over members).  Returns (tensors, messages, energies [steps]
    or [steps, members])."""
    params = tensors.detach().clone().requires_grad_(True)
    opt = _optimizer(optimizer, [params], learning_rate)
    msgs = messages.detach()
    energies = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        e, new_msgs = efn(params, msgs)
        e.sum().backward()
        opt.step()
        energies.append(e.detach())
        msgs = new_msgs.detach()
    return params.detach(), msgs, torch.stack(energies)


def ground_state(
    spec: BatchedGraphSpec,
    state: BatchedState,
    ham: Hamiltonian,
    steps: int = 300,
    learning_rate: float = 3e-2,
    optimizer=None,
    bp_sweeps_per_eval: int = 15,
    damping: float = 0.0,
):
    """Direct energy minimization: optimizer steps on the vertex tensors
    against the BP energy functional.

    ``optimizer`` is None (``torch.optim.Adam`` at ``learning_rate``) or a
    callable ``params -> torch.optim.Optimizer``.  Returns
    ``(optimized_state, energies)`` where ``energies[i]`` is the BP energy
    at step ``i`` (a tensor of length ``steps`` on the state's device).
    The final state's messages are the last converged BP fixed point, so
    measurement functions can use it directly."""
    efn = make_energy_fn(spec, ham, bp_sweeps_per_eval, damping)
    tensors, msgs, energies = _descend(efn, state.tensors, state.messages,
                                       steps, learning_rate, optimizer)
    return BatchedState(tensors, msgs), energies


def excited_state(
    spec: BatchedGraphSpec,
    state: BatchedState,
    ham: Hamiltonian,
    below,
    weight: float = 10.0,
    steps: int = 300,
    learning_rate: float = 3e-2,
    optimizer=None,
    bp_sweeps_per_eval: int = 15,
    damping: float = 0.0,
):
    """Variational excited states by overlap-penalized energy descent.

    Minimizes ``E_BP(ψ) + weight · Σ_k |⟨ψ_k|ψ⟩|²/(⟨ψ_k|ψ_k⟩⟨ψ|ψ⟩)``
    over the vertex tensors, where ``below`` is a list of previously
    optimized :class:`BatchedState`\\ s (typically ``[ground]``): the
    energy through :func:`make_energy_fn`'s BP sweeps, the overlaps
    through :func:`~.overlap.sandwich_sweeps` and
    :func:`~.overlap.sandwich_logz`, with warm-started (detached) message
    states carried from step to step.

    Returns ``(optimized_state, energies, penalties)``: the converged
    penalty trajectory diagnoses orthogonality (→ 0 when the optimizer
    leaves the spanned subspace)."""
    from .overlap import sandwich_logz, sandwich_sweeps

    dev = state.tensors.device
    tables = graph_tables(spec, dev)
    efn = _energy_fn(spec, ham, bp_sweeps_per_eval, damping, 1)
    chi = state.chi
    below_conj = [b.tensors.conj() for b in below]

    # constant log <psi_k|psi_k> (no gradients flow here): the converged
    # self-sandwich at each below state's own messages
    with torch.no_grad():
        lkk = torch.stack([
            sandwich_logz(spec, b.tensors, bc, sandwich_sweeps(
                spec, b.tensors, bc, b.messages, 40, damping, tables))[0]
            for b, bc in zip(below, below_conj)
        ])

    params = state.tensors.detach().clone().requires_grad_(True)
    opt = _optimizer(optimizer, [params], learning_rate)
    msgs = state.messages.detach()
    pmsgs = [identity_messages(spec.num_vertices, spec.degree, chi,
                               state.tensors.dtype, dev) for _ in below]
    energies, penalties = [], []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        e, new_msgs = efn(params, msgs)
        # log <psi|psi> from the SAME refreshed norm messages
        lpp, _ = sandwich_logz(spec, params, params.conj(), new_msgs)
        pen = torch.zeros((), dtype=e.dtype, device=dev)
        new_pmsgs = []
        for k, bc in enumerate(below_conj):
            pk = sandwich_sweeps(spec, params, bc, pmsgs[k].detach(),
                                 bp_sweeps_per_eval, damping, tables)
            l0k, _ = sandwich_logz(spec, params, bc, pk)
            pen = pen + torch.exp(2.0 * l0k - lkk[k] - lpp).to(e.dtype)
            new_pmsgs.append(pk)
        (e + weight * pen).backward()
        opt.step()
        energies.append(e.detach())
        penalties.append(pen.detach())
        msgs = new_msgs.detach()
        pmsgs = [p.detach() for p in new_pmsgs]
    return (
        BatchedState(params.detach(), msgs),
        torch.stack(energies),
        torch.stack(penalties),
    )


def _member_spec(spec: BatchedGraphSpec, members: int) -> BatchedGraphSpec:
    """``members`` disjoint copies of the graph as one spec: member e's
    vertex v is row e·V + v, its edges follow in ``spec.edges`` order."""
    V = spec.num_vertices
    return BatchedGraphSpec(
        vertices=tuple((e, v) for e in range(members) for v in spec.vertices),
        degree=spec.degree,
        nbr=tuple(tuple(e * V + n for n in row)
                  for e in range(members) for row in spec.nbr),
        nbr_slot=spec.nbr_slot * members,
        slot_mask=spec.slot_mask * members,
        color_groups=(),
        edges=tuple((e * V + iu, e * V + iv, su, sv)
                    for e in range(members) for (iu, iv, su, sv) in spec.edges),
    )


def ensemble_ground_state(
    spec: BatchedGraphSpec,
    estate: BatchedState,
    ham: Hamiltonian,
    steps: int = 300,
    learning_rate: float = 3e-2,
    optimizer=None,
    bp_sweeps_per_eval: int = 15,
    damping: float = 0.0,
):
    """:func:`ground_state` for E disorder realizations of the Hamiltonian
    in one folded program.

    ``estate`` carries a leading ensemble axis (see
    :func:`~.ensemble.stack_states`).  Coefficients in ``ham`` are either
    *per-realization* — an array with an explicit leading ensemble axis
    ``[E, ...]``, e.g. random per-site fields ``[E, V]`` or per-edge
    couplings ``[E, num_edges]`` — or *shared*: a scalar, or an array
    broadcastable to ``[V]``/``[num_edges]`` whose leading dim is not
    ``E`` (it is tiled across realizations).  The one ambiguous shape —
    a 1-D array of length ``E`` when ``E`` equals the per-term size —
    raises; disambiguate with ``[E, 1]`` or an explicit ``[E, n]``.

    The E members fold into one state of E·V vertices whose loss is the
    sum of the member energies; the optimizer (elementwise, as Adam is)
    moves each member as its single run would.  Returns
    ``(estate, energies[E, steps])``."""
    E = estate.tensors.shape[0]
    V = estate.tensors.shape[1]
    n_edges = len(spec.edges)

    def prep(c, n, what):
        c = np.asarray(c)
        if c.ndim == 0:
            return np.broadcast_to(c, (E,)).copy()
        if c.ndim == 1 and c.shape[0] == E == n:
            raise ValueError(
                f"{what} coefficient of shape ({E},) is ambiguous: "
                f"ensemble size E={E} equals the per-term size n={n}; "
                f"pass [E, 1] for per-realization scalars or [E, {n}] "
                "explicitly"
            )
        if c.shape[0] == E:
            return c  # per-realization (leading ensemble axis)
        # shared across the ensemble: tile a [n]-broadcastable array
        return np.broadcast_to(c, (E,) + c.shape)

    def folded(c, n):
        """Member e's coefficients broadcast to [n], stacked member-major."""
        return np.concatenate([np.broadcast_to(c[e], (n,)) for e in range(E)])

    fham = Hamiltonian(
        tuple((op, folded(prep(c, V, "site"), V))
              for op, c in ham.site_terms),
        tuple((ou, ov, folded(prep(c, n_edges, "bond"), n_edges))
              for ou, ov, c in ham.bond_terms),
    )
    efn = _energy_fn(_member_spec(spec, E), fham, bp_sweeps_per_eval,
                     damping, E)
    tensors, msgs, energies = _descend(
        efn, estate.tensors.flatten(0, 1), estate.messages.flatten(0, 1),
        steps, learning_rate, optimizer)
    out = BatchedState(tensors.unflatten(0, (E, V)),
                       msgs.unflatten(0, (E, V)))
    return out, energies.reshape(steps, E).T
