"""Parametric Trotter layers and ensembles on PyTorch.

The counterpart of ``tensornetworkquantumsimulator_tpu.parallel.ensemble``:

- :func:`make_field_layer_fn` — a *parametric* Trotter layer
  ``layer(state, site_thetas, bond_thetas) -> (state, errors)`` whose
  rotation angles are runtime tensors, the gates built on the device in
  closed form (cos/sin, no ``expm``), so one module serves every field
  configuration: sweeps, annealing schedules, disorder, and the bench's
  rolled ``chi10_rolled`` configuration;
- :func:`make_noisy_field_layer_fn` — the same on density-matrix Pauli
  sites (d=4), with Pauli-transfer-matrix gates and the channel rates as
  runtime tensors too;
- :func:`ensemble_fn` / :func:`stack_states` — E realizations advancing as
  one batched program over stacked states ``[E, V, ...]``.

JAX vmaps the layer over the ensemble axis.  ``torch.func.vmap`` cannot
run the port's BP loop, which decides on the host after every sweep
whether to go on, so the ensemble axis is folded into the vertex axis
instead: the E member graphs become one graph of E·V vertices with
neighbour and bucket indices offset by e·V, every batched eigh, QR and
einsum grows its batch by E, and BP keeps a distance and an active flag
per member, so each member stops at its own sweep as under ``jax.vmap``
of ``lax.while_loop``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..devices import resolve_device
from ..models.gates import _kron_pauli
from ..utils.profiling import span
from .engine import (
    BatchedState,
    GraphTables,
    apply_color_group,
    apply_one_site,
    bp_update,
    fold_members,
    graph_tables,
    local_expectations,
    member_indices,
    member_tables,
    unfold_members,
)
from .structure import BatchedGraphSpec, SlotPairBucket, compile_graph
from .trotter import TrotterLayer


def _as_tensor(x, device=None) -> torch.Tensor:
    """An angle or rate as a tensor: a tensor keeps its dtype; anything
    else keeps its numpy dtype (a Python float is float64)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


@functools.lru_cache(maxsize=256)
def _constant(kind: str, key: str, device: torch.device, dtype: torch.dtype):
    """Host-built constants of the gate builders, copied to each device
    once: a Pauli string's matrix, or a PTM table stack [3, m, m]."""
    if kind == "pauli":
        arr = _kron_pauli(key)
    elif kind == "ptm":
        arr = np.stack(_ptm_rot_tables(key))
    else:
        raise ValueError(kind)
    return torch.as_tensor(arr, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# rotation gates in closed form (angles may be device tensors)
# ---------------------------------------------------------------------------


def _pauli_rotation(paulis: str, half_angle: torch.Tensor) -> torch.Tensor:
    """cos(h)·I − i·sin(h)·P; float32 angles give complex64, anything else
    complex128 (the reference's dtype rule)."""
    cdt = torch.complex64 if half_angle.dtype == torch.float32 else torch.complex128
    p = _constant("pauli", paulis.upper(), half_angle.device, cdt)
    c = torch.cos(half_angle)[..., None, None]
    s = torch.sin(half_angle)[..., None, None]
    eye = torch.eye(p.shape[-1], dtype=cdt, device=p.device)
    return c * eye - 1j * s * p


def rot1(pauli: str, theta) -> torch.Tensor:
    """exp(-i θ/2 P) for P ∈ {X, Y, Z}; θ of any shape → [..., 2, 2].

    Matches ``gate_matrix("R"+pauli.lower(), θ)`` (`gate_definitions.jl:
    34-44`) in closed form, so θ can be a device tensor."""
    return _pauli_rotation(pauli, _as_tensor(theta) / 2)


def rot2(pauli2: str, phi) -> torch.Tensor:
    """Two-site exp(-i φ/2 P⊗P) with the qiskit halved-parameter convention
    of ``gate_matrix("R"+pauli2.lower(), φ)`` (`gate_definitions.jl:28-31`):
    the effective angle is φ/2.  φ of any shape → [..., 4, 4]."""
    return _pauli_rotation(pauli2, _as_tensor(phi) / 2)


# ---------------------------------------------------------------------------
# Pauli-transfer matrices in closed form (d=4 picture)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _ptm_rot_tables(gen: str):
    """Host-side constants for the PTM of exp(-i α P_gen): commuting mask
    C0, anticommuting mask C1, and the sin-coupling M2[i,j] =
    Re Tr[P_i·(i·A·P_j)]/d on anticommuting strings."""
    A = _kron_pauli(gen)
    n = len(gen)
    d = 2**n
    paulis = [
        _kron_pauli("".join(c)) for c in itertools.product("IXYZ", repeat=n)
    ]
    m = 4**n
    c0 = np.zeros((m, m))
    c1 = np.zeros((m, m))
    m2 = np.zeros((m, m))
    for j, pj in enumerate(paulis):
        if np.allclose(A @ pj, pj @ A, atol=1e-13):
            c0[j, j] = 1.0
        else:
            c1[j, j] = 1.0
            apj = 1j * (A @ pj)
            for i, pi in enumerate(paulis):
                v = np.trace(pi @ apj) / d
                if abs(v) > 1e-12:
                    m2[i, j] = np.real(v)
    return c0, c1, m2


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else torch.float64


def ptm_rot(gen: str, angle, heisenberg: bool = False) -> torch.Tensor:
    """PTM of the ``R<gen>`` tuple gate at tuple parameter ``angle``: the
    d=4 analogue of :func:`rot1`/:func:`rot2`.  Every R-gate here is
    exp(-i(param/2)·P) after conventions (`gate_definitions.jl:28-44`),
    whose PTM in the {I,X,Y,Z}^⊗n basis is the identity on commuting
    strings and a cos/sin rotation on anticommuting pairs.  ``angle`` of
    any shape → ``[..., 4**n, 4**n]``, real, float32 for float32 angles
    and float64 otherwise."""
    angle = _as_tensor(angle)
    c0, c1, m2 = _constant("ptm", gen.upper(), angle.device, _real_dtype(angle))
    sgn = 1.0 if heisenberg else -1.0
    c = torch.cos(angle).to(c0.dtype)[..., None, None]
    s = torch.sin(angle).to(c0.dtype)[..., None, None]
    return c0 + c * c1 + sgn * s * m2


TRACEABLE_CHANNELS = (
    "depolarizing",
    "dephasing",
    "bitflip",
    "amplitude_damping",
    "reset",
)


def _unit(i: int, j: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros((4, 4), dtype=like.dtype, device=like.device)
    e[i, j] = 1.0
    return e


def ptm_channel(name: str, param, heisenberg: bool = False) -> torch.Tensor:
    """Single-site channel PTM at a runtime rate: the parametric analogue
    of `models.channels.channel_ptm` for noise sweeps.  ``param`` of any
    shape → ``[..., 4, 4]``.  Names as in `models/channels.py` (axis
    suffixes allowed for dephasing)."""
    base, _, suffix = name.partition(":")
    base = base.lower()
    p = _as_tensor(param)
    p = p.to(_real_dtype(p))[..., None, None]
    e00, e11, e22, e33 = (_unit(i, i, p) for i in range(4))
    # Heisenberg PTM is the transpose: γ couples I→Z instead of Z→I
    cross = _unit(0, 3, p) if heisenberg else _unit(3, 0, p)
    if base in ("depolarizing", "dep"):
        return e00 + (1.0 - p) * (e11 + e22 + e33)
    if base in ("dephasing", "deph", "phaseflip", "bitflip"):
        axis = "X" if base == "bitflip" else (suffix or "Z").upper()
        if len(axis) != 1 or axis not in "XYZ":
            raise ValueError(
                f"traceable channels are single-site; axis {axis!r} is not "
                "one of X/Y/Z (use models.channels for multi-site dephasing)"
            )
        c0, c1, _ = _constant("ptm", axis, p.device, p.dtype)
        return c0 + (1.0 - 2.0 * p) * c1
    if base in ("amplitude_damping", "ad"):
        return (e00 + torch.sqrt(1.0 - p) * (e11 + e22) + (1.0 - p) * e33
                + p * cross)
    if base == "reset":
        return e00 + (1.0 - p) * (e11 + e22 + e33) + p * cross
    raise ValueError(
        f"channel {name!r} has no traceable form (supported: "
        f"{TRACEABLE_CHANNELS})"
    )


# ---------------------------------------------------------------------------
# parametric Trotter layer: angles as runtime inputs
# ---------------------------------------------------------------------------


def _broadcast_rows(x, R: int, V: int, what: str, lead: int = 0):
    """Broadcast a per-row parameter to [R, V] after ``lead`` leading
    (ensemble) axes: scalars and [V] broadcast, [R] (per-row scalars,
    R≠V) reshapes to [R, 1]; the ambiguous R==V case must be passed
    explicitly."""
    rest = tuple(x.shape[lead:])
    if R > 1 and len(rest) == 1 and rest[0] == R:
        if R == V:
            raise ValueError(
                f"{what} shape ({R},) is ambiguous with {R} rows on {V} "
                f"vertices; pass [{R}, 1] (per-row scalars) or [{R}, {V}] "
                "explicitly"
            )
        rest = (R, 1)
    if len(rest) > 2:
        raise ValueError(f"{what}: cannot broadcast shape {rest} to ({R}, {V})")
    x = x.reshape(tuple(x.shape[:lead]) + (1,) * (2 - len(rest)) + rest)
    return torch.broadcast_to(x, tuple(x.shape[:lead]) + (R, V))


def _group_angle_tables(spec: BatchedGraphSpec):
    """Per-bucket positions into the [E] bond-angle vector."""
    edge_pos = {}
    for k, (iu, iv, su, sv) in enumerate(spec.edges):
        edge_pos[(iu, iv)] = k
        edge_pos[(iv, iu)] = k
    return tuple(
        tuple(
            np.asarray(
                [edge_pos[(u, v)] for u, v in zip(b.u_idx, b.v_idx)],
                np.int64,
            )
            for b in group
        )
        for group in spec.color_groups
    )


class FieldLayer(nn.Module):
    """A parametric Trotter layer (the shared body of the reference's
    ``make_field_layer_fn`` and ``make_noisy_field_layer_fn``): one
    composed per-vertex rotation, then every colour group's bond rotations
    with a BP refresh before each group, then (d=4) one composed
    per-vertex channel, then a final refresh.

    Its buffers hold the graph tables, each bucket's endpoint indices and
    each colour group's positions into the bond-angle vector (its buckets'
    edges in bucket order), so ``.to(device)`` moves them once.  Each
    colour group is one :func:`apply_color_group` call, its buckets' gates
    stacked.  ``forward(state, site_thetas, bond_thetas[,
    noise_params])`` runs one realization; :meth:`ensemble` runs stacked
    states (through :func:`ensemble_fn`)."""

    def __init__(self, spec: BatchedGraphSpec, chi: int, *, site_gate_fn,
                 bond_gate_fn, site_paulis: tuple, bond_pauli: str,
                 noise_names: tuple, noise_gate_fn, cutoff: float,
                 normalize_tensors: bool, bp_maxiter: int,
                 bp_tolerance: float | None, bp_damping: float,
                 final_update: bool):
        super().__init__()
        self.spec, self.chi = spec, chi
        self.site_gate_fn, self.bond_gate_fn = site_gate_fn, bond_gate_fn
        self.noise_gate_fn = noise_gate_fn
        self.site_paulis, self.bond_pauli = site_paulis, bond_pauli
        self.noise_names = noise_names
        self.cutoff, self.normalize_tensors = cutoff, normalize_tensors
        self.bp_kwargs = dict(maxiter=bp_maxiter, tolerance=bp_tolerance,
                              damping=bp_damping)
        self.final_update = final_update
        tables = graph_tables(spec, "cpu")
        self.register_buffer("nbr", tables.nbr)
        self.register_buffer("nbr_slot", tables.nbr_slot)
        self.register_buffer("mask", tables.mask)
        # the plan names buffers, so it stays valid after .to(device):
        # per colour group (its buckets' (slot_u, slot_v, u, v), its edges'
        # positions into the bond angles, its bucket sizes)
        self._groups = []
        for gi, (group, eidxs) in enumerate(
                zip(spec.color_groups, _group_angle_tables(spec))):
            plan = []
            for bi, b in enumerate(group):
                names = tuple(f"g{gi}_b{bi}_{k}" for k in "uv")
                for name, arr in zip(names, (b.u_idx, b.v_idx)):
                    self.register_buffer(
                        name, torch.as_tensor(np.asarray(arr, np.int64)))
                plan.append((b.slot_u, b.slot_v) + names)
            self.register_buffer(f"g{gi}_e", torch.as_tensor(
                np.concatenate(eidxs).astype(np.int64)))
            self._groups.append((tuple(plan), f"g{gi}_e",
                                 tuple(len(e) for e in eidxs)))

    # -- arguments ---------------------------------------------------------

    def _angles(self, args, axes, E: int, device):
        """(site [E, S, V], bond [E, Eb], noise [E, C, V] | None) from the
        call's arguments; an argument with axis 0 carries one value per
        member, one with axis None is shared."""
        V, Eb = self.spec.num_vertices, len(self.spec.edges)
        S, C = len(self.site_paulis), len(self.noise_names)
        if len(args) != (3 if C else 2):
            raise TypeError(f"expected {3 if C else 2} parameter arguments "
                            f"after the state, got {len(args)}")
        out = []
        for x, ax, (R, what) in zip(args, axes, ((S, "site_thetas"),
                                                 (0, "bond_thetas"),
                                                 (C, "noise_params"))):
            x = _as_tensor(x, device)
            lead = 0 if ax is None else 1
            if lead and x.shape[:1] != (E,):
                raise ValueError(f"{what}: leading axis {tuple(x.shape)} "
                                 f"does not match the ensemble size {E}")
            if R:
                x = _broadcast_rows(x, R, V, what, lead)
            else:
                if x.ndim - lead > 1:
                    raise ValueError(f"{what}: cannot broadcast shape "
                                     f"{tuple(x.shape)} to ({Eb},)")
                x = torch.broadcast_to(x.reshape(tuple(x.shape[:lead]) + (-1,)),
                                       tuple(x.shape[:lead]) + (Eb,))
            out.append(x.expand((E,) + tuple(x.shape[lead:])))
        return out[0], out[1], (out[2] if C else None)

    # -- the layer -----------------------------------------------------------

    def forward(self, state: BatchedState, *params):
        """One realization: ``(state, site_thetas, bond_thetas[,
        noise_params]) -> (state, truncation_errors)``."""
        site, bond, noise = self._angles(params, (None,) * len(params), 1,
                                         state.tensors.device)
        state, errs = self._run(state, 1, site, bond, noise)
        return state, errs[0]

    def ensemble(self, estate: BatchedState, params, axes):
        """E stacked realizations ``estate`` ([E, V, ...]) in one batched
        program; ``axes[i]`` is 0 when ``params[i]`` has a leading
        ensemble axis and None when it is shared.  Returns (estate,
        errors [E, n])."""
        E = estate.tensors.shape[0]
        site, bond, noise = self._angles(params, axes, E,
                                         estate.tensors.device)
        out, errs = self._run(fold_members(estate), E, site, bond, noise)
        return unfold_members(out, E), errs

    def _run(self, state, E, site, bond, noise):
        with span("layer"):
            return self._layer(state, E, site, bond, noise)

    def _layer(self, state, E, site, bond, noise):
        V = self.spec.num_vertices
        dtype = state.tensors.dtype
        tables = member_tables(GraphTables(self.nbr, self.nbr_slot,
                                           self.mask), E, V)

        def refresh(st):
            return bp_update(self.spec, st, tables=tables, members=E,
                             **self.bp_kwargs)

        # compose the S rotations into ONE per-vertex gate so the state
        # pays a single contraction
        gate = self.site_gate_fn(self.site_paulis[0], site[:, 0])
        for k in range(1, len(self.site_paulis)):
            gate = self.site_gate_fn(self.site_paulis[k], site[:, k]) @ gate
        d = gate.shape[-1]
        state = apply_one_site(state, gate.reshape(E * V, d, d).to(dtype))
        errs = []
        for plan, e_name, sizes in self._groups:
            # the 1-site sweep already touched every vertex, so every group
            # needs a refresh (matches BatchedCircuit's needs_refresh)
            state = refresh(state)
            buckets = [SlotPairBucket(
                su, sv, member_indices(getattr(self, u_name), E, V),
                member_indices(getattr(self, v_name), E, V))
                for su, sv, u_name, v_name in plan]
            # the group's angles [E, ΣB], in the gate order of its rows:
            # bucket by bucket, each bucket member-major
            angles = bond[:, getattr(self, e_name)]
            if E > 1 and len(sizes) > 1:
                angles = torch.cat([a.reshape(-1)
                                    for a in angles.split(sizes, dim=1)])
            gmat = self.bond_gate_fn(self.bond_pauli, angles)
            state, err = apply_color_group(
                state, buckets, gmat.reshape(-1, d, d, d, d).to(dtype),
                self.chi, self.cutoff, self.normalize_tensors,
            )
            # errors come bucket by bucket, each member-major
            errs += [e.reshape(E, -1)
                     for e in err.split([E * b for b in sizes])]
        if noise is not None:
            # noise after the unitary part: one composed per-vertex channel
            chan = self.noise_gate_fn(self.noise_names[0], noise[:, 0])
            for k in range(1, len(self.noise_names)):
                chan = self.noise_gate_fn(self.noise_names[k],
                                          noise[:, k]) @ chan
            state = apply_one_site(state, chan.reshape(E * V, d, d).to(dtype))
        if self.final_update:
            state = refresh(state)
        if not errs:
            return state, torch.zeros((E, 0), device=state.tensors.device)
        return state, torch.cat(errs, dim=1)


def _site_paulis(site_pauli) -> tuple:
    return (site_pauli,) if isinstance(site_pauli, str) else tuple(site_pauli)


def make_field_layer_fn(
    g,
    chi: int,
    *,
    site_pauli="X",
    bond_pauli: str = "ZZ",
    cutoff: float = 1e-12,
    normalize_tensors: bool = True,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    bp_damping: float = 0.0,
    final_update: bool = True,
    jit: bool = True,
    spec: BatchedGraphSpec | None = None,
    device=None,
) -> tuple[BatchedGraphSpec, FieldLayer]:
    """Compile a parametric TFIM-style Trotter layer over lattice ``g``.

    Returns ``(spec, layer)`` with
    ``layer(state, site_thetas, bond_thetas) -> (state, truncation_errors)``:

    - ``site_thetas``: scalar or ``[V]``: per-vertex angle of the 1-site
      rotation ``exp(-i θ/2 site_pauli)`` applied first.  ``site_pauli``
      may be a sequence (e.g. ``("X", "Z")``), in which case
      ``site_thetas`` broadcasts to ``[S, V]`` (``[S]`` per-rotation
      scalars allowed when S ≠ V) and the rotations apply in sequence;
    - ``bond_thetas``: scalar or ``[E]`` (``spec.edges`` order): per-edge
      angle of the 2-site rotation applied per edge-colour group with a BP
      refresh before each group (`apply_gates.jl:60-85` amortization).

    ``jit`` is accepted for signature parity and changes nothing.  The
    module lives on ``device`` (None: the package's default, CUDA)."""
    del jit
    if spec is None:
        spec = compile_graph(g)
    layer = FieldLayer(
        spec, chi, site_gate_fn=rot1, bond_gate_fn=rot2,
        site_paulis=_site_paulis(site_pauli), bond_pauli=bond_pauli,
        noise_names=(), noise_gate_fn=None,
        cutoff=cutoff, normalize_tensors=normalize_tensors,
        bp_maxiter=bp_maxiter, bp_tolerance=bp_tolerance,
        bp_damping=bp_damping, final_update=final_update,
    )
    return spec, layer.to(resolve_device(device))


def _ptm_rot_schrodinger(gen, angle):
    return ptm_rot(gen, angle, heisenberg=False)


def make_noisy_field_layer_fn(
    g,
    chi: int,
    *,
    site_pauli="X",
    bond_pauli: str = "ZZ",
    noise=("depolarizing",),
    cutoff: float = 1e-12,
    normalize_tensors: bool = False,
    bp_maxiter: int = 30,
    bp_tolerance: float | None = None,
    bp_damping: float = 0.0,
    final_update: bool = True,
    jit: bool = True,
    spec: BatchedGraphSpec | None = None,
    device=None,
) -> tuple[BatchedGraphSpec, FieldLayer]:
    """Parametric NOISY Trotter layer in the density-matrix picture: the
    rotation angles and the channel rates are runtime tensors, so one
    module serves every noise strength, and :func:`ensemble_fn` turns it
    into a noise-rate sweep.

    The state is a batched "PauliRho" coefficient network (d=4; build it
    with ``batched_product_state(g, chi, d=4, ...)``).  Returns
    ``(spec, layer)`` with ``layer(state, site_thetas, bond_thetas,
    noise_params) -> (state, truncation_errors)``:

    - ``site_thetas`` / ``bond_thetas``: as :func:`make_field_layer_fn`,
      applied as Schrödinger PTMs (:func:`ptm_rot`);
    - ``noise_params``: scalar, ``[C]`` or ``[C, V]``: one rate per channel
      name in ``noise`` (:data:`TRACEABLE_CHANNELS`), applied after the
      unitary part as one composed per-vertex 4×4 transfer matrix.

    The module lives on ``device`` (None: the package's default, CUDA)."""
    del jit
    if spec is None:
        spec = compile_graph(g)
    noise_names = (noise,) if isinstance(noise, str) else tuple(noise)
    for name in noise_names:  # fail at build time, not inside a layer call
        if tuple(ptm_channel(name, 0.0).shape) != (4, 4):
            raise ValueError(f"channel {name!r} is not single-site")
    layer = FieldLayer(
        spec, chi, site_gate_fn=_ptm_rot_schrodinger,
        bond_gate_fn=_ptm_rot_schrodinger,
        site_paulis=_site_paulis(site_pauli), bond_pauli=bond_pauli,
        noise_names=noise_names, noise_gate_fn=ptm_channel,
        cutoff=cutoff, normalize_tensors=normalize_tensors,
        bp_maxiter=bp_maxiter, bp_tolerance=bp_tolerance,
        bp_damping=bp_damping, final_update=final_update,
    )
    return spec, layer.to(resolve_device(device))


# ---------------------------------------------------------------------------
# ensemble (leading-axis) helpers
# ---------------------------------------------------------------------------


def stack_states(states) -> BatchedState:
    """Stack single-trajectory BatchedStates along a new leading ensemble
    axis (tensors ``[E, V, ...]``, messages ``[E, V, D, χ, χ]``)."""
    states = list(states)
    return BatchedState(torch.stack([s.tensors for s in states]),
                        torch.stack([s.messages for s in states]))


def unstack_states(estate: BatchedState) -> list:
    """Split an ensemble state back into per-realization BatchedStates."""
    return [BatchedState(t, m)
            for t, m in zip(estate.tensors.unbind(0),
                            estate.messages.unbind(0))]


def ensemble_fn(fn, in_axes=0, jit: bool = True) -> Callable:
    """Run a layer over the ensemble axis of stacked states.

    ``fn`` is a layer from :func:`make_field_layer_fn`,
    :func:`make_noisy_field_layer_fn` or :func:`~.trotter.make_layer_fn`:
    the members are folded into the vertex axis and run as one program,
    each member's BP stopping on its own (``jax.vmap`` cannot be mirrored
    by ``torch.func.vmap`` here, since BP decides on the host whether to
    go on).  Per-realization readouts: :func:`make_ensemble_expectation_fn`.
    The extra arguments follow ``in_axes`` as in ``jax.vmap`` (default:
    every argument carries a leading ensemble axis; ``in_axes=(0, None,
    ...)`` shares an argument across the ensemble).  The state's axis must
    be 0.  ``jit`` is accepted for signature parity and changes nothing."""
    del jit
    if not isinstance(fn, (FieldLayer, TrotterLayer)):
        raise TypeError("ensemble_fn runs the layers of make_field_layer_fn, "
                        "make_noisy_field_layer_fn and make_layer_fn")

    def run(estate: BatchedState, *params):
        axes = (in_axes,) * (1 + len(params)) if not isinstance(
            in_axes, (tuple, list)) else tuple(in_axes)
        if len(axes) != 1 + len(params) or axes[0] != 0:
            raise ValueError(f"in_axes {in_axes!r}: the state's axis must be "
                             f"0, with one entry per argument")
        if any(ax not in (0, None) for ax in axes[1:]):
            raise ValueError(f"in_axes {in_axes!r}: each axis is 0 or None")
        return fn.ensemble(estate, params, axes[1:])

    return run


def make_ensemble_expectation_fn(
    spec: BatchedGraphSpec, op: np.ndarray, real_output: bool = False
) -> Callable:
    """Per-realization per-vertex ⟨op⟩: estate → [E, V]."""
    op = np.asarray(op)

    def fn(estate: BatchedState):
        out = local_expectations(spec, fold_members(estate), op).reshape(
            estate.tensors.shape[:2])
        return out.real if real_output else out

    return fn
