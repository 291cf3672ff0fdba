"""Quantum noise channels as Pauli-transfer matrices.

A jax-free copy of ``tensornetworkquantumsimulator_tpu.models.channels``:
the Kraus builders, ``kraus_to_ptm``, ``is_channel``, ``channel_kraus``,
``channel_ptm`` and ``channel_tensor``, which puts a channel on a device
as a tensor of the generic engine.  A CPTP map Φ(ρ) = Σ_k K_k ρ K_k† becomes a transfer
matrix in the {I,X,Y,Z}^⊗n product basis, applied to d=4 Pauli sites
exactly like a PTM gate.  Two pictures:

- **Heisenberg**: an observable evolves through the reversed circuit under
  the adjoint map Φ†(O) = Σ_k K_k† O K_k;
- **Schrödinger / density matrix**: ρ's Pauli coefficient network evolves
  forward under Φ itself; gates apply as the PTM of U.

Coefficient vectors c with O = Σ_P c_P P (unnormalized Pauli strings,
Tr[P_i P_j] = d δ_ij) evolve as c' = T c with T[i,j] = Tr[P_i Φ(P_j)]/d
(Schrödinger) or Tr[P_i Φ†(P_j)]/d (Heisenberg).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import numpy as np

from .gates import _kron_pauli

__all__ = [
    "kraus_to_ptm",
    "depolarizing_kraus",
    "dephasing_kraus",
    "amplitude_damping_kraus",
    "generalized_amplitude_damping_kraus",
    "pauli_channel_kraus",
    "reset_kraus",
    "imaginary_time_kraus",
    "is_channel",
    "channel_kraus",
    "channel_ptm",
    "channel_tensor",
]


def _pauli_strings(n: int):
    """All n-site Pauli strings in [I,X,Y,Z]^⊗n product order."""
    out = []
    for combo in itertools.product("IXYZ", repeat=n):
        out.append(_kron_pauli("".join(combo)))
    return out


def kraus_to_ptm(kraus: Sequence[np.ndarray], heisenberg: bool = True) -> np.ndarray:
    """Transfer matrix of Φ(ρ)=Σ K ρ K† in the {I,X,Y,Z}^⊗n basis.

    heisenberg=True returns the PTM of the adjoint map Φ†(O)=Σ K†OK (the
    direction an observable evolves), heisenberg=False the map itself
    (the direction a density matrix evolves).
    """
    ks = [np.asarray(k, dtype=np.complex128) for k in kraus]
    d = ks[0].shape[0]
    n = int(round(math.log2(d)))
    if 2**n != d or any(k.shape != (d, d) for k in ks):
        raise ValueError("Kraus operators must be square with power-of-2 dim")
    paulis = _pauli_strings(n)
    m = np.zeros((4**n, 4**n), dtype=np.complex128)
    for j, pj in enumerate(paulis):
        if heisenberg:
            evolved = sum(k.conj().T @ pj @ k for k in ks)
        else:
            evolved = sum(k @ pj @ k.conj().T for k in ks)
        for i, pi in enumerate(paulis):
            m[i, j] = np.trace(pi @ evolved) / d
    if np.allclose(m.imag, 0, atol=1e-14):
        m = m.real
    return m


# ---------------------------------------------------------------------------
# named channels (Kraus representations)
# ---------------------------------------------------------------------------


def depolarizing_kraus(p: float, nsites: int = 1) -> list:
    """Φ(ρ) = (1−p)ρ + p·Tr[ρ]·I/d on ``nsites`` sites.

    Kraus form uses the Pauli twirl Σ_P PρP / d² = Tr[ρ] I/d:
    weight 1−p+p/d² on the identity, p/d² on each non-identity string.
    """
    d2 = 4**nsites
    if not 0.0 <= p <= d2 / (d2 - 1):
        raise ValueError(f"depolarizing probability {p} out of range")
    out = []
    for combo in itertools.product("IXYZ", repeat=nsites):
        s = "".join(combo)
        w = (1.0 - p + p / d2) if set(s) == {"I"} else p / d2
        if w > 0:
            out.append(math.sqrt(w) * _kron_pauli(s))
    return out


def dephasing_kraus(p: float, axis: str = "Z") -> list:
    """Φ(ρ) = (1−p)ρ + p·AρA with A a Pauli string (multi-site allowed).

    axis="Z" is phase flip, "X" bit flip, "ZZ" two-site correlated
    dephasing, etc.
    """
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dephasing probability {p} out of range")
    a = _kron_pauli(axis.upper())
    d = a.shape[0]
    return [math.sqrt(1.0 - p) * np.eye(d), math.sqrt(p) * a]


def amplitude_damping_kraus(gamma: float) -> list:
    """T1 decay toward |0⟩ with probability γ."""
    if not 0.0 <= gamma <= 1.0:
        raise ValueError(f"damping probability {gamma} out of range")
    k0 = np.array([[1.0, 0.0], [0.0, math.sqrt(1.0 - gamma)]])
    k1 = np.array([[0.0, math.sqrt(gamma)], [0.0, 0.0]])
    return [k0, k1]


def generalized_amplitude_damping_kraus(gamma: float, p: float) -> list:
    """Finite-temperature damping: decay to |0⟩ with weight p, |1⟩ with 1−p."""
    if not (0.0 <= gamma <= 1.0 and 0.0 <= p <= 1.0):
        raise ValueError("generalized amplitude damping params out of range")
    sg, sq = math.sqrt(gamma), math.sqrt(1.0 - gamma)
    a0 = math.sqrt(p) * np.array([[1.0, 0.0], [0.0, sq]])
    a1 = math.sqrt(p) * np.array([[0.0, sg], [0.0, 0.0]])
    b0 = math.sqrt(1.0 - p) * np.array([[sq, 0.0], [0.0, 1.0]])
    b1 = math.sqrt(1.0 - p) * np.array([[0.0, 0.0], [sg, 0.0]])
    return [a0, a1, b0, b1]


def pauli_channel_kraus(probs, nsites: int = 1) -> list:
    """Φ(ρ) = Σ_P p_P PρP from a {pauli_string: prob} dict (or a length-4
    [pI,pX,pY,pZ] sequence for one site).  Probabilities must sum to 1."""
    if not isinstance(probs, dict):
        seq = list(probs)
        if nsites != 1 or len(seq) != 4:
            raise ValueError("sequence form is single-site [pI,pX,pY,pZ]")
        probs = dict(zip("IXYZ", seq))
    total = float(sum(probs.values()))
    if not math.isclose(total, 1.0, abs_tol=1e-10):
        raise ValueError(f"Pauli channel probabilities sum to {total}, not 1")
    out = []
    for s, w in sorted(probs.items()):
        w = float(w)
        if w < -1e-12:
            raise ValueError("negative probability")
        if len(s) != nsites:
            raise ValueError(f"Pauli string {s!r} is not {nsites}-site")
        if w > 0:
            out.append(math.sqrt(w) * _kron_pauli(s.upper()))
    return out


def reset_kraus(p: float) -> list:
    """Φ(ρ) = (1−p)ρ + p·|0⟩⟨0|·Tr[ρ] (stochastic reset to |0⟩)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"reset probability {p} out of range")
    sp, sq = math.sqrt(p), math.sqrt(1.0 - p)
    return [
        sq * np.eye(2),
        sp * np.array([[1.0, 0.0], [0.0, 0.0]]),
        sp * np.array([[0.0, 1.0], [0.0, 0.0]]),
    ]


_CHANNEL_ALIASES = {
    "depolarizing": "depolarizing",
    "dep": "depolarizing",
    "dephasing": "dephasing",
    "deph": "dephasing",
    "phaseflip": "dephasing",
    "bitflip": "bitflip",
    "amplitude_damping": "amplitude_damping",
    "ad": "amplitude_damping",
    "generalized_amplitude_damping": "generalized_amplitude_damping",
    "gad": "generalized_amplitude_damping",
    "pauli_channel": "pauli_channel",
    "reset": "reset",
    "kraus": "kraus",
    "map": "map",
}


def _parse(name: str):
    base, _, suffix = name.partition(":")
    return _CHANNEL_ALIASES.get(base.lower()), suffix


def is_channel(name) -> bool:
    """True when a tuple-circuit gate name denotes a noise channel."""
    return isinstance(name, str) and _parse(name)[0] is not None


def channel_kraus(name: str, param, nsites: int = 1) -> list:
    """Kraus list for a named channel.  ``name`` may carry an axis suffix
    (``"dephasing:ZZ"``); ``param`` is the channel probability/rate(s).
    ``("kraus", verts, [K0, K1, …])`` passes an explicit Kraus list for an
    arbitrary CPTP map; ``("map", verts, [K0, …])`` the same WITHOUT the
    trace-preservation check — for general linear maps ρ → Σ K ρ K†
    (imaginary-time propagators e^{−τh}, POVM/weak-measurement branches;
    the trace is restored by the ratio-style measurements,
    `measure.pauli_expectation`)."""
    canon, suffix = _parse(name)
    if canon is None:
        raise ValueError(f"unknown channel {name!r}")
    if canon in ("kraus", "map"):
        ks = [np.asarray(k, dtype=np.complex128) for k in param]
        d = 2**nsites
        if any(k.shape != (d, d) for k in ks):
            raise ValueError(
                f"Kraus operators must be {d}x{d} for a {nsites}-site channel"
            )
        if canon == "kraus":
            total = sum(k.conj().T @ k for k in ks)
            if not np.allclose(total, np.eye(d), atol=1e-10):
                raise ValueError(
                    "Kraus operators do not satisfy sum K'K = I "
                    '(use ("map", verts, [K…]) for non-trace-preserving maps)'
                )
        return ks
    if canon == "depolarizing":
        return depolarizing_kraus(float(param), nsites)
    if canon == "dephasing":
        axis = (suffix or "Z" * nsites).upper()
        if len(axis) != nsites:
            raise ValueError(f"axis {axis!r} is not {nsites}-site")
        return dephasing_kraus(float(param), axis)
    if canon == "bitflip":
        return dephasing_kraus(float(param), "X" * nsites)
    if canon == "amplitude_damping":
        if nsites != 1:
            raise ValueError("amplitude damping is single-site")
        return amplitude_damping_kraus(float(param))
    if canon == "generalized_amplitude_damping":
        if nsites != 1:
            raise ValueError("generalized amplitude damping is single-site")
        gamma, p = param
        return generalized_amplitude_damping_kraus(float(gamma), float(p))
    if canon == "pauli_channel":
        return pauli_channel_kraus(param, nsites)
    if canon == "reset":
        if nsites != 1:
            raise ValueError("reset is single-site")
        return reset_kraus(float(param))
    raise AssertionError(canon)


def imaginary_time_kraus(h: np.ndarray, dtau: float) -> list:
    """Single-element operator list [e^{−dτ·h}] for one imaginary-time
    Trotter factor: in the density-matrix picture the ("map", verts, [G])
    tuple evolves ρ → GρG†, so a product formula over all Hamiltonian
    terms drives ρ(β) ∝ e^{−βH/2}·ρ₀·e^{−βH/2} toward the thermal state
    from ρ₀ ∝ I (infinite temperature).  ``h`` must be hermitian.  No
    reference counterpart (the reference is unitary-only).  See
    `examples/thermal_states.py`."""
    from scipy.linalg import expm

    h = np.asarray(h, dtype=np.complex128)
    if not np.allclose(h, h.conj().T, atol=1e-12):
        raise ValueError("imaginary-time generator must be hermitian")
    return [expm(-float(dtau) * h)]


def _param_key(param):
    if isinstance(param, dict):
        return tuple(sorted((k, float(v)) for k, v in param.items()))
    if isinstance(param, (list, tuple)):
        return tuple(float(x) for x in param)
    return float(param)


@functools.lru_cache(maxsize=4096)
def _channel_ptm_cached(name, key, nsites, heisenberg):
    param = (
        dict(key)
        if isinstance(key, tuple) and key and isinstance(key[0], tuple)
        else key
    )
    return kraus_to_ptm(channel_kraus(name, param, nsites), heisenberg)


def channel_ptm(name: str, param, nsites: int = 1, heisenberg: bool = True) -> np.ndarray:
    """Transfer matrix of a named channel (cached; explicit "kraus" lists
    are converted directly, uncached)."""
    if _parse(name)[0] in ("kraus", "map"):
        return kraus_to_ptm(channel_kraus(name, param, nsites), heisenberg)
    return np.array(_channel_ptm_cached(name, _param_key(param), nsites, heisenberg))


def channel_tensor(name: str, param, site_inds, heisenberg: bool = True,
                   device=None):
    """Channel transfer tensor on Pauli-4 sites, shaped like a PTM gate
    (`models/gates.py::heisenberg_gate_tensor`), on ``device`` (None: the
    package default)."""
    from .gates import _ptm_tensor

    n = len(site_inds)
    if any(s.dim != 4 for s in site_inds):
        raise ValueError("channels act on 4-dimensional Pauli sites")
    m = channel_ptm(name, param, nsites=n, heisenberg=heisenberg)
    key = None
    if _parse(name)[0] not in ("kraus", "map"):
        key = ("channel", name, _param_key(param), n, heisenberg)
    return _ptm_tensor(m, key, site_inds, device)
