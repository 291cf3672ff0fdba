"""Gate zoo and circuit format.

A jax-free copy of ``tensornetworkquantumsimulator_tpu.models.gates`` (the
reference's `gate_definitions.jl`).  Circuits are lists of tuples
``(name, vertices)`` or ``(name, vertices, param)``; :func:`to_tensor`
converts a tuple gate to a named-index :class:`~..ops.Tensor` over the
state's site indices, on the state's device.  Rxx/Ryy/Rzz parameters are
halved (qiskit convention); rotations are ``exp(-i θ/2 P)``.  On d=4 Pauli
sites a gate becomes its Pauli-transfer matrix: ``T[i,j] = Tr[P_i U† P_j
U]/d`` (Heisenberg picture, "Pauli" sites) or ``Tr[P_i U P_j U†]/d``
(density matrix, "PauliRho" sites).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import numpy as np
from scipy.linalg import expm

from ..devices import resolve_device
from ..ops.index import Index
from ..ops.tensor import Tensor, constant
from .sites import PAULI_I, PAULI_X, PAULI_Y, PAULI_Z, op_matrix

_PAULIS = {"I": PAULI_I, "X": PAULI_X, "Y": PAULI_Y, "Z": PAULI_Z}
_PAULI_LIST = [PAULI_I, PAULI_X, PAULI_Y, PAULI_Z]


_THETA_GATES = {"Rx", "Ry", "Rz", "CRx", "CRy", "CRz", "Rxxyy", "Rxxyyzz"}
_PHI_GATES = {"Rxx", "Ryy", "Rzz", "P", "CPHASE"}
_THETA_BETA_GATES = {"xx_plus_yy"}


def _kron_pauli(chars: str) -> np.ndarray:
    out = np.array([[1.0]])
    for c in chars:
        out = np.kron(out, _PAULIS[c.upper()])
    return out


def is_pauli_string(name: str) -> bool:
    return len(name) > 0 and all(c in "XYZxyz" for c in name)


def param_rescaling(name: str, param):
    """qiskit convention: Rxx/Ryy/Rzz params halved (`gate_definitions.jl:28-31`)."""
    if name in ("Rxx", "Ryy", "Rzz"):
        return param / 2
    return param


# ---------------------------------------------------------------------------
# gate matrices (row index = output legs, kron order = first site slowest)
# ---------------------------------------------------------------------------


def _rotation(p: np.ndarray, theta: float) -> np.ndarray:
    return expm(-1j * (theta / 2) * p)


def _controlled(u: np.ndarray) -> np.ndarray:
    out = np.eye(2 * u.shape[0], dtype=np.complex128)
    out[u.shape[0] :, u.shape[0] :] = u
    return out


_NAMED_GATES = {
    "CNOT": _controlled(PAULI_X),
    "CX": _controlled(PAULI_X),
    "CY": _controlled(PAULI_Y),
    "CZ": _controlled(PAULI_Z),
    "SWAP": np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
    ),
    "iSWAP": np.array(
        [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]],
        dtype=np.complex128,
    ),
    "√SWAP": np.array(
        [
            [1, 0, 0, 0],
            [0, (1 + 1j) / 2, (1 - 1j) / 2, 0],
            [0, (1 - 1j) / 2, (1 + 1j) / 2, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.complex128,
    ),
}


def gate_matrix(name: str, param=None) -> np.ndarray:
    """Unitary matrix for a (possibly parametrized) named gate."""
    if is_pauli_string(name):
        return _kron_pauli(name)
    if param is None:
        if name in _NAMED_GATES:
            return _NAMED_GATES[name]
        return op_matrix(name, 2)
    if name in ("Rx", "Ry", "Rz"):
        p = _PAULIS[name[1].upper()]
        return _rotation(p, param)
    if name in ("CRx", "CRy", "CRz"):
        return _controlled(_rotation(_PAULIS[name[2].upper()], param))
    if name in ("Rxx", "Ryy", "Rzz"):
        phi = param_rescaling(name, param)
        c = name[1].upper()
        return expm(-1j * phi * _kron_pauli(c + c))
    if name == "Rxxyy":
        h = 0.5 * (_kron_pauli("XX") + _kron_pauli("YY"))
        return expm(-1j * param * h)
    if name == "Rxxyyzz":
        h = 0.5 * (_kron_pauli("XX") + _kron_pauli("YY") + _kron_pauli("ZZ"))
        return expm(-1j * param * h)
    if name == "P":
        return np.diag([1.0, np.exp(1j * param)])
    if name == "CPHASE":
        return np.diag([1.0, 1.0, 1.0, np.exp(1j * param)])
    if name == "xx_plus_yy":
        theta, beta = param
        # `gate_definitions.jl:98-108` (qiskit XXPlusYY)
        return np.array(
            [
                [1, 0, 0, 0],
                [
                    0,
                    math.cos(theta / 2),
                    -1j * math.sin(theta / 2) * np.exp(-1j * beta),
                    0,
                ],
                [
                    0,
                    -1j * math.sin(theta / 2) * np.exp(1j * beta),
                    math.cos(theta / 2),
                    0,
                ],
                [0, 0, 0, 1],
            ],
            dtype=np.complex128,
        )
    raise ValueError(f"unknown gate {name!r}")


# ---------------------------------------------------------------------------
# Pauli-transfer matrices (d=4 Pauli sites)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def _ptm_cached(generator: str, theta: float) -> tuple:
    u = expm(-1j * (theta / 2) * _kron_pauli(generator))
    return tuple(map(tuple, pauli_transfer_matrix(u, heisenberg=True)))


def pauli_transfer_matrix(u: np.ndarray, heisenberg: bool = True) -> np.ndarray:
    """PTM of a unitary in the {I,X,Y,Z}^⊗n basis.

    heisenberg=True: T[i,j] = Tr[P_i U† P_j U]/d, so Pauli coefficient
    vectors evolve as c' = T c under O → U†OU (PauliPropagation
    `calculateptm`, used at `gate_definitions.jl:70-77`).
    """
    d = u.shape[0]
    n = int(round(math.log2(d)))
    full = []
    for combo in itertools.product(range(4), repeat=n):
        p = np.array([[1.0]])
        for k in combo:
            p = np.kron(p, _PAULI_LIST[k])
        full.append(p)
    m = np.zeros((4**n, 4**n), dtype=np.complex128)
    uh = u.conj().T
    for j, pj in enumerate(full):
        evolved = uh @ pj @ u if heisenberg else u @ pj @ uh
        for i, pi in enumerate(full):
            m[i, j] = np.trace(pi @ evolved) / d
    if np.allclose(m.imag, 0, atol=1e-14):
        m = m.real
    return m


@functools.lru_cache(maxsize=4096)
def _ptm_schrodinger_cached(name: str, param) -> tuple:
    m = pauli_transfer_matrix(gate_matrix(name, param), heisenberg=False)
    return tuple(map(tuple, m))


def _param_key(param):
    """A hashable form of a gate parameter, or None (no caching)."""
    if param is None:
        return None
    try:
        return float(param)
    except (TypeError, ValueError):
        try:
            return tuple(float(x) for x in param)
        except (TypeError, ValueError):
            return None


def _ptm_tensor(m: np.ndarray, key, site_inds, device) -> Tensor:
    n = len(site_inds)
    primed = tuple(s.prime() for s in site_inds)
    data = constant(key, lambda: m.reshape((4,) * (2 * n)), m.dtype,
                    resolve_device(device))  # [out..., in...]
    return Tensor(data, primed + tuple(site_inds))


def schrodinger_gate_tensor(name: str, param, site_inds: Sequence[Index],
                            device=None) -> Tensor:
    """PTM tensor of a named unitary for density-matrix ("PauliRho") sites:
    ρ's Pauli coefficients evolve forward as c' = T c with
    T[i,j] = Tr[P_i U P_j U†]/d.  Same circuit-tuple conventions as the
    Schrödinger wavefunction path (`gate_matrix` handles param rescaling);
    cached per (name, param) like the Heisenberg `_ptm_cached`."""
    p = None if param is None else float(param)
    m = np.array(_ptm_schrodinger_cached(name, p))
    if any(s.dim != 4 for s in site_inds):
        raise ValueError("PTM gates act on 4-dimensional Pauli sites")
    return _ptm_tensor(m, ("sptm", name, p), site_inds, device)


def heisenberg_gate_tensor(name: str, param, site_inds: Sequence[Index],
                           device=None) -> Tensor:
    """PTM tensor for an ``R<paulis>`` gate on 4-dim Pauli sites
    (`gate_definitions.jl:63-86`)."""
    if not name.startswith("R"):
        raise ValueError("Heisenberg-picture gates must be named R<paulistring>")
    generator = name[1:].upper()
    if not is_pauli_string(generator):
        raise ValueError(f"cannot build PTM for gate {name!r}")
    # all R-gates take exp(-i θ/2 P) with the raw parameter on this path
    # (`gate_definitions.jl:40-41` passes gate[3] unscaled; PauliPropagation's
    # PauliRotation(θ) = exp(-i θ/2 P), matching the Schrödinger-picture
    # convention after the qiskit rescale)
    m = np.array(_ptm_cached(generator, float(param)))
    if any(s.dim != 4 for s in site_inds):
        raise ValueError("Heisenberg gates act on 4-dimensional Pauli sites")
    return _ptm_tensor(m, ("hptm", generator, float(param)), site_inds,
                       device)


# ---------------------------------------------------------------------------
# tuple-circuit conversion (`gate_definitions.jl:34-57`)
# ---------------------------------------------------------------------------


def collect_gate_vertices(spec, graph=None) -> list:
    from ..utils.lattices import _gate_vertices

    return _gate_vertices(spec)


def to_tensor(gate, siteinds: dict, device=None):
    """Convert one tuple gate to ``(Tensor, vertices)`` on ``device`` (None:
    the package default), in the matrix's own dtype (the caller adapts it to
    the state, `apply.adapt_gate`).  The matrix is copied to the device once
    per (gate, parameter)."""
    if isinstance(gate, Tensor):
        return gate, None
    name = gate[0]
    verts = collect_gate_vertices(gate[1])
    param = gate[2] if len(gate) > 2 else None
    s_inds = [siteinds[v][0] for v in verts]

    if all(s.hastag("Pauli") for s in s_inds):
        from .channels import channel_tensor, is_channel

        if is_channel(name):
            return channel_tensor(name, param, s_inds, heisenberg=True,
                                  device=device), verts
        return heisenberg_gate_tensor(name, param, s_inds, device), verts

    if all(s.hastag("PauliRho") for s in s_inds):
        from .channels import channel_tensor, is_channel

        if is_channel(name):
            return channel_tensor(name, param, s_inds, heisenberg=False,
                                  device=device), verts
        return schrodinger_gate_tensor(name, param, s_inds, device), verts

    mat = gate_matrix(name, param)
    dims = tuple(s.dim for s in s_inds)
    if mat.shape[0] != int(np.prod(dims)):
        raise ValueError(f"gate {name!r} dimension mismatch on {verts}")
    key = _param_key(param)
    key = None if key is None and param is not None else ("gate", name, key,
                                                          dims)
    data = constant(key, lambda: mat.reshape(dims + dims), mat.dtype,
                    resolve_device(device))  # [out..., in...]
    primed = tuple(s.prime() for s in s_inds)
    return Tensor(data, primed + tuple(s_inds)), verts


def to_tensors(circuit, siteinds: dict, device=None) -> list:
    """Convert a tuple circuit to [(Tensor, vertices)] (`gate_definitions.jl:4-6`)."""
    return [to_tensor(gate, siteinds, device=device) for gate in circuit]
