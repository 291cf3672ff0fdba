"""Gate matrices of the tuple-circuit format.

A jax-free copy of ``gate_matrix``, ``pauli_transfer_matrix`` and their
numpy/scipy helpers from ``tensornetworkquantumsimulator_tpu.models.gates``
(the reference's `gate_definitions.jl`).  Rxx/Ryy/Rzz parameters are halved
(qiskit convention); rotations are ``exp(-i θ/2 P)``.  On d=4 Pauli sites
a gate becomes its Pauli-transfer matrix: ``T[i,j] = Tr[P_i U† P_j U]/d``
(Heisenberg picture) or ``Tr[P_i U P_j U†]/d`` (density matrix).
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
from scipy.linalg import expm

from .sites import PAULI_I, PAULI_X, PAULI_Y, PAULI_Z, op_matrix

_PAULIS = {"I": PAULI_I, "X": PAULI_X, "Y": PAULI_Y, "Z": PAULI_Z}
_PAULI_LIST = [PAULI_I, PAULI_X, PAULI_Y, PAULI_Z]


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
