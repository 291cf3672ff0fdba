"""Site-index systems and the local operator/state registry.

A jax-free copy of ``tensornetworkquantumsimulator_tpu.models.sites``: the
counterpart of the reference's `src/siteinds.jl` plus the pieces of
ITensors' op/state system it leans on (`ITensors.op`, `ITensors.state`;
`tensornetworkstate.jl:53`, `tensornetworkstate_constructors.jl`).
Supported site types: qubit/S=1/2 (d=2), qutrit/S=1 (d=3), and the
4-dimensional "Pauli" and "PauliRho" sites of the Heisenberg and
density-matrix pictures.  The registry is numpy; :func:`op_tensor` puts an
operator on a device as a named-index tensor.
"""

from __future__ import annotations

import numpy as np

from ..devices import resolve_device
from ..ops.index import Index

_SQ2 = 1 / np.sqrt(2.0)

_STATES_2 = {
    "↑": [1.0, 0.0],
    "up": [1.0, 0.0],
    "0": [1.0, 0.0],
    "z+": [1.0, 0.0],
    "zp": [1.0, 0.0],
    "↓": [0.0, 1.0],
    "dn": [0.0, 1.0],
    "down": [0.0, 1.0],
    "1": [0.0, 1.0],
    "z-": [0.0, 1.0],
    "zm": [0.0, 1.0],
    "x+": [_SQ2, _SQ2],
    "+": [_SQ2, _SQ2],
    "x-": [_SQ2, -_SQ2],
    "-": [_SQ2, -_SQ2],
    "y+": [_SQ2, 1j * _SQ2],
    "i": [_SQ2, 1j * _SQ2],
    "y-": [_SQ2, -1j * _SQ2],
    "-i": [_SQ2, -1j * _SQ2],
}

def site_dimension(sitetype: str) -> int:
    st = sitetype.lower().replace(" ", "")
    if st in ("s=1/2", "qubit", "spin1/2", "spinhalf"):
        return 2
    if st in ("qutrit", "s=1", "spin1"):
        return 3
    if st == "pauli":
        return 4
    if st in ("paulirho", "rho", "densitymatrix"):
        return 4
    raise ValueError(f"unknown site type {sitetype!r}")


def site_tag(sitetype: str) -> str:
    st = sitetype.lower().replace(" ", "")
    if st in ("s=1/2", "qubit", "spin1/2", "spinhalf"):
        return "S=1/2"
    if st in ("qutrit", "s=1", "spin1"):
        return "S=1"
    if st == "pauli":
        return "Pauli"
    if st in ("paulirho", "rho", "densitymatrix"):
        return "PauliRho"
    raise ValueError(f"unknown site type {sitetype!r}")


def siteinds(sitetype: str, g, dim: int | None = None) -> dict:
    """Per-vertex site-index dictionary (`siteinds.jl:7-10`)."""
    d = dim if dim is not None else site_dimension(sitetype)
    tag = site_tag(sitetype)
    return {v: [Index(d, tags=(tag, f"Site,{v}"))] for v in g.vertices()}


def default_siteinds(g) -> dict:
    return siteinds("S=1/2", g)


# Heisenberg-picture Pauli sites: basis order [I, X, Y, Z]
# (`tensornetworkstate_constructors.jl:1`)
PAULI_BASIS_STATES = {
    "I": [1.0, 0.0, 0.0, 0.0],
    "X": [0.0, 1.0, 0.0, 0.0],
    "Y": [0.0, 0.0, 1.0, 0.0],
    "Z": [0.0, 0.0, 0.0, 1.0],
}


def pauli_coefficients(local) -> np.ndarray:
    """Pauli coefficient vector ``[Tr ρ, Tr ρX, Tr ρY, Tr ρZ]`` of a local
    density matrix, given as a state string ("0", "+", "y-", …), a pure-state
    2-vector, a 2×2 density matrix, or an already-4-long coefficient vector.
    The convention matches `paulitensornetworkstate`: a one-site ρ is
    ``(1/2) Σ_P c_P P`` with these c as the site tensor entries."""
    if isinstance(local, str):
        if local in PAULI_BASIS_STATES:
            return np.asarray(PAULI_BASIS_STATES[local], dtype=np.float64)
        if local.lower() in ("mixed", "id/2", "maximallymixed"):
            return np.array([1.0, 0.0, 0.0, 0.0])
        psi = state_vector(local, 2)
        rho = np.outer(psi, psi.conj())
    else:
        arr = np.asarray(local)
        if arr.shape == (4,):
            return arr
        if arr.shape == (2,):
            rho = np.outer(arr, arr.conj())
        elif arr.shape == (2, 2):
            rho = arr
        else:
            raise ValueError(f"cannot interpret {local!r} as a local state")
    c = np.array(
        [np.trace(rho @ p) for p in (PAULI_I, PAULI_X, PAULI_Y, PAULI_Z)]
    )
    if np.allclose(c.imag, 0, atol=1e-14):
        c = c.real
    return c


def state_vector(name: str, dim: int) -> np.ndarray:
    if dim == 2:
        key = name.lower() if name not in ("↑", "↓") else name
        if key in _STATES_2:
            return np.asarray(_STATES_2[key])
        key2 = name.replace("X", "x").replace("Y", "y").replace("Z", "z")
        if key2.lower() in _STATES_2:
            return np.asarray(_STATES_2[key2.lower()])
    if dim == 4 and name in PAULI_BASIS_STATES:
        return np.asarray(PAULI_BASIS_STATES[name])
    if dim == 3:
        m = {"↑": 0, "up": 0, "z0": 1, "0": 1, "↓": 2, "dn": 2, "down": 2}
        k = m.get(name if name in ("↑", "↓") else name.lower())
        if k is not None:
            vec = np.zeros(3)
            vec[k] = 1.0
            return vec
    raise ValueError(f"unknown state {name!r} for site dimension {dim}")


# ---------------------------------------------------------------------------
# local operators
# ---------------------------------------------------------------------------

PAULI_I = np.eye(2)
PAULI_X = np.array([[0.0, 1.0], [1.0, 0.0]])
PAULI_Y = np.array([[0.0, -1j], [1j, 0.0]])
PAULI_Z = np.array([[1.0, 0.0], [0.0, -1.0]])

_OPS_2 = {
    "I": PAULI_I,
    "Id": PAULI_I,
    "X": PAULI_X,
    "Y": PAULI_Y,
    "Z": PAULI_Z,
    "H": np.array([[1.0, 1.0], [1.0, -1.0]]) * _SQ2,
    "S": np.array([[1.0, 0.0], [0.0, 1j]]),
    "T": np.array([[1.0, 0.0], [0.0, np.exp(1j * np.pi / 4)]]),
    "Sx": PAULI_X / 2,
    "Sy": PAULI_Y / 2,
    "Sz": PAULI_Z / 2,
    "S+": np.array([[0.0, 1.0], [0.0, 0.0]]),
    "S-": np.array([[0.0, 0.0], [1.0, 0.0]]),
}

# spin-1 operators
_S1_SZ = np.diag([1.0, 0.0, -1.0])
_S1_SP = np.sqrt(2) * np.array([[0, 1.0, 0], [0, 0, 1.0], [0, 0, 0]])
_S1_SM = _S1_SP.T
_OPS_3 = {
    "I": np.eye(3),
    "Id": np.eye(3),
    "Sz": _S1_SZ,
    "S+": _S1_SP,
    "S-": _S1_SM,
    "Sx": (_S1_SP + _S1_SM) / 2,
    "Sy": (_S1_SP - _S1_SM) / (2j),
    "Z": _S1_SZ,
}

_OPS_4 = {"I": np.eye(4), "Id": np.eye(4)}


def op_matrix(name: str, dim: int) -> np.ndarray:
    """Single-site operator matrix, row index = output (primed) leg."""
    table = {2: _OPS_2, 3: _OPS_3, 4: _OPS_4}.get(dim)
    if table is None or name not in table:
        raise ValueError(f"unknown operator {name!r} for site dimension {dim}")
    return table[name]


def op_tensor(name: str, site: Index, dtype=None, device=None):
    """ITensors.op equivalent: matrix on (site', site), on ``device`` (None:
    the package default), copied there once per (name, dtype, device).  A
    complex operator asked for in a real dtype comes in the complex dtype of
    that precision: the JAX package casts it to the real dtype, which drops
    its imaginary part, so ⟨YY⟩ of a real state reads 0 there."""
    from ..ops.tensor import Tensor, as_torch_dtype, complex_of, constant

    mat = op_matrix(name, site.dim)
    if dtype is None:
        dtype = np.complex128 if np.iscomplexobj(mat) else np.float64
    dtype = as_torch_dtype(dtype)
    if np.iscomplexobj(mat):
        dtype = complex_of(dtype)
    data = constant(("op", name, site.dim), lambda: mat, dtype,
                    resolve_device(device))
    return Tensor(data, (site.prime(), site))
