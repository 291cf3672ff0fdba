"""Shared inputs of the port's measurement tests (tests/test_torch_*.py).

A test state is a product state plus seeded random noise on the REAL bond
legs (numpy, as scripts/measure_bench.py:81-85 perturbs its state; entries
with a non-zero index on a dummy slot stay zero, so the padded tensors are
a genuine PEPS of bond dimension χ), brought to the BP fixed point once by
the JAX package, and handed to both packages as the same numpy arrays.
:func:`dense_statevector` contracts such a state exactly in numpy: an
oracle independent of both packages.
"""

import functools
import string

import jax.numpy as jnp
import numpy as np

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel.structure import (
    compile_graph as j_compile_graph,
)
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

LATTICES = {
    "grid2x2": lambda lat: lat.named_grid((2, 2)),
    "grid3x3": lambda lat: lat.named_grid((3, 3)),
    "grid5x5": lambda lat: lat.named_grid((5, 5)),
    "cube2x2x2": lambda lat: lat.named_grid((2, 2, 2)),
    "eagle": lambda lat: lat.ibm_eagle_lattice(),
    "grid3x4": lambda lat: lat.named_grid((3, 4)),
    "heavyhex1x1": lambda lat: lat.heavy_hexagonal_lattice(1, 1),
    "heavyhex2x2": lambda lat: lat.heavy_hexagonal_lattice(2, 2),
}


def random_peps(spec, chi, d=2, seed=0, amp=0.3, dtype=np.complex128):
    """Padded vertex tensors [V, χ.., d]: a product state plus ``amp`` ×
    complex Gaussian noise on the real bond legs."""
    rng = np.random.default_rng(seed)
    V, D = spec.num_vertices, spec.degree
    shape = (V,) + (chi,) * D + (d,)
    t = amp * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    site = np.zeros(d)
    site[:2] = [1.0, 0.6]
    t[(slice(None),) + (0,) * D] += site
    mask = spec.mask_array()
    for i in range(V):
        for k in range(D):
            if not mask[i, k]:  # dummy slot: support at index 0 only
                idx = [slice(None)] * (D + 1)
                idx[k] = slice(1, None)
                t[i][tuple(idx)] = 0.0
    return t.astype(dtype)


@functools.lru_cache(maxsize=None)
def converged(lattice, chi, seed=0, d=2, amp=0.3):
    """(JAX spec, JAX state, port spec, tensors, messages): one random state
    at the BP fixed point (JAX flooding BP, tolerance 1e-14), complex128.
    The port's state is ``tt.parallel.state_from_numpy(tensors, messages)``."""
    jspec = j_compile_graph(LATTICES[lattice](j_lat))
    tspec = tt.compile_graph(LATTICES[lattice](tt))
    assert jspec.edges == tspec.edges and jspec.nbr == tspec.nbr
    tensors = random_peps(tspec, chi, d=d, seed=seed, amp=amp)
    V, D = tspec.num_vertices, tspec.degree
    jstate = jp.BatchedState(
        jnp.asarray(tensors), jp.identity_messages(V, D, chi, np.complex128))
    jstate = jp.bp_update(jspec, jstate, maxiter=500, tolerance=1e-14)
    messages = np.asarray(jstate.messages)
    return jspec, jstate, tspec, tensors, messages


def port_state(lattice, chi, seed=0, dtype=None, **kw):
    """(port spec, port state) of :func:`converged`, optionally cast."""
    _, _, tspec, tensors, messages = converged(lattice, chi, seed, **kw)
    if dtype is not None:
        tensors, messages = tensors.astype(dtype), messages.astype(dtype)
    return tspec, tt.parallel.state_from_numpy(tensors, messages)


def dense_statevector(spec, tensors):
    """The PEPS as a dense vector [d]*V (``spec.vertices`` order): every
    real bond contracted, every dummy slot read at index 0."""
    tensors = np.asarray(tensors)
    V, D = spec.num_vertices, spec.degree
    mask = spec.mask_array()
    letters = iter(string.ascii_letters)
    bond = {}
    operands, subs, out = [], [], []
    for (iu, iv, su, sv) in spec.edges:
        bond[(iu, su)] = bond[(iv, sv)] = next(letters)
    for i in range(V):
        idx = tuple(slice(None) if mask[i, k] else 0 for k in range(D))
        operands.append(tensors[i][idx])
        site = next(letters)
        subs.append("".join(bond[(i, k)] for k in range(D) if mask[i, k])
                    + site)
        out.append(site)
    return np.einsum(",".join(subs) + "->" + "".join(out), *operands,
                     optimize="greedy")


def dense_site_expectations(psi, op):
    """⟨op⟩ on every site of a dense state [d]*V."""
    n = psi.ndim
    norm = np.vdot(psi, psi).real
    out = []
    for i in range(n):
        opsi = np.moveaxis(np.tensordot(op, psi, axes=(1, i)), 0, i)
        out.append((np.vdot(psi, opsi) / norm).real)
    return np.array(out)


class ForcedDraws:
    """Stands in for the port's draw hook (``sampling._draw``): hands out the
    given bitstrings ``[S, n]`` one column per call, in call order, and
    records the probabilities each call was offered."""

    def __init__(self, bits):
        import torch

        self.bits = torch.as_tensor(np.array(bits), dtype=torch.long)
        self.probs = []

    def __call__(self, probs, generator=None):
        out = self.bits[:, len(self.probs)]
        self.probs.append(probs.detach().clone())
        return out.to(probs.device)


def ghz_peps(spec, chi=2, d=2, dtype=np.complex128):
    """|0…0⟩ + |1…1⟩ as padded vertex tensors: every real bond leg carries
    the site's value, every dummy slot sits at index 0."""
    V, D = spec.num_vertices, spec.degree
    mask = spec.mask_array()
    t = np.zeros((V,) + (chi,) * D + (d,), dtype)
    for i in range(V):
        for s in range(2):
            t[i][tuple(s if mask[i, k] else 0 for k in range(D)) + (s,)] = 1.0
    return t


def product_peps(spec, site, chi=2, dtype=np.complex128):
    """The product state ⊗ site as padded vertex tensors (``site`` [d], or
    [V, d] per vertex)."""
    V, D = spec.num_vertices, spec.degree
    site = np.asarray(site)
    t = np.zeros((V,) + (chi,) * D + (site.shape[-1],), dtype)
    t[(slice(None),) + (0,) * D] = site
    return t


def dense_pair_expectation(psi, op1, i, op2, j):
    """⟨op1_i op2_j⟩ of a dense state [d]*V."""
    x = np.moveaxis(np.tensordot(op1, psi, axes=(1, i)), 0, i)
    x = np.moveaxis(np.tensordot(op2, x, axes=(1, j)), 0, j)
    return np.vdot(psi, x) / np.vdot(psi, psi).real
