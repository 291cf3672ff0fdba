"""PyTorch port, the generic engine's boundary-MPS backend
(``engines/boundarymps.py`` and the "boundarymps" branches of
``measure.py`` and ``engines/contract.py``) against the JAX package on
states carried across as plain data: ``expect``, ``norm_sqr``, ``inner``
and ``rdm`` at fixed sweeps, truncating (ranks 1-3) and not; the cache
itself (partition function, the "ITensorMPS" update, strand truncation);
row and column partitions, a cylinder (ring of partitions) and the
triangular lattice's two-bond interfaces; and convergence in the rank to
"exact".  Bars: 1e-10 in complex128, 1e-4 in complex64 (gauge-free
outputs only).

On the CPU both packages factorize with numpy's LAPACK, so the fitting
sweeps take the same path even where the boundary MPS truncates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.models import state_from_numpy
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

from generic_carry import pair, plain

torch.set_num_threads(1)
DTYPES = [(jnp.complex128, 1e-10), (jnp.complex64, 1e-4)]
OBS = [("Z", [(2, 2)]), ("X", [(1, 1)], 0.5), ("ZZ", [(2, 1), (2, 2)]),
       ("XY", [(3, 1), (3, 3)])]


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rank,upd", [
    (1, {}), (2, {}), (3, dict(maxiter=2, niters=4)), (4, {})])
def test_expect_norm_inner_rdm(dtype, tol, rank, upd):
    """3×3 χ=2: every measurement at the same rank and sweeps."""
    psi_j, psi_t = pair(dtype)
    kw = dict(mps_bond_dimension=rank, cache_update_kwargs=upd)
    np.testing.assert_allclose(
        tt.expect(psi_t, OBS[:2], alg="boundarymps", **kw),
        tnqs.expect(psi_j, OBS[:2], alg="boundarymps", **kw), atol=tol)
    np.testing.assert_allclose(
        tt.expect(psi_t, OBS[2:], alg="boundarymps", **kw),
        tnqs.expect(psi_j, OBS[2:], alg="boundarymps", **kw), atol=tol)
    for f in ("norm_sqr", "norm"):
        np.testing.assert_allclose(getattr(tt, f)(psi_t, alg="boundarymps", **kw),
                                   getattr(tnqs, f)(psi_j, alg="boundarymps", **kw),
                                   rtol=tol)
    phi_j = psi_j.map_virtualinds(lambda i: i.sim()).map_tensors(
        lambda t: t * 1.1)
    phi_t = state_from_numpy(plain(phi_j))
    np.testing.assert_allclose(tt.inner(psi_t, phi_t, alg="boundarymps", **kw),
                               tnqs.inner(psi_j, phi_j, alg="boundarymps", **kw),
                               rtol=tol)
    vs = [(2, 1), (2, 3)]
    rt = tt.rdm(psi_t, vs, alg="boundarymps", **kw)
    rj = tnqs.rdm(psi_j, vs, alg="boundarymps", **kw)
    from generic_carry import aligned
    np.testing.assert_allclose(aligned(rt, rj.inds), np.asarray(rj.data),
                               atol=tol)


def test_column_partitions_and_cache():
    """A column observable partitions by columns; the cache itself: the
    partition function, a rank-2 strand truncation, and ``expect`` on an
    updated cache."""
    psi_j, psi_t = pair(jnp.complex128, shape=(3, 4), seed=4)
    obs = [("ZZ", [(1, 2), (3, 2)]), ("Y", [(2, 2)])]
    kw = dict(mps_bond_dimension=3)
    np.testing.assert_allclose(tt.expect(psi_t, obs, alg="boundarymps", **kw),
                               tnqs.expect(psi_j, obs, alg="boundarymps", **kw),
                               atol=1e-10)
    for by in ("row", "col"):
        ct = tt.BoundaryMPSCache(psi_t, 3, partition_by=by).update()
        cj = tnqs.BoundaryMPSCache(psi_j, 3, partition_by=by).update()
        np.testing.assert_allclose(ct.partitionfunction(),
                                   cj.partitionfunction(), rtol=1e-10)
        pe_t, pe_j = ct.partitionedges()[0], cj.partitionedges()[0]
        assert (pe_t.src, pe_t.dst) == (pe_j.src, pe_j.dst)
        ct.truncate_interpartition_inplace(pe_t, maxdim=2)
        cj.truncate_interpartition_inplace(pe_j, maxdim=2)
        np.testing.assert_allclose(ct.edge_scalar(pe_t), cj.edge_scalar(pe_j),
                                   rtol=1e-10)
        vt = tt.expect(ct, [("Z", [(2, 2)])], alg="boundarymps")
        vj = tnqs.expect(cj, [("Z", [(2, 2)])], alg="boundarymps")
        np.testing.assert_allclose(vt, vj, atol=1e-10)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flat_network(dtype, tol):
    """A flat random network: the cache's default densifying
    ("ITensorMPS") update at ranks 2 and 4, against JAX and (rank 4)
    against "exact"."""
    g = j_lat.named_grid((3, 3))
    tn_j = tnqs.random_tensornetwork(dtype, g, bond_dimension=2,
                                     key=jax.random.PRNGKey(5))
    tn_t = state_from_numpy(plain(tn_j))
    for rank in (2, 4):
        zt = tt.BoundaryMPSCache(tn_t, rank).update().partitionfunction()
        zj = tnqs.BoundaryMPSCache(tn_j, rank).update().partitionfunction()
        np.testing.assert_allclose(zt, zj, rtol=tol)
    np.testing.assert_allclose(zt, tt.contract(tn_t, alg="exact"),
                               rtol=tol)


def _evolved(jmod, g, layers=2, maxdim=4):
    layer = [("Rx", [v], 0.3) for v in g.vertices()]
    layer += [("Rzz", [e.src, e.dst], 0.25) for e in g.edges()]
    psi = jmod.tensornetworkstate(
        jnp.complex128 if jmod is tnqs else torch.complex128,
        lambda v: "↑", g)
    for _ in range(layers):
        psi, _ = jmod.apply_circuit(layer, psi, apply_kwargs=dict(
            maxdim=maxdim, cutoff=1e-12, normalize_tensors=False))
    return psi


def test_cylinder_ring_partitions():
    """4×3 cylinder (rows wrap): a ring of partitions; the port's own
    evolution measured by "boundarymps" at rank 16 against "exact", and
    JAX's state measured by both packages at rank 4."""
    g_t = tt.named_grid((4, 3), periodic=(True, False))
    psi_t = _evolved(tt, g_t)
    obs = ("Z", [(2, 2)])
    np.testing.assert_allclose(
        tt.expect(psi_t, obs, alg="boundarymps", mps_bond_dimension=16),
        tt.expect(psi_t, obs, alg="exact"), atol=1e-9)
    psi_j = _evolved(tnqs, j_lat.named_grid((4, 3), periodic=(True, False)))
    psi_c = state_from_numpy(plain(psi_j))
    np.testing.assert_allclose(
        tt.expect(psi_c, obs, alg="boundarymps", mps_bond_dimension=4),
        tnqs.expect(psi_j, obs, alg="boundarymps", mps_bond_dimension=4),
        atol=1e-10)


def test_triangular_two_bond_interfaces():
    """The triangular lattice puts two bonds between a vertex and the next
    row: exact at full rank, and JAX's value at rank 3."""
    g = j_lat.triangular_lattice(3, 3)
    psi_j, psi_t = pair(jnp.complex128, graph=g, seed=3)
    obs = ("Z", [(2, 2)])
    np.testing.assert_allclose(
        tt.expect(psi_t, obs, alg="boundarymps", mps_bond_dimension=16),
        tt.expect(psi_t, obs, alg="exact"), atol=1e-10)
    np.testing.assert_allclose(
        tt.expect(psi_t, obs, alg="boundarymps", mps_bond_dimension=3),
        tnqs.expect(psi_j, obs, alg="boundarymps", mps_bond_dimension=3),
        atol=1e-10)


def test_rank_convergence_to_exact():
    """4×4 χ=2: the error against "exact" at ranks 1, 2, 4, 16 ends below
    1e-8 and below BP's."""
    psi_j, psi_t = pair(jnp.complex128, shape=(4, 4), seed=6)
    obs = [("Z", [(2, 2)]), ("X", [(3, 3)])]
    exact = np.array(tt.expect(psi_t, obs, alg="exact"))
    bp = np.array(tt.expect(psi_t, obs, alg="bp"))
    errs = [np.abs(np.array(tt.expect(psi_t, obs, alg="boundarymps",
                                      mps_bond_dimension=r)) - exact).max()
            for r in (1, 2, 4, 16)]
    assert errs[-1] < 1e-8 < np.abs(bp - exact).max()
