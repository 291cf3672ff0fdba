"""PyTorch port, the generic engine's belief propagation
(``engines/beliefpropagation.py``) and the graph layer it walks, against
the JAX package: the sequential forest-cover schedule edge for edge, and
the cache after ``update()`` on random states carried across from JAX as
plain data (the sweep at which BP stopped, the free energy, the partition
function, every message), in complex128 and complex64."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.engines import beliefpropagation as t_bp
from tensornetworkquantumsimulator_torch.models import state_from_numpy
from tensornetworkquantumsimulator_torch.utils import graphs as t_graphs
from tensornetworkquantumsimulator_torch.utils import lattices as t_lat
from tensornetworkquantumsimulator_tpu.engines import beliefpropagation as j_bp
from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _plain(j):
    """A JAX network as the port's plain form (``state_to_numpy``)."""
    def ind(i):
        return (i.id, i.dim, tuple(i.tags), i.plev)

    out = {"vertices": list(j.vertices()),
           "edges": [(e.src, e.dst) for e in j.edges()],
           "tensors": {v: (np.asarray(j[v].data), [ind(i) for i in j[v].inds])
                       for v in j.vertices()}}
    if type(j).__name__ == "TensorNetworkState":
        out["siteinds"] = {v: [ind(i) for i in s]
                           for v, s in j.siteinds().items()}
    return out


def _msg_array(m, inds):
    """A message's data in the order of ``inds`` (matched by (id, plev))."""
    pos = {(i.id, i.plev): k for k, i in enumerate(m.inds)}
    perm = [pos[(i.id, i.plev)] for i in inds]
    data = m.numpy() if hasattr(m, "numpy") else np.asarray(m.data)
    return np.transpose(data, perm)


GRAPHS = {
    "grid3x3": lambda lat: lat.named_grid((3, 3)),
    "grid4x5": lambda lat: lat.named_grid((4, 5)),
    "periodic3x4": lambda lat: lat.named_grid((3, 4), periodic=True),
    "comb4": lambda lat: lat.named_comb_tree((4, 3)),
    "path7": lambda lat: lat.named_path_graph(7),
    "heavyhex": lambda lat: lat.heavy_hexagonal_lattice(2, 2),
    "eagle": lambda lat: lat.ibm_eagle_lattice(),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_forest_cover_edge_sequence_equal(name):
    gj, gt = GRAPHS[name](j_lat), GRAPHS[name](t_lat)
    sj = [(e.src, e.dst) for e in j_graphs.forest_cover_edge_sequence(gj)]
    st = [(e.src, e.dst) for e in t_graphs.forest_cover_edge_sequence(gt)]
    assert st == sj
    assert [[tuple(e) for e in f.edges()] for f in gt.forest_cover()] == [
        [tuple(e) for e in f.edges()] for f in gj.forest_cover()]
    assert gt.is_tree() == gj.is_tree()
    assert gt.center() == gj.center()
    assert gt.leaf_vertices() == gj.leaf_vertices()


def _carried(name, dtype_j, bond, seed):
    g = GRAPHS[name](j_lat)
    psi_j = tnqs.random_tensornetworkstate(dtype_j, g, bond_dimension=bond,
                                           key=jax.random.PRNGKey(seed))
    return psi_j, state_from_numpy(_plain(psi_j))


def _stop_sweep(out: str):
    m = re.search(r"after (\d+) iterations", out)
    return None if m is None else int(m.group(1))


@pytest.mark.parametrize("dtype_j,tol,kw", [
    (jnp.complex128, 1e-10, dict(maxiter=60, tolerance=1e-12)),
    (jnp.complex64, 1e-5, dict(maxiter=30)),
])
def test_update_matches_jax(capsys, dtype_j, tol, kw):
    """3×3 random χ=3 state: the same stop sweep, free energy, Z and
    messages (fidelity and entries; messages are normalized to unit entry
    sum, so they carry no gauge)."""
    psi_j, psi_t = _carried("grid3x3", dtype_j, 3, 11)
    cj = tnqs.BeliefPropagationCache(psi_j).update(verbose=True, **kw)
    stop_j = _stop_sweep(capsys.readouterr().out)
    ct = tt.BeliefPropagationCache(psi_t).update(verbose=True, **kw)
    stop_t = _stop_sweep(capsys.readouterr().out)
    assert stop_t == stop_j and stop_j is not None
    np.testing.assert_allclose(ct.freenergy(), cj.freenergy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(ct.partitionfunction(), cj.partitionfunction(),
                               rtol=tol * 10)
    for e in cj.edges():
        for src, dst in ((e.src, e.dst), (e.dst, e.src)):
            mj = cj.message(j_graphs.NamedEdge(src, dst))
            mt = ct.message(t_graphs.NamedEdge(src, dst))
            a, b = _msg_array(mt, mj.inds), np.asarray(mj.data)
            fid = abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a) * np.vdot(b, b)).real
            assert 1 - fid <= tol, (src, dst, 1 - fid)
            np.testing.assert_allclose(a, b, atol=tol * np.abs(b).max() * 10)


def test_message_diff_and_scalars_match_jax():
    psi_j, psi_t = _carried("grid3x3", jnp.complex128, 2, 3)
    cj = tnqs.BeliefPropagationCache(psi_j).update(maxiter=3, tolerance=None)
    ct = tt.BeliefPropagationCache(psi_t).update(maxiter=3, tolerance=None)
    e = next(iter(cj.edges()))
    ej, et = j_graphs.NamedEdge(e.src, e.dst), t_graphs.NamedEdge(e.src, e.dst)
    dj = j_bp.message_diff(cj.message(ej), cj.default_message(ej))
    dt = t_bp.message_diff(ct.message(et), ct.default_message(et))
    np.testing.assert_allclose(dt, dj, rtol=1e-10)
    np.testing.assert_allclose(ct.vertex_scalars(), cj.vertex_scalars(),
                               rtol=1e-10)
    np.testing.assert_allclose(ct.edge_scalars(), cj.edge_scalars(),
                               rtol=1e-10)
    # rescaling sets every vertex and edge scalar to 1 in both
    rt, rj = ct.rescale(), cj.rescale()
    np.testing.assert_allclose(rt.vertex_scalars(), rj.vertex_scalars(),
                               atol=1e-10)
    np.testing.assert_allclose(rt.vertex_scalars(), 1.0, atol=1e-10)
    np.testing.assert_allclose(rt.edge_scalars(), 1.0, atol=1e-10)
    assert t_bp.default_tolerance(torch.complex64) == 1e-5
    assert t_bp.default_tolerance(torch.float64) == 1e-8


@pytest.mark.parametrize("name", ["comb4", "path7"])
def test_tree_converges_in_one_sweep(name):
    """On a tree the default schedule is exact in one sweep: the default
    update (maxiter 1) equals a converged one, and Z_BP equals the exact
    contraction."""
    psi_j, psi_t = _carried(name, jnp.float64, 2, 5)
    assert t_bp.BeliefPropagationCache(psi_t).default_bp_maxiter() == 1
    one = tt.BeliefPropagationCache(psi_t).update()
    many = tt.BeliefPropagationCache(psi_t).update(maxiter=10,
                                                   tolerance=1e-15)
    for e, m in many.messages().items():
        np.testing.assert_allclose(one.message(e).numpy(m.inds), m.numpy(),
                                   rtol=1e-12, atol=1e-14)
    exact = tt.norm_sqr(psi_t, alg="exact")
    np.testing.assert_allclose(one.partitionfunction(), exact, rtol=1e-10)
    np.testing.assert_allclose(
        one.partitionfunction(),
        tnqs.BeliefPropagationCache(psi_j).update().partitionfunction(),
        rtol=1e-10)


def test_flat_network_and_contract_dispatch():
    """A flat network (no site legs): exact, BP and boundary-MPS
    contraction through ``contract``, against JAX; ``"loopcorrections"`` is
    no backend of ``contract`` in either package, and the loop series on a
    BP cache matches JAX's."""
    gj = j_lat.named_grid((2, 3))
    tn_j = tnqs.random_tensornetwork(jnp.float64, gj, bond_dimension=2,
                                     key=jax.random.PRNGKey(2))
    tn_t = state_from_numpy(_plain(tn_j))
    assert isinstance(tn_t, tt.TensorNetwork)
    for alg in ("exact", "bp"):
        np.testing.assert_allclose(tt.contract(tn_t, alg=alg),
                                   tnqs.contract(tn_j, alg=alg), rtol=1e-10)
    for rank in (1, 2, 4):
        np.testing.assert_allclose(
            tt.contract(tn_t, alg="boundarymps", mps_bond_dimension=rank),
            tnqs.contract(tn_j, alg="boundarymps", mps_bond_dimension=rank),
            rtol=1e-10)
    for pkg, tn in ((tt, tn_t), (tnqs, tn_j)):
        with pytest.raises(ValueError, match="unknown contraction alg"):
            pkg.contract(tn, alg="loopcorrections")
    np.testing.assert_allclose(
        tt.loopcorrected_partitionfunction(
            tt.BeliefPropagationCache(tn_t).update(), 6),
        tnqs.loopcorrected_partitionfunction(
            tnqs.BeliefPropagationCache(tn_j).update(), 6), rtol=1e-10)


def test_carry_across_round_trip_and_ids():
    """``state_to_numpy`` / ``state_from_numpy`` keep arrays, indices and
    the graph; later indices never collide with carried ones."""
    psi_j, psi_t = _carried("grid3x3", jnp.complex128, 2, 9)
    back = tt.models.state_to_numpy(psi_t)
    ref = _plain(psi_j)
    assert back["vertices"] == ref["vertices"]
    assert back["edges"] == ref["edges"]
    assert back["siteinds"] == ref["siteinds"]
    for v, (arr, inds) in ref["tensors"].items():
        np.testing.assert_array_equal(back["tensors"][v][0], arr)
        assert back["tensors"][v][1] == inds
    largest = max(p[0] for _, inds in ref["tensors"].values() for p in inds)
    assert tt.Index(2).id > largest
    again = state_from_numpy(back)
    assert again.siteinds() == psi_t.siteinds()


def test_generic_constructors_default_to_cuda():
    """With the package default (CUDA) and no card, the constructors and
    the carry-across raise instead of falling back to the CPU."""
    prev = set_default_device(None)
    try:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        g = t_lat.named_grid((2, 2))
        for make in (lambda: tt.zerostate(g),
                     lambda: tt.random_tensornetworkstate(g),
                     lambda: tt.density_matrix_tensornetworkstate(
                         lambda v: "0", g),
                     lambda: state_from_numpy({"vertices": [], "edges": [],
                                               "tensors": {}})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    finally:
        set_default_device(prev)


def test_cache_carry_across():
    """A JAX cache's messages carried as plain data: the port's cache reads
    the same BP ⟨Z⟩ and Z as JAX's without another update, and
    ``cache_to_numpy`` / ``cache_from_numpy`` round-trip it."""
    psi_j, psi_t = _carried("grid3x3", jnp.complex128, 2, 21)
    cj = tnqs.BeliefPropagationCache(psi_j).update(maxiter=40, tolerance=1e-12)
    data = {"network": _plain(psi_j),
            "messages": {(e.src, e.dst): (np.asarray(m.data),
                                          [(i.id, i.dim, tuple(i.tags), i.plev)
                                           for i in m.inds])
                         for e, m in cj.messages().items()}}
    ct = t_bp.cache_from_numpy(data)
    obs = [("Z", [v]) for v in psi_j.vertices()]
    np.testing.assert_allclose(tt.expect(ct, obs), tnqs.expect(cj, obs),
                               atol=1e-12)
    np.testing.assert_allclose(ct.partitionfunction(), cj.partitionfunction(),
                               rtol=1e-12)
    back = t_bp.cache_from_numpy(t_bp.cache_to_numpy(ct))
    assert back.messages().keys() == ct.messages().keys()
    for e, m in ct.messages().items():
        np.testing.assert_array_equal(back.message(e).numpy(m.inds), m.numpy())
