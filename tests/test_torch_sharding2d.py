"""PyTorch port, the 2-D block layout (``parallel/sharding2d.py``): the
block compiler's and the layer's bucket tables against the JAX package's,
one block-sharded Trotter layer against JAX's ``make_sharded_layer_2d`` on
a (2, 2) mesh of its virtual CPU devices and against the port's unsharded
layer, and the 2-D site and bond expectations and gauge against JAX's."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import sharding2d as t_2d
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import sharding2d as j_2d

import sharded_cases as sc
from measure_states import random_peps

torch.set_num_threads(1)
CHI = 3
Z = np.diag([1.0, -1.0]).astype(np.complex128)
X = np.array([[0.0, 1.0], [1.0, 0.0]], np.complex128)
BLOCK = P(("x", "y"))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.mark.parametrize("name,sx,sy", [("grid4x4", 2, 2), ("grid6x4", 3, 2)])
def test_block_tables_equal_jax(name, sx, sy):
    jg, tg = sc.lattices(name)
    jss, tss = jp.shard2d_spec(jg, sx, sy), tp.shard2d_spec(tg, sx, sy)
    assert sc.same_spec(jss.spec, tss.spec) and jss.halo == tss.halo
    np.testing.assert_array_equal(tss.src_index, jss.src_index)
    np.testing.assert_array_equal(tss.mask, jss.mask)
    for d in t_2d._DIRS:
        np.testing.assert_array_equal(tss.send_v[d], jss.send_v[d])
        np.testing.assert_array_equal(tss.send_slot[d], jss.send_slot[d])
    for ga, gb in zip(j_2d.build_layer_groups_2d(jss),
                      t_2d.build_layer_groups_2d(tss)):
        assert len(ga) == len(gb)
        for a, b in zip(ga, gb):
            for f, x in vars(a).items():
                np.testing.assert_array_equal(getattr(b, f), x)
    for a, b in zip(j_2d._build_bond_tables_2d(jss),
                    t_2d._build_bond_tables_2d(tss)):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(y, x)


@pytest.fixture(scope="module")
def case():
    jg, tg = sc.lattices("grid4x4")
    jss, tss = jp.shard2d_spec(jg, 2, 2), tp.shard2d_spec(tg, 2, 2)
    spec = tss.spec
    t = random_peps(spec, CHI, seed=21)
    m = np.asarray(jp.identity_messages(spec.num_vertices, spec.degree, CHI,
                                        np.complex128))
    return jss, tss, t, m, sc.j_mesh((2, 2), ("x", "y"))


def test_layer_2d_matches_jax_and_unsharded(case):
    jss, tss, t, m, jmesh = case
    gate2, gate1 = sc.gates()
    jout, jerrs = jp.make_sharded_layer_2d(jss, jmesh, gate2, gate1, CHI,
                                           cutoff=1e-12, bp_tolerance=1e-12)(
        sc.j_sharded(t, m, jmesh, BLOCK))
    mesh = sc.cpu_mesh((2, 2), ("x", "y"))
    out, errs = tp.make_sharded_layer_2d(tss, mesh, gate2, gate1, CHI,
                                         cutoff=1e-12, bp_tolerance=1e-12)(
        sc.port_sharded(mesh, t, m))
    assert mesh.traffic.calls["all_gather"] == 0
    np.testing.assert_allclose(sc.to_np(errs), np.asarray(jerrs), atol=1e-10)
    site = tp.make_sharded_site_expectations_2d(tss, mesh)
    zt = site(out, Z).numpy()
    np.testing.assert_allclose(
        zt, np.asarray(jp.local_expectations(jss.spec, jout, Z)), atol=1e-8)
    # the port's unsharded layer on the same state
    spec = tss.spec
    ref = tp.apply_one_site(tp.state_from_numpy(t, m, device="cpu"),
                            torch.as_tensor(gate1))
    for grp in spec.color_groups:
        ref = tp.bp_update(spec, ref, tolerance=1e-12)
        ref, _ = tp.apply_color_group(ref, grp, torch.as_tensor(gate2), CHI,
                                      1e-12)
    ref = tp.bp_update(spec, ref, tolerance=1e-12)
    np.testing.assert_allclose(zt, tp.local_expectations(spec, ref, Z).numpy(),
                               atol=1e-10)


@pytest.fixture(scope="module")
def converged(case):
    jss, tss, t, _, jmesh = case
    spec = tss.spec
    jst = jp.bp_update(jss.spec, jp.BatchedState(t, jp.identity_messages(
        spec.num_vertices, spec.degree, CHI, np.complex128)),
        maxiter=500, tolerance=1e-14)
    m = np.asarray(jst.messages)
    return jss, tss, t, m, jmesh, sc.j_sharded(t, m, jmesh, BLOCK)


def test_readouts_2d_match_jax(converged):
    jss, tss, t, m, jmesh, jin = converged
    mesh = sc.cpu_mesh((2, 2), ("x", "y"))
    ss = sc.port_sharded(mesh, t, m)
    np.testing.assert_allclose(
        tp.make_sharded_site_expectations_2d(tss, mesh)(ss, Z).numpy(),
        np.asarray(jp.make_sharded_site_expectations_2d(jss, jmesh)(jin, Z)),
        atol=1e-10)
    mesh.traffic.reset()
    zx = tp.make_sharded_bond_expectations_2d(tss, mesh, Z, X)(ss)
    cross = sum(b[2] is not None for b in t_2d._build_bond_tables_2d(tss))
    assert mesh.traffic.calls["ppermute"] == cross > 0
    np.testing.assert_allclose(
        zx.numpy(), np.asarray(jp.make_sharded_bond_expectations_2d(
            jss, jmesh, Z, X)(jin)), atol=1e-10)


def test_gauge_2d_matches_jax(converged):
    jss, tss, t, m, jmesh, jin = converged
    mesh = sc.cpu_mesh((2, 2), ("x", "y"))
    jst, jspec = jp.make_sharded_gauge_2d(jss, jmesh)(jin)
    out, spectra = tp.make_sharded_gauge_2d(tss, mesh)(
        sc.port_sharded(mesh, t, m))
    np.testing.assert_allclose(spectra.numpy(), np.asarray(jspec), atol=1e-10)
    np.testing.assert_allclose(
        tp.make_sharded_site_expectations_2d(tss, mesh)(out, Z).numpy(),
        np.asarray(jp.local_expectations(jss.spec, jst, Z)), atol=1e-10)
