"""PyTorch port, sharded measurement: path correlators, sandwich overlaps,
the d=4 Pauli readout, boundary MPS (``parallel/sharded_bmps.py``) and loop
corrections (``parallel/sharded_loopcorrection.py``) on strip-sharded
states, each against the JAX package's sharded function on its virtual CPU
devices, in complex128 at 1e-8 on gauge-free outputs; and the two samplers
split over the sample axis, with every shard's draws forced to JAX's
bitstrings through a ``torch.Generator`` per shard."""

import jax
import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import (
    certified_sampling as t_cert,
)
from tensornetworkquantumsimulator_torch.parallel import sampling as t_smp
from tensornetworkquantumsimulator_tpu import parallel as jp

import measure_states as ms
import sharded_cases as sc

torch.set_num_threads(1)
S, CHI = 4, 2
Z = np.diag([1.0, -1.0]).astype(np.complex128)
X = np.array([[0.0, 1.0], [1.0, 0.0]], np.complex128)
_F32_ACCUMULATION = 5e-5  # the JAX certified sampler accumulates in float32


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.fixture(scope="module")
def case():
    """A BP-converged random 4×4 grid state in 4 strips, both packages."""
    jss, tss, t, m = sc.strip_case("grid4x4", S, CHI, seed=5)
    jmesh = sc.j_mesh((S,))
    return jss, tss, t, m, jmesh, sc.j_sharded(t, m, jmesh)


def _port(case, S_=S):
    _, tss, t, m, _, _ = case
    mesh = sc.cpu_mesh(S_)
    return mesh, sc.port_sharded(mesh, t, m)


def test_path_correlations_match_jax(case):
    jss, tss, t, m, jmesh, jin = case
    pairs = [((1, 1), (4, 4)), ((2, 2), (2, 3)), ((1, 3), (3, 1))]
    mesh, ss = _port(case)
    for kw in (dict(), dict(connected=True, real_output=True)):
        got = tp.make_sharded_path_correlations(tss, mesh, pairs, Z, X,
                                                **kw)(ss)
        want = np.asarray(jp.make_sharded_path_correlations(
            jss, jmesh, pairs, Z, X, **kw)(jin))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-8)
    # no halo exchange: the tables are assembled by psums
    assert mesh.traffic.calls["ppermute"] == 0
    ref = tp.make_path_correlation_fn(tss.spec, pairs, Z, X)(
        tp.state_from_numpy(t, m, device="cpu"))
    got = tp.make_sharded_path_correlations(tss, mesh, pairs, Z, X)(ss)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-10)


def test_inner_matches_jax(case):
    jss, tss, t, m, jmesh, jin = case
    rng = np.random.default_rng(9)
    t2 = t + 0.05 * (rng.standard_normal(t.shape)
                     + 1j * rng.standard_normal(t.shape)) * (t != 0)
    jphi = sc.j_sharded(t2, m, jmesh)
    want = jp.make_sharded_inner(jss, jmesh, tolerance=1e-12)(jin, jphi)
    mesh = sc.cpu_mesh(S)
    got = tp.make_sharded_inner(tss, mesh, tolerance=1e-12)(
        sc.port_sharded(mesh, t, m), sc.port_sharded(mesh, t2, m))
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], atol=1e-8)
    ref = tp.batched_inner(tss.spec, tp.state_from_numpy(t, m, device="cpu"),
                           tp.state_from_numpy(t2, m, device="cpu"),
                           tolerance=1e-12)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(r) for r in ref], atol=1e-8)


def test_pauli_expectations_match_jax():
    jg, tg = sc.lattices("grid4x3")
    jss, tss = jp.shard_spec(jg, S), tp.shard_spec(tg, S)
    spec = tss.spec
    t = ms.random_peps(spec, CHI, d=4, seed=4, amp=0.1)
    m = np.asarray(jp.identity_messages(spec.num_vertices, spec.degree, CHI,
                                        np.complex128))
    jmesh = sc.j_mesh((S,))
    ops = ("X", "Z")
    want = jp.make_sharded_pauli_expectations(
        jss, jmesh, CHI, np.complex128, ops, tolerance=1e-12)(
        sc.j_sharded(t, m, jmesh))
    mesh = sc.cpu_mesh(S)
    got = tp.make_sharded_pauli_expectations(
        tss, mesh, CHI, torch.complex128, ops, tolerance=1e-12)(
        sc.port_sharded(mesh, t, m))
    for op in ops:
        np.testing.assert_allclose(got[op].numpy(), np.asarray(want[op]),
                                   atol=1e-8)


@pytest.mark.parametrize("S_", [2, 4])
def test_grid_bmps_matches_jax(case, S_):
    """Rows in S_ shards: with 2 the row strips hold two rows each (an
    interior interface per shard), with 4 one row."""
    jss, tss, t, m, _, _ = case
    jrmesh = sc.j_mesh((S_,), ("r",))
    jn, je = jp.make_sharded_grid_bmps(jss.spec, 4, 4, jrmesh, kmps=4,
                                       niters=6)
    mesh, ss = _port(case, S_)
    rmesh = tp.ShardMesh(S_, ("r",), devices=mesh.devices)
    tn, te = tp.make_sharded_grid_bmps(tss.spec, 4, 4, rmesh, kmps=4,
                                       niters=6)
    lz, ph = tn(ss)
    jlz, jph = jn(t)
    np.testing.assert_allclose([float(lz), float(ph)],
                               [float(jlz), float(jph)], atol=1e-8)
    np.testing.assert_allclose(te(ss, Z).numpy(), np.asarray(je(t, Z)),
                               atol=1e-8)
    # the vertex strips hold the shards' rows: nothing is fetched; two
    # carries per pipeline step, per call
    assert rmesh.traffic.calls["fetch"] == 0
    assert rmesh.traffic.calls["ppermute"] == 2 * 2 * S_
    # and against the single-device evaluator
    un, ue = tp.make_grid_bmps(tss.spec, 4, 4, kmps=4, niters=6)
    np.testing.assert_allclose(te(ss, Z).numpy(),
                               ue(torch.as_tensor(t), Z).numpy(), atol=1e-8)


def test_planar_bmps_matches_jax():
    """A heavy-hex lattice (wires fill the empty grid positions), the state
    given as one whole tensor: against JAX's sharded planar evaluators and
    the port's single-device ones."""
    jg, tg = sc.lattices("heavyhex")
    jspec, spec = jp.compile_graph(jg), tp.compile_graph(tg)
    assert sc.same_spec(jspec, spec)
    pspec = tp.PlanarBMPSSpec(spec)
    t = ms.random_peps(spec, CHI, seed=2)
    S_ = pspec.nrows  # 5 rows, one a shard
    jn, je = jp.make_sharded_planar_bmps(jspec, sc.j_mesh((S_,), ("r",)),
                                         kmps=4, niters=4)
    mesh = sc.cpu_mesh(S_, ("r",))
    n, e = tp.make_sharded_planar_bmps(spec, mesh, kmps=4, niters=4)
    tt_ = torch.as_tensor(t)
    np.testing.assert_allclose([float(x) for x in n(tt_)],
                               [float(x) for x in jn(t)], atol=1e-8)
    np.testing.assert_allclose(e(tt_, Z).numpy(), np.asarray(je(t, Z)),
                               atol=1e-8)
    un, ue = tp.make_planar_bmps(spec, kmps=4, niters=4)
    np.testing.assert_allclose([float(x) for x in n(tt_)],
                               [float(x) for x in un(tt_)], atol=1e-10)
    np.testing.assert_allclose(e(tt_, Z).numpy(), ue(tt_, Z).numpy(),
                               atol=1e-10)


def test_loopcorrections_match_jax(case):
    jss, tss, t, m, jmesh, jin = case
    jg, tg = sc.lattices("grid4x4")
    # the owner and halo tables, equal to JAX's array for array
    from tensornetworkquantumsimulator_torch.parallel import (
        sharded_loopcorrection as t_slc,
    )
    from tensornetworkquantumsimulator_tpu.parallel import (
        sharded_loopcorrection as j_slc,
    )

    ja = j_slc._build_loop_tables(jss, jp.LoopConfigurations(jss.spec, jg, 4))
    ta = t_slc._build_loop_tables(tss, tp.LoopConfigurations(tss.spec, tg, 4))
    for (jk, _, jidx, jv), (tk, _, tidx, tv) in zip(ja[0], ta[0]):
        assert jk == tk
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta[1], ja[1])
    assert ta[2].keys() == ja[2].keys() and ta[3] == ja[3]
    for k in ja[2]:
        np.testing.assert_array_equal(ta[2][k], ja[2][k])
    want = complex(np.asarray(jp.make_sharded_loopcorrections(
        jss, jmesh, jg, max_configuration_size=4)(jin)))
    mesh, ss = _port(case)
    got = complex(tp.make_sharded_loopcorrections(
        tss, mesh, tg, max_configuration_size=4)(ss))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert mesh.traffic.calls["all_gather"] == 1
    ref = complex(tp.loopcorrected_partitionfunction(
        tss.spec, tp.state_from_numpy(t, m, device="cpu"), tg,
        max_configuration_size=4))
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_loopcorrected_expectations_match_jax(case):
    jss, tss, t, m, jmesh, jin = case
    jg, tg = sc.lattices("grid4x4")
    vs = list(tss.spec.vertices)
    obs = [("Z", [vs[5]]), ("X", [vs[10]]), ("ZZ", [vs[5], vs[6]], 0.5)]
    want = np.asarray(jp.make_sharded_loopcorrected_expectations(
        jss, jmesh, jg, obs, max_configuration_size=4)(jin))
    mesh, ss = _port(case)
    got = tp.make_sharded_loopcorrected_expectations(
        tss, mesh, tg, obs, max_configuration_size=4)(ss)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8)
    ref = tp.make_loopcorrected_expectations(tss.spec, tg, obs,
                                             max_configuration_size=4)(
        tp.state_from_numpy(t, m, device="cpu"))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-10)


def _generators(n):
    return [torch.Generator(device="cpu").manual_seed(s) for s in range(n)]


def test_rho_sampler_matches_jax_on_its_bitstrings(monkeypatch):
    jspec, jstate, tspec, tensors, messages = ms.converged("grid3x3", 2, 0,
                                                           d=4, amp=0.1)
    kw = dict(refresh_iters=4, init_maxiter=300, tolerance=1e-14)
    n, S_ = 4, 2
    jmesh = sc.j_mesh((S_,), ("s",))
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    bits_j, logps_j = jp.make_sharded_rho_sampler(
        jp.make_rho_sampler(jspec, 2, np.complex128, jit=False, **kw),
        jmesh)(jstate, keys)
    bits_j = np.asarray(bits_j)
    gens = _generators(S_)
    monkeypatch.setattr(t_smp, "_draw", sc.DrawsByGenerator(
        {g: bits_j[s * 2:(s + 1) * 2] for s, g in enumerate(gens)}))
    mesh = sc.cpu_mesh(S_, ("s",))
    sampler = tp.make_rho_sampler(tspec, 2, torch.complex128, **kw)
    bits, logps = tp.make_sharded_rho_sampler(sampler, mesh)(
        tp.state_from_numpy(tensors, messages), n, gens)
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    np.testing.assert_allclose(logps.numpy(), np.asarray(logps_j), atol=1e-8)
    # the single-device sampler on the same draws gives the same logps
    monkeypatch.setattr(t_smp, "_draw", ms.ForcedDraws(bits_j))
    _, logps1 = sampler(tp.state_from_numpy(tensors, messages), n)
    np.testing.assert_allclose(logps.numpy(), logps1.numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        tp.make_sharded_rho_sampler(sampler, mesh)(
            tp.state_from_numpy(tensors, messages), 3, gens[:1] * 2)


def test_certified_sampler_matches_jax_on_its_bitstrings(monkeypatch):
    jspec, jstate, tspec, tensors, _ = ms.converged("grid3x3", 2)
    kw = dict(norm_rank=4, projected_rank=4, niters=8)
    n, S_ = 4, 2
    jmesh = sc.j_mesh((S_,), ("s",))
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    bits_j, logq_j, lpq_j = jp.make_sharded_sampler(
        jp.make_grid_certified_sampler(jspec, 3, 3, **kw), jmesh)(
        jstate.tensors, keys)
    bits_j = np.asarray(bits_j)
    flat = bits_j.reshape(n, -1)  # row-major = call order
    gens = _generators(S_)
    monkeypatch.setattr(t_cert, "_draw", sc.DrawsByGenerator(
        {g: flat[s * 2:(s + 1) * 2] for s, g in enumerate(gens)}))
    mesh = sc.cpu_mesh(S_, ("s",))
    sampler = tp.make_grid_certified_sampler(tspec, 3, 3, **kw)
    bits, logq, lpq = tp.make_sharded_sampler(sampler, mesh)(
        torch.from_numpy(tensors), n, gens)
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    np.testing.assert_allclose(logq.numpy(), np.asarray(logq_j),
                               atol=_F32_ACCUMULATION)
    np.testing.assert_allclose(lpq.numpy(), np.asarray(lpq_j),
                               atol=_F32_ACCUMULATION)
    monkeypatch.setattr(t_cert, "_draw", ms.ForcedDraws(flat))
    _, logq1, lpq1 = sampler(torch.from_numpy(tensors), n)
    np.testing.assert_allclose(logq.numpy(), logq1.numpy(), atol=1e-12)
    np.testing.assert_allclose(lpq.numpy(), lpq1.numpy(), atol=1e-12)
