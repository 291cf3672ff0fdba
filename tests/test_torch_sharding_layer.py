"""PyTorch port, the sharded strip layer (``parallel/sharded_layer.py``):
one SPMD Trotter layer against JAX's ``make_sharded_layer`` on its virtual
CPU devices (complex128 and complex64) and against the port's unsharded
layer at S = 1, 2, 4; the layer's exchanges counted by ``mesh.traffic``
against the collectives of JAX's compiled program; and the sharded
readouts, gauge and truncation against JAX's on a BP-converged state."""

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import sharded_layer as t_sl
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import sharded_layer as j_sl

import sharded_cases as sc

torch.set_num_threads(1)
S, CHI = 4, 3
Z = np.diag([1.0, -1.0]).astype(np.complex128)
X = np.array([[0.0, 1.0], [1.0, 0.0]], np.complex128)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def test_layer_groups_equal_jax():
    jg, tg = sc.lattices("heavyhex")
    jss, tss = jp.shard_spec(jg, S, pad=True), tp.shard_spec(tg, S, pad=True)
    jgr, tgr = j_sl.build_layer_groups(jss), t_sl.build_layer_groups(tss)
    assert len(jgr) == len(tgr)
    for ga, gb in zip(jgr, tgr):
        assert [type(b).__name__ for b in ga] == [type(b).__name__ for b in gb]
        for a, b in zip(ga, gb):
            for f, x in vars(a).items():
                np.testing.assert_array_equal(getattr(b, f), x)
    for a, b in zip(j_sl._build_bond_tables(jss), t_sl._build_bond_tables(tss)):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(y, x)


@pytest.fixture(scope="module")
def fresh():
    """A random 4×4 grid state with identity messages, in 4 strips."""
    return sc.strip_case("grid4x4", S, CHI, seed=11, converge=False)


@pytest.fixture(scope="module")
def jax_layer(fresh):
    """JAX's layer with one BP sweep per refresh, compiled once: its
    output, and the collectives of its program."""
    jss, _, t, m = fresh
    gate2, gate1 = sc.gates()
    jmesh = sc.j_mesh((S,))
    layer = jp.make_sharded_layer(jss, jmesh, gate2, gate1, CHI,
                                  cutoff=1e-12, bp_maxiter=1)
    jin = sc.j_sharded(t, m, jmesh)
    compiled = layer.lower(jin).compile()
    out, errs = compiled(jin)
    return out, np.asarray(errs), sc.hlo_counts(compiled.as_text())


def _port_layer(tss, t, m, S_, **kw):
    gate2, gate1 = sc.gates()
    mesh = tp.ShardMesh(S_)
    layer = tp.make_sharded_layer(tss, mesh, gate2, gate1, CHI, cutoff=1e-12,
                                  **kw)
    ss = sc.port_sharded(mesh, t, m)
    mesh.traffic.reset()
    out, errs = layer(ss)
    return mesh, out, errs


def test_layer_matches_jax_complex128(fresh, jax_layer):
    jss, tss, t, m = fresh
    jout, jerrs, _ = jax_layer
    mesh, out, errs = _port_layer(tss, t, m, S, bp_maxiter=1)
    np.testing.assert_allclose(sc.to_np(errs), jerrs, atol=1e-10)
    spec = tss.spec
    zj = np.asarray(jp.local_expectations(jss.spec, jout, Z))
    zt = sc.to_np(t_sl.make_sharded_site_expectations(tss, mesh, Z)(out))
    np.testing.assert_allclose(zt, zj, atol=1e-8)
    xxj = np.asarray(jp.bond_expectations(jss.spec, jout, X, X))
    xxt = tp.bond_expectations(spec, mesh.gather(out), X, X).numpy()
    np.testing.assert_allclose(xxt, xxj, atol=1e-8)


def test_layer_traffic_equals_jax_program(fresh, jax_layer):
    """Zero gathers in a layer; its ppermutes equal the collective-permutes
    of JAX's compiled layer (one BP sweep per refresh, so each BP loop runs
    its two halo exchanges once)."""
    _, tss, t, m = fresh
    _, _, hlo = jax_layer
    mesh, _, _ = _port_layer(tss, t, m, S, bp_maxiter=1)
    calls = mesh.traffic.calls
    assert calls["all_gather"] == 0 and hlo["all-gather"] == 0
    assert calls["ppermute"] == hlo["collective-permute"] > 0
    groups = t_sl.build_layer_groups(tss)
    cross = sum(isinstance(b, t_sl._CrossBucket) for g in groups for b in g)
    refreshes = len(groups) + 1
    assert calls["ppermute"] == 2 * refreshes + 4 * cross
    assert calls["psum"] == refreshes


@pytest.fixture(scope="module")
def fresh_converged():
    """The state of ``fresh`` with JAX's BP fixed point as its messages."""
    return sc.strip_case("grid4x4", S, CHI, seed=11, converge=True)


# The layer's BP stops when the mean fidelity distance between two sweeps
# is at most the tolerance (reference `sharding.py:307-319`).  In complex64
# that distance is a float32 sum of 1 − |⟨a,b⟩|²/(‖a‖²‖b‖²) terms and
# resolves nothing below ~1e-7: once the messages change by less than
# ~3e-4 it reads noise of either sign, so at tolerance 0 each package
# stops at the first sweep whose noise reads ≤ 0, one to four sweeps
# before ``bp_maxiter``, and which sweep that is follows the rounding of
# the colour-group order (the hash seed).  The skipped sweeps move ⟨Z⟩ by
# up to ~1.7e-4.  A negative tolerance runs every refresh to
# ``bp_maxiter`` in both packages.
_F32_EPS = float(np.finfo(np.float32).eps)
# the "stop_test" bar on ⟨Z⟩ against JAX's complex128 layer, in units of
# the band the test measures: over hash seeds 0-63 the port's complex64
# layer read at most 1.11 bands from it and JAX's 1.12 (seed 18), so the
# bar has 2.2× headroom over the worst seed (`sharded_cases.py`'s
# `layer_readings`, run once per seed)
_STOP_BAND_FACTOR = 2.5


@pytest.mark.parametrize("case", ["stop_test", "fixed_sweeps",
                                  "fixed_sweeps_converged"])
def test_layer_matches_jax_complex64(case, fresh, fresh_converged):
    """The layer in complex64 in both packages, 10 BP sweeps at most per
    refresh; the truncation errors within 1e-4 of JAX's.

    ``stop_test`` (tolerance 0, so the complex64 stop test decides, see
    above): ⟨Z⟩ within ``_STOP_BAND_FACTOR`` × the band of JAX's
    complex128 layer, the distance between that layer run to 10 sweeps and
    stopped where a float32 distance loses resolution (tolerance ε32).
    ``fixed_sweeps`` / ``fixed_sweeps_converged`` (every refresh runs its
    10 sweeps, from identity messages / from the BP fixed point): the two
    complex64 layers compute the same function, ⟨Z⟩ within 1e-5."""
    jss, tss, t, m = fresh_converged if case.endswith("converged") else fresh
    t64, m64 = t.astype(np.complex64), m.astype(np.complex64)
    tol = 0.0 if case == "stop_test" else -1.0
    jmesh = sc.j_mesh((S,))

    def jax_layer(dtype, tolerance):
        gate2, gate1 = sc.gates(dtype)
        out, errs = jp.make_sharded_layer(
            jss, jmesh, gate2, gate1, CHI, cutoff=1e-12, bp_maxiter=10,
            bp_tolerance=tolerance)(
            sc.j_sharded(t.astype(dtype), m.astype(dtype), jmesh))
        return np.asarray(jp.local_expectations(jss.spec, out, Z)), errs

    zj, jerrs = jax_layer(np.complex64, tol)
    gate2, gate1 = sc.gates(np.complex64)
    mesh = tp.ShardMesh(S)
    out, errs = tp.make_sharded_layer(tss, mesh, gate2, gate1, CHI,
                                      cutoff=1e-12, bp_maxiter=10,
                                      bp_tolerance=tol)(
        sc.port_sharded(mesh, t64, m64))
    assert out.tensors[0].dtype == torch.complex64
    np.testing.assert_allclose(sc.to_np(errs), np.asarray(jerrs), atol=1e-4)
    zt = sc.to_np(t_sl.make_sharded_site_expectations(tss, mesh, Z)(out))
    if case != "stop_test":
        np.testing.assert_allclose(zt, zj, atol=1e-5)
        return
    z128, _ = jax_layer(np.complex128, 0.0)
    band = np.abs(jax_layer(np.complex128, _F32_EPS)[0] - z128).max()
    assert band > 1e-5  # the early stop moves ⟨Z⟩ on this case
    np.testing.assert_allclose(zt, z128, atol=_STOP_BAND_FACTOR * band)


@pytest.mark.parametrize("hashseed", ["52", "61"])
def test_layer_complex64_under_hash_seed(hashseed):
    """The complex64 layer test in a fresh process under the hash seeds
    that failed it while ⟨Z⟩ of the two complex64 layers at tolerance 0
    was held to 1e-4 (1.52e-4 at both, alone, before the repair)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONHASHSEED=hashseed, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"{__file__}::test_layer_matches_jax_complex64"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]


@pytest.mark.parametrize("S_", [1, 2, 4])
def test_layer_matches_unsharded(fresh, S_):
    """Two sharded layers against the port's unsharded layer on the same
    state: ⟨Z⟩, ⟨XX⟩ and the truncation errors within 1e-10."""
    _, tss4, t, m = fresh
    g = tt.named_grid((4, 4))
    tss = tp.shard_spec(g, S_)
    spec = tss.spec
    assert spec.vertices == tss4.spec.vertices
    gate2, gate1 = sc.gates()
    ref = tp.state_from_numpy(t, m, device="cpu")
    ref_errs = []
    for _ in range(2):
        ref = tp.apply_one_site(ref, torch.as_tensor(gate1))
        for grp in spec.color_groups:
            ref = tp.bp_update(spec, ref, tolerance=1e-12)
            ref, e = tp.apply_color_group(ref, grp, torch.as_tensor(gate2),
                                          CHI, 1e-12)
            ref_errs.append(e)
        ref = tp.bp_update(spec, ref, tolerance=1e-12)
    mesh = tp.ShardMesh(S_)
    layer = tp.make_sharded_layer(tss, mesh, gate2, gate1, CHI, cutoff=1e-12,
                                  bp_tolerance=1e-12)
    out = sc.port_sharded(mesh, t, m)
    for _ in range(2):
        out, errs = layer(out)
    np.testing.assert_allclose(
        sc.to_np(t_sl.make_sharded_site_expectations(tss, mesh, Z)(out)),
        tp.local_expectations(spec, ref, Z).numpy(), atol=1e-10)
    np.testing.assert_allclose(
        sc.to_np(t_sl.make_sharded_bond_expectations(tss, mesh, X, X)(out)),
        tp.bond_expectations(spec, ref, X, X).numpy(), atol=1e-10)
    # the sharded errors hold every edge's error once (padding reads 0)
    last = torch.cat(ref_errs[-len(spec.color_groups):]).numpy()
    np.testing.assert_allclose(np.sort(sc.to_np(errs))[-len(last):],
                               np.sort(last), atol=1e-10)


def test_layer_unfused_buckets_match_fused(fresh):
    """The sharded layer (each shard's buckets of a colour group in one
    stacked update) against the port's unsharded layer written out one
    slot-pair bucket at a time (one ``apply_color_group`` per bucket):
    ⟨Z⟩ and the errors within 1e-10."""
    _, tss, t, m = fresh
    spec = tss.spec
    gate2, gate1 = sc.gates()
    ref = tp.apply_one_site(tp.state_from_numpy(t, m, device="cpu"),
                            torch.as_tensor(gate1))
    ref_errs = []
    for grp in spec.color_groups:
        ref = tp.bp_update(spec, ref, tolerance=1e-12)
        for b in grp:
            ref, e = tp.apply_color_group(ref, (b,), torch.as_tensor(gate2),
                                          CHI, 1e-12)
            ref_errs.append(e)
    ref = tp.bp_update(spec, ref, tolerance=1e-12)
    assert len(ref_errs) > len(spec.color_groups)  # some group has buckets
    mesh, out, errs = _port_layer(tss, t, m, S, bp_tolerance=1e-12)
    np.testing.assert_allclose(
        sc.to_np(t_sl.make_sharded_site_expectations(tss, mesh, Z)(out)),
        tp.local_expectations(spec, ref, Z).numpy(), atol=1e-10)
    # the sharded errors hold every edge's error once (padding reads 0)
    last = torch.cat(ref_errs).numpy()
    np.testing.assert_allclose(np.sort(sc.to_np(errs))[-len(last):],
                               np.sort(last), atol=1e-10)


@pytest.fixture(scope="module")
def converged():
    jss, tss, t, m = sc.strip_case("grid4x4", S, CHI, seed=7)
    jmesh = sc.j_mesh((S,))
    mesh = sc.cpu_mesh(S)
    return jss, tss, jmesh, sc.j_sharded(t, m, jmesh), mesh, (t, m)


def _port(converged):
    _, _, _, _, mesh, (t, m) = converged
    mesh.traffic.reset()
    return sc.port_sharded(mesh, t, m)


def test_site_readouts_match_jax(converged):
    jss, tss, jmesh, jin, mesh, _ = converged
    ss = _port(converged)
    mesh.traffic.reset()
    zt = t_sl.make_sharded_site_expectations(tss, mesh, Z)(ss)
    rt = t_sl.make_sharded_site_rdms(tss, mesh)(ss)
    assert mesh.traffic.calls["ppermute"] == 0
    np.testing.assert_allclose(
        zt.numpy(), np.asarray(j_sl.make_sharded_site_expectations(
            jss, jmesh, Z)(jin)), atol=1e-10)
    np.testing.assert_allclose(
        rt.numpy(), np.asarray(j_sl.make_sharded_site_rdms(jss, jmesh)(jin)),
        atol=1e-10)


def test_bond_readouts_match_jax_one_ppermute_per_cross_bucket(converged):
    jss, tss, jmesh, jin, mesh, _ = converged
    ss = _port(converged)
    jfn = j_sl.make_sharded_bond_expectations(jss, jmesh, Z, X)
    compiled = jfn.lower(jin).compile()
    zx = t_sl.make_sharded_bond_expectations(tss, mesh, Z, X)(ss)
    hlo = sc.hlo_counts(compiled.as_text())
    assert mesh.traffic.calls["ppermute"] == hlo["collective-permute"]
    cross = sum(b[2] != 0 for b in t_sl._build_bond_tables(tss))
    assert mesh.traffic.calls["ppermute"] == cross > 0
    np.testing.assert_allclose(zx.numpy(), np.asarray(compiled(jin)),
                               atol=1e-10)
    rho = t_sl.make_sharded_bond_rdms(tss, mesh)(ss)
    np.testing.assert_allclose(
        rho.numpy(), np.asarray(j_sl.make_sharded_bond_rdms(jss, jmesh)(jin)),
        atol=1e-10)


def test_gauge_matches_jax(converged):
    jss, tss, jmesh, jin, mesh, _ = converged
    ss = _port(converged)
    jst, jspec = j_sl.make_sharded_gauge(jss, jmesh)(jin)
    out, spectra = t_sl.make_sharded_gauge(tss, mesh)(ss)
    np.testing.assert_allclose(spectra.numpy(), np.asarray(jspec), atol=1e-10)
    # and against the unsharded gauge, on which state, after it, ⟨Z⟩ holds
    ref, ref_spec = tp.batched_symmetric_gauge(
        tss.spec, tp.state_from_numpy(*converged[5], device="cpu"))
    np.testing.assert_allclose(spectra.numpy(), ref_spec.numpy(), atol=1e-10)
    np.testing.assert_allclose(
        sc.to_np(t_sl.make_sharded_site_expectations(tss, mesh, Z)(out)),
        np.asarray(jp.local_expectations(jss.spec, jst, Z)), atol=1e-10)


def test_truncate_matches_jax(converged):
    jss, tss, jmesh, jin, mesh, _ = converged
    ss = _port(converged)
    jst, jerrs = j_sl.make_sharded_truncate(jss, jmesh, CHI, cutoff=1e-3)(jin)
    out, errs = t_sl.make_sharded_truncate(tss, mesh, CHI, cutoff=1e-3)(ss)
    assert mesh.traffic.calls["all_gather"] == 0
    np.testing.assert_allclose(sc.to_np(errs), np.asarray(jerrs), atol=1e-8)
    np.testing.assert_allclose(
        sc.to_np(t_sl.make_sharded_site_expectations(tss, mesh, Z)(out)),
        np.asarray(jp.local_expectations(jss.spec, jst, Z)), atol=1e-8)
