"""PyTorch port, the multi-device substrate (``parallel/sharding.py``): the
``ShardMesh`` collectives on per-shard lists and their traffic counter,
the strip compiler's tables against the JAX package's array by array, the
halo-exchange BP fixed point against JAX's ``make_sharded_bp_update`` on
its virtual CPU devices and against the port's unsharded ``bp_update``,
``engine.apply_color_group_masked`` against JAX's, and the sharded
checkpoint round trip."""

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import engine as t_engine
from tensornetworkquantumsimulator_torch.utils import checkpoint as t_ckpt
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.parallel import engine as j_engine

import sharded_cases as sc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def test_mesh_defaults_to_cuda_and_places_on_the_default():
    set_default_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.ShardMesh(2)
    set_default_device("cpu")
    mesh = tp.ShardMesh((2, 3), ("x", "y"))
    assert mesh.num_shards == 6 and mesh.shape == {"x": 2, "y": 3}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        tp.ShardMesh(4, ("x", "y"))


def test_ppermute_copies_and_counts():
    mesh = tp.ShardMesh(4)
    xs = [torch.full((2, 3), float(s)) for s in range(4)]
    out = mesh.ppermute(xs, "v", mesh.ring("v", +1))
    assert [float(o[0, 0]) for o in out] == [3.0, 0.0, 1.0, 2.0]
    # a copy, never a view of the sender's storage
    assert all(o.data_ptr() != x.data_ptr() for o in out for x in xs)
    out[1].add_(5.0)
    assert float(xs[0][0, 0]) == 0.0
    snap = mesh.traffic.snapshot()
    assert snap == {"ppermute": {"calls": 1, "bytes": 4 * 6 * 4}}
    mesh.traffic.reset()
    assert mesh.traffic.snapshot() == {}


def test_collectives_on_a_block_mesh():
    """2-D: a ppermute acts per ring of its axis; psum and all_gather over
    one axis group the shards that share the other coordinate."""
    mesh = tp.ShardMesh((2, 3), ("x", "y"))
    xs = [torch.tensor([float(s)]) for s in range(6)]  # s = 3x + y
    along_y = mesh.ppermute(xs, "y", mesh.ring("y", +1))
    assert [float(o) for o in along_y] == [2, 0, 1, 5, 3, 4]
    along_x = mesh.ppermute(xs, "x", mesh.ring("x", +1))
    assert [float(o) for o in along_x] == [3, 4, 5, 0, 1, 2]
    assert [float(o) for o in mesh.psum(xs, "y")] == [3, 3, 3, 12, 12, 12]
    assert [float(o) for o in mesh.psum(xs, "x")] == [3, 5, 7, 3, 5, 7]
    assert [float(o) for o in mesh.psum(xs)] == [15] * 6
    g = mesh.all_gather(xs, "x")
    assert g[1].reshape(-1).tolist() == [1.0, 4.0]
    calls = mesh.traffic.calls
    assert (calls["ppermute"], calls["psum"], calls["all_gather"]) == (2, 3, 1)


def test_shard_and_gather_round_trip():
    mesh = tp.ShardMesh(4)
    t = torch.randn(8, 3, 2, dtype=torch.complex128)
    m = torch.randn(8, 2, 3, 3, dtype=torch.complex128)
    ss = mesh.shard(t_engine.BatchedState(t, m))
    assert [s.tensors.shape[0] for s in ss.shards] == [2] * 4
    back = mesh.gather(ss)
    assert torch.equal(back.tensors, t) and torch.equal(back.messages, m)
    with pytest.raises(ValueError):
        tp.ShardMesh(3).shard(t_engine.BatchedState(t, m))


@pytest.mark.parametrize("name,S,pad", [("grid4x4", 4, False),
                                        ("heavyhex", 4, True),
                                        ("grid6x4", 3, False)])
def test_shard_spec_tables_equal_jax(name, S, pad):
    jg, tg = sc.lattices(name)
    jss, tss = jp.shard_spec(jg, S, pad=pad), tp.shard_spec(tg, S, pad=pad)
    assert sc.same_spec(jss.spec, tss.spec)
    assert (jss.num_shards, jss.halo) == (tss.num_shards, tss.halo)
    for f in ("send_next_v", "send_next_slot", "send_prev_v",
              "send_prev_slot", "src_index", "mask"):
        np.testing.assert_array_equal(getattr(tss, f), getattr(jss, f))


@pytest.fixture(scope="module")
def bp_case():
    """A random grid state with identity messages, strip-sharded in 4."""
    return sc.strip_case("grid4x4", 4, 3, seed=3, converge=False)


def test_sharded_bp_matches_jax(bp_case):
    jss, tss, t, m = bp_case
    jmesh = sc.j_mesh((4,))
    jout = jp.make_sharded_bp_update(jss, jmesh, maxiter=60,
                                     tolerance=1e-12)(
        sc.j_sharded(t, m, jmesh))
    mesh = tp.ShardMesh(4)
    out = tp.make_sharded_bp_update(tss, mesh, maxiter=60, tolerance=1e-12)(
        sc.port_sharded(mesh, t, m))
    np.testing.assert_allclose(sc.to_np(out.messages),
                               np.asarray(jout.messages), atol=1e-8)
    assert mesh.traffic.calls["all_gather"] == 0


@pytest.mark.parametrize("S", [1, 2, 4])
def test_sharded_bp_matches_unsharded(bp_case, S):
    _, tss4, t, m = bp_case
    g = tt.named_grid((4, 4))
    tss = tp.shard_spec(g, S)
    assert tss.spec.vertices == tss4.spec.vertices
    ref = tp.bp_update(tss.spec, tp.state_from_numpy(t, m, device="cpu"),
                       maxiter=60, tolerance=1e-12)
    mesh = tp.ShardMesh(S)
    out = tp.make_sharded_bp_update(tss, mesh, maxiter=60, tolerance=1e-12)(
        sc.port_sharded(mesh, t, m))
    np.testing.assert_allclose(sc.to_np(out.messages),
                               ref.messages.numpy(), atol=1e-10)
    # one psum per sweep, two halo ppermutes per sweep
    assert mesh.traffic.calls["ppermute"] == 2 * mesh.traffic.calls["psum"]


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_apply_color_group_masked_matches_jax(monkeypatch, fuse):
    """The traced-table group apply: padded canonical buckets (pad lanes
    gather vertex 0 and write nothing) against JAX's function.  The port
    always stacks the buckets' updates into one; ``TNQS_FUSE_BUCKETS`` is
    read by the JAX package only, which with ``0`` updates one bucket at a
    time, so ``fuse="0"`` holds the stacked update to a per-bucket one."""
    monkeypatch.setenv("TNQS_FUSE_BUCKETS", fuse)
    jg, tg = sc.lattices("grid4x3")
    jspec = jp.compile_graph(jg)
    tspec = tt.compile_graph(tg)
    assert sc.same_spec(jspec, tspec)
    from measure_states import random_peps

    chi, V = 3, tspec.num_vertices
    t = random_peps(tspec, chi, seed=5)
    jst = jp.bp_update(jspec, jp.BatchedState(
        t, jp.identity_messages(V, tspec.degree, chi, np.complex128)),
        maxiter=200, tolerance=1e-14)
    m = np.asarray(jst.messages)
    gate2, _ = sc.gates()
    group = tspec.color_groups[0]
    slot_pairs, tabs = [], []
    for b in group:
        B = len(b.u_idx) + 1  # one pad lane
        u = np.zeros(B, np.int64)
        v = np.zeros(B, np.int64)
        u[:-1], v[:-1] = b.u_idx, b.v_idx
        valid = np.arange(B) < B - 1
        inv = {k: np.zeros(V, np.int64) for k in ("u", "v")}
        wr = {k: np.zeros(V, bool) for k in ("u", "v")}
        for lane in range(B - 1):
            for k, idx in (("u", u), ("v", v)):
                inv[k][idx[lane]], wr[k][idx[lane]] = lane, True
        slot_pairs.append((b.slot_u, b.slot_v))
        tabs.append(dict(u_tab=u, v_tab=v, valid=valid, u_inv=inv["u"],
                         u_wr=wr["u"], v_inv=inv["v"], v_wr=wr["v"]))
    jout, jerr = j_engine.apply_color_group_masked(
        jst, tuple(slot_pairs), [{k: np.asarray(x) for k, x in tb.items()}
                                 for tb in tabs], gate2, chi, 1e-12)
    tout, terr = t_engine.apply_color_group_masked(
        tp.state_from_numpy(t, m, device="cpu"), tuple(slot_pairs),
        [{k: torch.as_tensor(x) for k, x in tb.items()} for tb in tabs],
        torch.as_tensor(gate2), chi, 1e-12)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), atol=1e-12)
    pads = ~np.concatenate([tb["valid"] for tb in tabs])
    assert (terr.numpy()[pads] == 0.0).all()  # a pad lane's error reads 0
    # one sweep of BP on both results, then ⟨Z⟩: gauge-free
    Z = np.diag([1.0, -1.0])
    zj = np.asarray(jp.local_expectations(jspec, jp.bp_update(
        jspec, jout, maxiter=200, tolerance=1e-14), Z))
    zt = tp.local_expectations(tspec, tp.bp_update(
        tspec, tout, maxiter=200, tolerance=1e-14), Z).numpy()
    np.testing.assert_allclose(zt, zj, atol=1e-8)
    # and it equals the port's own unmasked group apply
    ref, _ = t_engine.apply_color_group(
        tp.state_from_numpy(t, m, device="cpu"), group,
        torch.as_tensor(gate2), chi, 1e-12)
    np.testing.assert_allclose(tout.tensors.numpy(), ref.tensors.numpy(),
                               atol=1e-12)


def test_sharded_checkpoint_round_trip(tmp_path, bp_case):
    """One ``.npz`` per shard plus a manifest; loaded onto a mesh bit for
    bit (also onto a mesh of another shard count), or as one host state."""
    _, _, t, m = bp_case
    mesh = tp.ShardMesh(4)
    ss = sc.port_sharded(mesh, t, m)
    path = tmp_path / "ckpt"
    t_ckpt.save_sharded_state(str(path), ss, mesh)
    assert sorted(p.name for p in path.iterdir()) == [
        "manifest.json"] + [f"shard_{s:05d}.npz" for s in range(4)]
    back = t_ckpt.load_sharded_state(str(path), tp.ShardMesh(4))
    for a, b in zip(back.shards, ss.shards):
        assert torch.equal(a.tensors, b.tensors)
        assert torch.equal(a.messages, b.messages)
    two = t_ckpt.load_sharded_state(str(path), tp.ShardMesh(2))
    assert torch.equal(torch.cat(two.tensors), torch.as_tensor(t))
    host = t_ckpt.load_sharded_state(str(path))
    assert host.tensors.device.type == "cpu"
    assert np.array_equal(host.messages.numpy(), m)
    with pytest.raises(FileExistsError):
        t_ckpt.save_sharded_state(str(path), ss)
