"""PyTorch port, ``utils/checkpoint.py`` against the JAX package: a state
saved by either package's ``save_state`` / ``save_batched_state`` loads in
the other with equal tensors and wiring (the ``.npz`` formats are one);
round trips, extension-less paths, an index and its primed copy sharing
one fresh id after a reload, and vertex strings that are data, never
code."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.ops import index as t_index
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

from generic_carry import pair

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _data(t):
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t.data)


def _same_state(a, b):
    """Equal vertices, edges, arrays, and wiring: the same pattern of
    shared indices between tensors and site indices, dims, tags and prime
    levels (ids differ: every load mints fresh ones)."""
    assert list(a.vertices()) == list(b.vertices())
    assert [(e.src, e.dst) for e in a.edges()] == [(e.src, e.dst)
                                                   for e in b.edges()]

    def wiring(x):
        vs = list(x.vertices())
        key = {}
        for v in vs:
            for i in list(x[v].inds) + list(x.siteinds(v)):
                key.setdefault((i.id, i.plev), len(key))
        return [([key[(i.id, i.plev)] for i in x[v].inds],
                 [key[(i.id, i.plev)] for i in x.siteinds(v)],
                 [(i.dim, tuple(i.tags), i.plev) for i in x[v].inds])
                for v in vs]

    assert wiring(a) == wiring(b)
    for v in a.vertices():
        np.testing.assert_array_equal(_data(a[v]), _data(b[v]))


@pytest.mark.parametrize("dtype", [jnp.complex128, jnp.float32])
def test_state_across_packages(tmp_path, dtype):
    """JAX saves, the port loads, saves again, JAX loads: all equal; the
    port's copy measures as JAX's does."""
    psi_j, _ = pair(dtype, shape=(2, 3), seed=1)
    tnqs.save_state(str(tmp_path / "j.npz"), psi_j)
    psi_t = tt.load_state(str(tmp_path / "j.npz"))
    assert all(psi_t[v].device.type == "cpu" for v in psi_t.vertices())
    _same_state(psi_t, psi_j)
    tt.save_state(str(tmp_path / "t"), psi_t)  # no extension
    back = tnqs.load_state(str(tmp_path / "t"))
    _same_state(back, psi_j)
    np.testing.assert_allclose(
        tt.expect(psi_t, ("Z", [(1, 2)]), alg="exact"),
        tnqs.expect(psi_j, ("Z", [(1, 2)]), alg="exact"),
        rtol=1e-5 if dtype == jnp.float32 else 1e-12)


def test_state_round_trip_and_fresh_ids(tmp_path):
    """Port → port: equal state; the loaded ids are new, above every id
    the package had minted."""
    g = tt.named_grid((2, 2))
    psi = tt.random_tensornetworkstate(torch.complex64, g, bond_dimension=2)
    top = t_index._last_id
    tt.save_state(str(tmp_path / "s.npz"), psi)
    psi2 = tt.load_state(str(tmp_path / "s.npz"))
    _same_state(psi2, psi)
    assert min(i.id for v in psi2.vertices() for i in psi2[v].inds) > top


def test_primed_index_relation_survives_reload(tmp_path):
    i0 = tt.Index(2, tags=("Site",))
    i1 = i0.prime()
    t = tt.Tensor(torch.eye(2, dtype=torch.float64), (i0, i1))
    tns = tt.TensorNetworkState(
        tt.TensorNetwork({"v": t}, tt.NamedGraph(["v"])), {"v": [i0, i1]})
    path = str(tmp_path / "primed.npz")
    tt.save_state(path, tns)
    for loaded in (tt.load_state(path), tnqs.load_state(path)):
        s0, s1 = loaded.siteinds("v")
        assert s0.plev == 0 and s1.plev == 1
        assert s0.prime() == s1 and s1.noprime() == s0


def test_load_state_rejects_non_literal_vertices(tmp_path):
    psi = tt.random_tensornetworkstate(torch.float64, tt.named_grid((2, 1)),
                                       bond_dimension=2)
    path = str(tmp_path / "evil.npz")
    tt.save_state(path, psi)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["vertices"][0] = "__import__('os').getpid()"
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez(path, **arrays)
    with pytest.raises((ValueError, SyntaxError)):
        tt.load_state(path)


def test_batched_state_across_packages(tmp_path):
    """A product state on a 3×3 grid at χ=4 (complex64) and a random one:
    saved by each package, loaded by the other, arrays equal."""
    from tensornetworkquantumsimulator_tpu.parallel import (
        batched_product_state as j_product)

    _, st_j = j_product(j_lat.named_grid((3, 3)), chi=4, dtype=np.complex64)
    tnqs.save_batched_state(str(tmp_path / "j"), st_j)
    st_t = tt.load_batched_state(str(tmp_path / "j"))
    assert st_t.tensors.device.type == "cpu"
    np.testing.assert_array_equal(st_t.tensors.numpy(), np.asarray(st_j.tensors))
    np.testing.assert_array_equal(st_t.messages.numpy(),
                                  np.asarray(st_j.messages))
    rng = np.random.default_rng(0)
    st = tt.BatchedState(
        torch.from_numpy(rng.standard_normal((4, 2, 2, 2, 2, 2))
                         + 1j * rng.standard_normal((4, 2, 2, 2, 2, 2))),
        torch.from_numpy(rng.standard_normal((4, 4, 2, 2)) + 0j))
    tt.save_batched_state(str(tmp_path / "t.npz"), st)
    back = tnqs.load_batched_state(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(back.tensors), st.tensors.numpy())
    np.testing.assert_array_equal(np.asarray(back.messages),
                                  st.messages.numpy())
    again = tt.load_batched_state(str(tmp_path / "t.npz"))
    assert torch.equal(again.tensors, st.tensors)
