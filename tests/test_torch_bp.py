"""PyTorch port, flooding BP: the plain version of the K3 kernel
(`bp_outgoing_d3`) against the JAX Pallas kernel in interpret mode, the
routing of `TNQS_BP_KERNEL`, and `bp_update` against the JAX engine."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import cuda_bp as tb
from tensornetworkquantumsimulator_torch.parallel import engine as te
from tensornetworkquantumsimulator_torch.parallel import structure as ts
from tensornetworkquantumsimulator_torch.utils import lattices as t_lat
from tensornetworkquantumsimulator_tpu.parallel import engine as je
from tensornetworkquantumsimulator_tpu.parallel import pallas_bp as jb
from tensornetworkquantumsimulator_tpu.parallel import structure as js
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _random_state(rng, V, chi, d, D=3, dtype=np.complex64):
    t = (
        rng.standard_normal((V,) + (chi,) * D + (d,))
        + 1j * rng.standard_normal((V,) + (chi,) * D + (d,))
    ).astype(dtype) / chi
    m = (
        rng.standard_normal((V, D, chi, chi))
        + 1j * rng.standard_normal((V, D, chi, chi))
    ).astype(dtype)
    return t, m + np.conj(np.swapaxes(m, -1, -2))  # hermitian like messages


def test_plain_outgoing_matches_jax_kernel():
    """Scaled atol 2e-5, the bar of `tests/test_pallas_bp.py:55`."""
    rng = np.random.default_rng(5)
    t, m = _random_state(rng, 4, 8, 2)
    ref = np.asarray(jb.bp_outgoing_d3(jnp.asarray(t), jnp.asarray(m),
                                       interpret=True))
    got = tb.bp_outgoing_d3(torch.from_numpy(t), torch.from_numpy(m)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-5)


def test_kernel_gate_and_routing(monkeypatch):
    assert tb.bp_kernel_supported(3, 64, 2, torch.complex64, 127)
    assert tb.bp_kernel_supported(3, 8, 2, torch.complex64, 127)
    assert not tb.bp_kernel_supported(4, 64, 2, torch.complex64)
    assert not tb.bp_kernel_supported(3, 64, 2, torch.complex128)
    # V rides on gridDim.z: more than 65535 vertices go to the einsum chain
    assert tb.bp_kernel_supported(3, 2, 2, torch.complex64, 65535)
    assert not tb.bp_kernel_supported(3, 2, 2, torch.complex64, 65536)
    spec = ts.compile_graph(t_lat.heavy_hexagonal_lattice(2, 2))
    rng = np.random.default_rng(7)
    t, m = _random_state(rng, spec.num_vertices, 4, 2)
    state = te.BatchedState(torch.from_numpy(t), torch.from_numpy(m))
    monkeypatch.setenv("TNQS_BP_KERNEL", "0")
    ref = te.bp_iteration(spec, state)
    monkeypatch.setenv("TNQS_BP_KERNEL", "1")
    tb.bp_launches.reset()
    got = te.bp_iteration(spec, state)
    # a CPU tensor takes the plain version: no launch is counted
    assert tb.bp_launches.count == 0
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tb.bp_outgoing_d3(state.tensors[:, :2], state.messages)


@pytest.mark.parametrize("V,chi,d", [(127, 64, 2), (127, 8, 2), (3, 100, 2),
                                     (5, 33, 4), (1, 1, 1)])
def test_launch_plan_bounds_the_scratch_and_leaves_no_split_empty(V, chi, d):
    chunk, splits = tb.launch_plan(V, chi, d)
    assert 1 <= chunk <= V and 1 <= splits <= chi
    # the scratch holds one chunk of vertices: at most 64 MiB, or one vertex
    assert chunk == 1 or chunk * chi**3 * d * 8 <= 64 << 20
    rlen = -(-chi // splits)
    assert (splits - 1) * rlen < chi  # every split has an outer index
    if (V, chi, d) == (127, 64, 2):
        assert (chunk, splits) == (16, 8)


def test_kernel_gate_takes_physical_dims_up_to_four():
    assert all(tb.bp_kernel_supported(3, 8, d, torch.complex64, 4)
               for d in (1, 2, 3, 4))
    assert not tb.bp_kernel_supported(3, 8, 5, torch.complex64, 4)


@pytest.mark.parametrize("name", ["heavyhex2x2", "grid3x3"])
def test_bp_update_matches_jax_complex128(name):
    make = {"heavyhex2x2": lambda lat: lat.heavy_hexagonal_lattice(2, 2),
            "grid3x3": lambda lat: lat.named_grid((3, 3))}[name]
    spec_t = ts.compile_graph(make(t_lat))
    spec_j = js.compile_graph(make(j_lat))
    D, V = spec_t.degree, spec_t.num_vertices
    rng = np.random.default_rng(11)
    t, _ = _random_state(rng, V, 4, 2, D=D, dtype=np.complex128)
    m0 = np.broadcast_to(np.eye(4), (V, D, 4, 4)).astype(np.complex128)
    kw = dict(maxiter=40, tolerance=1e-13, damping=0.1)
    got = te.bp_update(spec_t, te.BatchedState(torch.from_numpy(t),
                                               torch.from_numpy(m0.copy())),
                       **kw).messages.numpy()
    ref = np.asarray(je.bp_update(
        spec_j, je.BatchedState(jnp.asarray(t), jnp.asarray(m0)), **kw
    ).messages)
    np.testing.assert_allclose(got, ref, atol=1e-10)
    # and the undamped default schedule
    got = te.bp_update(spec_t, te.BatchedState(torch.from_numpy(t),
                                               torch.from_numpy(m0.copy())))
    ref = je.bp_update(spec_j, je.BatchedState(jnp.asarray(t),
                                               jnp.asarray(m0)))
    np.testing.assert_allclose(got.messages.numpy(), np.asarray(ref.messages),
                               atol=1e-10)
