"""PyTorch port, where the entry points run: ``device=None`` means CUDA.

Without a CUDA device an entry point called with no ``device=`` raises,
naming CUDA, instead of running on the CPU quietly; with ``device="cpu"``
(or the package's default set to the CPU) it builds CPU tensors and
modules."""

import os
import tempfile

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import devices
from tensornetworkquantumsimulator_torch.utils import checkpoint

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cuda_default():
    """Every test starts from the package's own default (CUDA) and leaves
    it as it found it."""
    prev = tt.set_default_device(None)
    yield
    tt.set_default_device(prev)


def _grid():
    return tt.named_grid((2, 2))


def _layer_circuit(g):
    layer = [("Rx", [v], 0.3) for v in g.vertices()]
    for group in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 0.2) for pair in group]
    return tt.BatchedCircuit(layer, g)


def _state(**kw):
    return tt.batched_product_state(_grid(), chi=2, **kw)[1].tensors


def _from_numpy(**kw):
    t = np.zeros((2, 1, 2), np.complex64)
    m = np.ones((2, 1, 1, 1), np.complex64)
    return tt.parallel.state_from_numpy(t, m, **kw).messages


def _layer(**kw):
    return tt.make_layer_fn(_layer_circuit(_grid()), chi=2, **kw).mask


def _field_layer(**kw):
    return tt.parallel.make_field_layer_fn(_grid(), chi=2, **kw)[1].mask


def _noisy_layer(**kw):
    return tt.parallel.make_noisy_field_layer_fn(_grid(), chi=2, **kw)[1].mask


def _identity(**kw):
    return tt.parallel.identity_messages(3, 2, 2, torch.complex64, **kw)


def _load_state(**kw):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        tt.save_state(path, tt.random_tensornetworkstate(
            torch.float64, _grid(), bond_dimension=2, device="cpu"))
        return tt.load_state(path, **kw)[(1, 1)].data


def _load_batched_state(**kw):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "batched.npz")
        tt.save_batched_state(
            path, tt.batched_product_state(_grid(), chi=2, device="cpu")[1])
        return tt.load_batched_state(path, **kw).tensors


def _load_sharded_state(**kw):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sharded")
        checkpoint.save_sharded_state(
            path, tt.batched_product_state(_grid(), chi=2, device="cpu")[1])
        return checkpoint.load_sharded_state(path, **kw).tensors


# each entry point, returning one tensor of what it built
_ENTRY_POINTS = {
    "load_state": _load_state,
    "load_batched_state": _load_batched_state,
    "load_sharded_state": _load_sharded_state,
    "batched_product_state": _state,
    "state_from_numpy": _from_numpy,
    "make_layer_fn": _layer,
    "make_field_layer_fn": _field_layer,
    "make_noisy_field_layer_fn": _noisy_layer,
    "identity_messages": _identity,
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    build = _ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_runs_where_asked(name):
    build = _ENTRY_POINTS[name]
    assert build(device="cpu").device == torch.device("cpu")
    # the package's default, set once, serves every call without device=
    tt.set_default_device("cpu")
    assert build().device == torch.device("cpu")


def test_select_device_sets_the_default_and_full_precision():
    torch.backends.cuda.matmul.allow_tf32 = True
    assert tt.select_device("cpu") == torch.device("cpu")
    assert devices.resolve_device() == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert tt.set_default_device(None) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.select_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            devices.resolve_device("cuda")
