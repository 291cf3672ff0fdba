"""PyTorch port, ``utils/profiling.py``: a ``torch.profiler`` trace
written to the log directory, the layer timer on the CPU (host clock, no
device to wait for), and the config dataclasses, as the JAX package's
``tests/test_profiling.py`` checks them."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.utils.profiling import (
    ApplyConfig,
    BPUpdateConfig,
    LayerTimer,
    trace,
)
from tensornetworkquantumsimulator_tpu.utils import profiling as j_profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace lands in ``log_dir/trace.json``, which is what ``trace``
    yields (as the JAX package's does), and holds the region's matmul."""
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as where:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert where == log_dir
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_defaults_to_the_reference_directory(tmp_path, monkeypatch):
    """With no argument ``trace`` writes under ``/tmp/tnqs-trace``, the JAX
    package's default, not under the working directory.  The directory it
    creates and the file it exports are recorded, not written, so the test
    writes nothing outside its own temporary directory."""
    monkeypatch.chdir(tmp_path)
    made, exported = [], []
    monkeypatch.setattr(os, "makedirs", lambda d, **kw: made.append(d))
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        lambda self, path: exported.append(path))
    with trace() as where:
        torch.ones(8, 8) @ torch.ones(8, 8)
    reference = inspect.signature(j_profiling.trace).parameters["log_dir"]
    assert where == "/tmp/tnqs-trace" == reference.default
    assert made == [where]
    assert exported == [os.path.join(where, "trace.json")]
    assert list(tmp_path.iterdir()) == []


def test_layer_timer_accumulates():
    t = LayerTimer()
    x = torch.ones(4, 4)
    with t.layer(x):
        y = x @ x
    out = t.time_fn(lambda a: a @ a, y)
    assert torch.equal(out, y @ y)
    assert len(t.times) == 2 and all(dt >= 0 for dt in t.times)
    assert t.last == t.times[-1]
    assert abs(t.mean - sum(t.times) / 2) < 1e-12
    assert LayerTimer().last != LayerTimer().last  # nan when empty


def test_layer_timer_on_a_generic_state():
    """A generic-engine call timed on the CPU's host clock (this process
    has not initialized CUDA)."""
    assert not torch.cuda.is_initialized()
    psi = tt.random_tensornetworkstate(torch.float64, tt.named_grid((2, 2)),
                                       bond_dimension=2)
    t = LayerTimer()
    z = t.time_fn(lambda p: tt.norm_sqr(p, alg="exact"), psi)
    assert len(t.times) == 1 and t.times[0] > 0 and np.isfinite(z)


def test_config_dataclasses_match_jax():
    for kw in (dict(maxdim=8, cutoff=1e-10, normalize_tensors=False), {}):
        assert ApplyConfig(**kw).asdict() == j_profiling.ApplyConfig(
            **kw).asdict()
    for kw in (dict(maxiter=7, tolerance=1e-6, verbose=True), {}):
        assert BPUpdateConfig(**kw).asdict() == j_profiling.BPUpdateConfig(
            **kw).asdict()
    assert "maxiter" not in BPUpdateConfig().asdict()
