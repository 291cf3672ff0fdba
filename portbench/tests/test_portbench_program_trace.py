"""The readers of the program's spans and counters (``program_trace.py``
and the seven metrics that read it): each value from a synthetic record,
None where the record has nothing to read, the device time of profiler
events filed under the program's ranges, and the host pass on a small
cell on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import program_trace as pt
from portbench import run
from portbench.tests.helpers import pinned, small_cell

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _record(host=None, device=None):
    record = run.Record(10, {}, {}, None, None)
    record.program = {"host": host, "device": device}
    return record


HOST = {"steps": 4,
        "spans": {"su.group": [60, 280.0, 12.0],
                  "bp.converge_read": [20, 2.0, 2.0]},
        "counters": {"bp.member_sweeps_active": 96,
                     "bp.member_sweeps_computed": 128,
                     "jacobi.eigh_sweeps": 480, "jacobi.eigh_matrices": 60,
                     "jacobi.roots_sweeps": 720,
                     "jacobi.roots_matrices": 480}}
DEVICE = {"steps": 2, "busy_ms": {"su.group": 13.0, "bp.update": 5.0},
          "self_busy_ms": {}, "idle_gaps": [], "device_ms": 20.0,
          "outside_ms": 0.0}
EXPECT = {"update_host_ms_per_step": 70.0, "update_busy_ms_per_step": 6.5,
          "bp_busy_ms_per_step": 2.5, "bp_sync_wait_ms_per_step": 0.5,
          "bp_active_member_share": 0.75, "eigh_sweeps_per_matrix": 8.0,
          "roots_sweeps_per_matrix": 1.5}


@pytest.mark.parametrize("name", pt.NEW)
def test_each_reader_reads_its_value_and_nothing_from_nothing(name):
    read = run.metric_reader(name)
    assert read(_record(HOST, DEVICE)) == pytest.approx(EXPECT[name])
    # a record of the harness as it stands, with no program passes
    assert read(run.Record(10, {}, {}, None, None)) is None
    assert read(_record()) is None
    assert read(_record({**HOST, "steps": 0}, {**DEVICE, "steps": 0})) is None
    empty_host = {"steps": 4, "spans": {}, "counters": {
        k: 0 for k in HOST["counters"]}}
    assert read(_record(empty_host, {**DEVICE, "busy_ms": {}})) is None


def test_every_program_metric_has_its_reader_file():
    assert set(EXPECT) == set(pt.NEW)
    for name in pt.NEW:
        assert (run.ROOT / "metrics" / f"{name}.py").is_file()
        assert callable(run.metric_reader(name))


def _cpu(name, start, end, kernels=(), thread=1):
    return SimpleNamespace(
        name=name, device_type=CPU, thread=thread,
        time_range=SimpleNamespace(start=start, end=end),
        kernels=[SimpleNamespace(name=k, device=0, duration=d)
                 for k, d in kernels])


def _gpu(name, start, end):
    return SimpleNamespace(name=name, device_type=CUDA, thread=7,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[])


def test_device_time_goes_to_the_spans_that_launched_it():
    """A layer holding a group update (an op launching two kernels, and a
    roots range launching a kernel itself, as a ctypes launch does) and a
    BP refresh; the device's copies of the ranges are not work."""
    events = [
        _cpu("tnqs.layer", 0, 100),
        _cpu("tnqs.su.group", 10, 60),
        _cpu("aten::mm", 12, 14, [("gemm", 5.0), ("tnqs.su.group", 40.0)]),
        _cpu("tnqs.linalg.roots", 20, 30, [("jacobi", 8.0)]),
        _cpu("tnqs.bp.update", 70, 90),
        _cpu("aten::einsum", 72, 75, [("einsum", 3.0)]),
        _cpu("aten::add", 95, 96, [("add", 1.0)]),
        _cpu("aten::copy_", 200, 201, [("memcpy", 2.0)]),
        _gpu("tnqs.su.group", 10, 60),
        _gpu("gemm", 15, 20), _gpu("jacobi", 22, 30), _gpu("einsum", 80, 83),
        _gpu("add", 96, 97), _gpu("memcpy", 205, 207),
    ]
    out = pt.attribute(events)
    assert out["busy_ms"] == pytest.approx(
        {"layer": 0.017, "su.group": 0.013, "linalg.roots": 0.008,
         "bp.update": 0.003})
    assert out["self_busy_ms"] == pytest.approx(
        {"su.group": 0.005, "linalg.roots": 0.008, "bp.update": 0.003,
         "layer": 0.001})
    assert out["outside_ms"] == pytest.approx(0.002)
    assert out["device_ms"] == pytest.approx(0.019)
    # gaps begin at 20 (roots), 30 (group), 83 (bp), 97 (layer) and 207
    # (past the last one: no gap)
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"tnqs.linalg.roots": 2e-6, "tnqs.su.group": 50e-6,
         "tnqs.bp.update": 13e-6, "tnqs.layer": 108e-6})


def test_a_gap_or_launch_outside_every_span_is_filed_as_such():
    out = pt.attribute([_cpu("aten::mm", 0, 1, [("gemm", 1.0)]),
                        _gpu("gemm", 1, 2), _gpu("gemm", 5, 6)])
    assert out["busy_ms"] == {} and out["outside_ms"] == pytest.approx(1e-3)
    assert out["idle_gaps"] == [[pt.OUTSIDE, pytest.approx(3e-6)]]


def test_the_host_pass_reads_the_program_on_a_small_cell():
    """Two steps of a two-member fold on the CPU: the layer's spans and
    BP's counters, per step as the readers take them."""
    from portbench import systems
    from portbench.lattices import build
    from portbench.traffic import Generator
    from tensornetworkquantumsimulator_torch import set_default_device

    cell = small_cell("grid5x5_chi10.disorder32", steps=2)
    cell["mix"]["members"] = 2
    config = cell["config"]
    try:
        with pinned(config):
            vertices, edges = build(config["lattice"])
            program = systems.load(config).Program(
                config, vertices, edges, 2, torch.device("cpu"))
            gen = Generator(cell["mix"], config, len(vertices), len(edges),
                            5)
            client = run.Client(program, gen)
            host = pt.host_pass(lambda: len(client.run(0, min_steps=2,
                                                       max_steps=2)))
    finally:
        set_default_device(None)
    assert host["steps"] == 2
    spans, counters = host["spans"], host["counters"]
    assert spans["layer"][0] == 2 and spans["readout"][0] == 2
    # the field layer updates each slot-pair bucket apart
    buckets = sum(len(group) for group in program.bucket_sizes())
    assert spans["su.group"][0] == 2 * buckets
    assert spans["su.group"][1] >= spans["su.group"][2] >= 0
    assert counters["bp.member_sweeps_computed"] == 2 * counters["bp.sweeps"]
    assert counters["host.reads.bp.converge"] == counters["bp.sweeps"] >= 10
    record = _record(host)
    assert run.metric_reader("update_host_ms_per_step")(record) > 0
    assert 0 < run.metric_reader("bp_active_member_share")(record) <= 1
