"""Operation and byte counts against hand-worked shapes, and the readers
of the per-layer metrics on a made-up record."""

from __future__ import annotations

import pytest

from portbench import roofline, run


def test_eigh_and_roots_counts():
    # K2's n=256 Gram batch of 50 complex64 matrices
    flops, nbytes = roofline.eigh_work(256, 50, 8)
    assert flops == 36 * 50 * 256**3 == 30198988800
    assert nbytes == 50 * (2 * 256 * 256 * 8 + 256 * 4)
    flops, nbytes = roofline.roots_work(10, 72, 8)
    assert flops == 52 * 72 * 1000 and nbytes == 3 * 72 * 100 * 8


def test_message_counts_degree_three_and_four():
    # Eagle at chi 64: five absorbs and three contractions of 127·64^4·2
    flops, nbytes = roofline.message_work((127, 64, 64, 64, 2), 8)
    assert flops == 8 * 8 * 127 * 64**4 * 2
    assert nbytes == (127 * 64**3 * 2 + 2 * 127 * 3 * 64 * 64) * 8
    # 5x5 grid at chi 10: eight absorbs and four contractions
    flops, _ = roofline.message_work((25, 10, 10, 10, 10, 2), 8)
    assert flops == 8 * 12 * 25 * 10**5 * 2


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(495e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(495e9, 3.35e12) == pytest.approx(1.0)


def _record(**kw):
    base = dict(steps=10, spans={}, counts={"bp_sweep": 25}, profile=None,
                syncs=None)
    base.update(kw)
    return run.Record(**base)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    rec = _record()
    for name in ("eigh_roofline", "bp_message_roofline", "device_idle_pct",
                 "device_ops_per_step", "host_syncs_per_step",
                 "bp_device_ms_per_step", "update_device_ms_per_step",
                 "readout_device_ms_per_step"):
        assert run.metric_reader(name)(rec) is None, name
    assert run.metric_reader("bp_sweeps_per_step")(rec) == 2.5


def test_readers_on_hand_worked_spans():
    rec = _record(spans={
        "eigh": [(2.0, (256, 50, 8))],
        "roots": [(1.0, (64, 200, 8))],
        "bp_message": [(4.0, ((127, 64, 64, 64, 2), 8))],
        "bp_update": [(30.0, None), (10.0, None)],
        "group_update": [(50.0, None)],
        "readout": [(1.0, None)]},
        profile={"steps": 4, "device_ops": 800, "busy_s": 0.3,
                 "window_s": 0.4, "top": []},
        syncs={"steps": 4, "count": 26})
    # the eigh is bound by its operations, the n=64 roots by their bytes
    least = (36 * 50 * 256**3 / 495e12
             + 3 * 200 * 64 * 64 * 8 / 3.35e12)
    assert run.metric_reader("eigh_roofline")(rec) == pytest.approx(
        100 * least / 3e-3)
    msg = 8 * 8 * 127 * 64**4 * 2 / 495e12
    assert run.metric_reader("bp_message_roofline")(rec) == pytest.approx(
        100 * msg / 4e-3)
    assert run.metric_reader("bp_device_ms_per_step")(rec) == 4.0
    assert run.metric_reader("update_device_ms_per_step")(rec) == 5.0
    assert run.metric_reader("readout_device_ms_per_step")(rec) == 0.1
    assert run.metric_reader("device_ops_per_step")(rec) == 200
    assert run.metric_reader("host_syncs_per_step")(rec) == 6.5
    assert run.metric_reader("device_idle_pct")(rec) == pytest.approx(25.0)
