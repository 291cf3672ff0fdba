"""The two-band check of ``systems/field_layer_banded.py`` and the readers
of the Eagle cell's per-layer metrics (``k3_roofline``,
``eigh256_roofline``) and of the program's QR fallback share, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import check, lattices, run, traffic
from portbench.reference import Lattice
from portbench.systems import field_layer_banded, load
from portbench.systems.field_layer_banded import FLOOR, relative_gap
from portbench.tests.helpers import SEED, files_cell, pinned, small_cell

CELL = "eagle127_chi64.sweep"


@pytest.fixture(autouse=True)
def cpu_default():
    from tensornetworkquantumsimulator_torch import set_default_device

    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def test_the_cell_loads_its_banded_system_and_three_limits():
    cell = run.load_cell(CELL)
    assert load(cell["config"]) is field_layer_banded
    assert set(cell["limits"]) == {"edges_off_schedule",
                                   "max_rel_dz_uncapped", "max_abs_dz"}
    assert cell["limits"]["edges_off_schedule"]["limit"] == 0
    assert cell["per_layer"] == ["k3_roofline", "eigh256_roofline"]
    # an Rzz layer at most doubles a rank: the cap cannot bind sooner
    assert 2 ** cell["config"]["uncapped_steps"] <= cell["config"]["chi"]


def test_the_new_configuration_is_the_old_one_with_the_banded_check():
    new = run.load_cell(CELL)["config"]
    old = files_cell("eagle127_kicked_ising_chi64", "theta_h_sweep")["config"]
    same = ("lattice", "colour_groups", "chi", "dtype", "cutoff",
            "bp_maxiter", "bp_tolerance", "normalize_tensors",
            "site_rotations", "bond_rotation", "params", "knobs",
            "python_hash_seed", "reduced")
    assert {k: new[k] for k in same} == {k: old[k] for k in same}
    assert new["system"] == "field_layer_banded"


def _eagle_small(steps=4, uncapped=2):
    cell = small_cell(files_cell("kim2023_eagle127_kicked_ising_chi64",
                                 "theta_h_sweep"), chi=4, steps=steps)
    cell["config"]["uncapped_steps"] = uncapped
    return cell


def _program_results(cell, picks):
    config, mix = cell["config"], cell["mix"]
    vertices, edges = lattices.build(config["lattice"])
    program = field_layer_banded.Program(config, vertices, edges,
                                         mix["members"], "cpu")
    gen = traffic.Generator(mix, config, len(vertices), len(edges), SEED)
    results = {}
    for i in picks:
        client = run.Client(program, gen)
        client.index = i - 1
        for _ in range(gen.steps):
            client.step()
        results[i] = client.results[i]
    return vertices, edges, program.schedule, gen, results


def test_the_bands_split_the_steps_and_hold_the_program():
    """On Eagle at χ=4 (the cap binds after step 2) the uncapped steps read
    ~1e-6 (a ratio of ~1e-5) and the capped ones up to 6e-4 (θ_h near π/2:
    the Clifford Rzz layers leave near-degenerate cuts, which complex64 and
    complex128 cut apart differently); a gap planted in a late step moves
    only the wide band, a NaN in an early step both."""
    cell = _eagle_small()
    with pinned(cell["config"]):
        vertices, edges, schedule, gen, results = _program_results(cell, [0])
        numbers = field_layer_banded.compare(
            cell["config"], vertices, edges, schedule, gen, results, [0],
            "cpu")
        assert numbers["edges_off_schedule"] == 0
        assert numbers["max_rel_dz_uncapped"] < 1e-4
        assert numbers["max_abs_dz"] < 1e-2
        late = {0: [z.copy() for z in results[0]]}
        late[0][3][0, 5] += 0.5
        moved = field_layer_banded.compare(
            cell["config"], vertices, edges, schedule, gen, late, [0], "cpu")
        assert moved["max_rel_dz_uncapped"] == \
            numbers["max_rel_dz_uncapped"]
        assert moved["max_abs_dz"] > 0.49
        early = {0: [z.copy() for z in results[0]]}
        early[0][1][0, 5] = np.nan
        spoilt = field_layer_banded.compare(
            cell["config"], vertices, edges, schedule, gen, early, [0], "cpu")
        assert spoilt["max_rel_dz_uncapped"] == spoilt["max_abs_dz"] == \
            float("inf")
        ok, _ = check.judge(spoilt, run.load_cell(CELL)["limits"])
        assert not ok


def test_the_control_fails_the_uncapped_band_where_the_program_passes():
    """The TF32 control put in the program's place reads far more in the
    first band than the program does (here at χ=4 over 2 uncapped steps)."""
    cell = _eagle_small(steps=2)
    config = cell["config"]
    with pinned(config):
        vertices, edges, schedule, gen, results = _program_results(cell, [0])
        prog = field_layer_banded.compare(config, vertices, edges, schedule,
                                          gen, results, [0], "cpu")
        lat = Lattice(vertices, edges)
        stated = lattices.colouring(config, edges)
        ctl = check.reference_for(config, lat, "cpu", tf32=True)
        z_ctl = {0: check.trajectory(ctl, config, lat, stated,
                                     gen.experiment(0), 2, "cpu")}
        control = field_layer_banded.compare(config, vertices, edges, stated,
                                             gen, z_ctl, [0], "cpu")
    assert control["max_rel_dz_uncapped"] > 10 * prog["max_rel_dz_uncapped"]


def test_the_relative_gap_divides_by_how_far_z_moved_and_floors_it():
    ref = [np.array([[1.0, 0.9, 0.5]]), np.array([[0.8, 1.0, 0.6]])]
    z = [r + np.array([[0.0, 1e-4, 0.0]]) for r in ref]
    # moved at most 0.5 from 1
    assert relative_gap(z, ref) == pytest.approx(1e-4 / 0.5)
    still = [np.ones((1, 3)), np.ones((1, 3)) - 1e-6]
    assert relative_gap([s + 1e-7 for s in still], still) == pytest.approx(
        1e-7 / FLOOR)
    # members apart: the worse member's own ratio
    two = [np.array([[0.5, 1.0], [1.0, 0.999]])]
    assert relative_gap([two[0] + np.array([[1e-3, 0], [0, 1e-4]])],
                        two) == pytest.approx(1e-4 / 1e-3)
    assert relative_gap([np.array([[np.nan, 1.0]])],
                        [np.array([[1.0, 1.0]])]) == float("inf")


def _record(spans):
    return run.Record(10, spans, {}, None, None)


def test_k3_roofline_reads_degree_three_messages_only():
    read = run.metric_reader("k3_roofline")
    assert read(_record({})) is None
    # a 5×5 grid's degree-4 messages are not K3's
    assert read(_record({"bp_message": [(4.0, ((25, 10, 10, 10, 10, 2),
                                                8))]})) is None
    rec = _record({"bp_message": [(4.0, ((127, 64, 64, 64, 2), 8)),
                                  (3.0, ((127, 64, 64, 64, 2), 8)),
                                  (9.0, ((25, 10, 10, 10, 10, 2), 8))]})
    least = 2 * 8 * 8 * 127 * 64**4 * 2 / 495e12
    assert read(rec) == pytest.approx(100 * least / 7e-3)


def test_eigh256_roofline_reads_the_order_256_batches_only():
    read = run.metric_reader("eigh256_roofline")
    assert read(_record({"eigh": [(1.0, (64, 200, 8))]})) is None
    rec = _record({"eigh": [(8.0, (256, 50, 8)), (2.0, (64, 200, 8)),
                            (10.0, (256, 48, 8))],
                   "roots": [(5.0, (64, 200, 8))]})
    least = 36 * (50 + 48) * 256**3 / 495e12
    assert read(rec) == pytest.approx(100 * least / 18e-3)


def test_the_fallback_share_reads_the_program_counters_or_nothing():
    read = run.metric_reader("qr_fallback_share")
    assert read(_record({})) is None
    rec = _record({})
    rec.program = {"host": {"steps": 4, "spans": {}, "counters": {
        "qr.chol_factors": 800, "qr.chol_shifted": 12}}, "device": None}
    assert read(rec) == pytest.approx(0.015)
    rec.program["host"]["counters"]["qr.chol_factors"] = 0
    assert read(rec) is None
