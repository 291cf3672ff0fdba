"""The plain reference against the package on small lattices on the CPU,
and the TF32 control, put in the program's place, failing the limits."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import check, lattices, traffic
from portbench.reference import Lattice, tf32_round
from portbench.run import Client, load_cell
from portbench.systems.field_layer import Program
from portbench.tests.helpers import SEED, files_cell, pinned, small_cell


@pytest.fixture(autouse=True)
def cpu_default():
    from tensornetworkquantumsimulator_torch import set_default_device

    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _gaps(cell, experiments=(0, 1), control=False):
    """(program vs reference, control vs reference): widest ⟨Z⟩ gaps."""
    config, mix = cell["config"], cell["mix"]
    with pinned(config):
        vertices, edges = lattices.build(config["lattice"])
        lat = Lattice(vertices, edges)
        stated = lattices.colouring(config, edges)
        program = Program(config, vertices, edges, mix["members"], "cpu")
        assert check.edges_off_schedule(program.schedule, stated) == 0
        gen = traffic.Generator(mix, config, len(vertices), len(edges), SEED)
        ref = check.reference_for(config, lat, "cpu")
        ctl = check.reference_for(config, lat, "cpu", tf32=True)
        prog_gap = ctl_gap = 0.0
        for i in experiments:
            client = Client(program, gen)
            client.index = i - 1
            for _ in range(gen.steps):
                client.step()
            ex = gen.experiment(i)
            z_ref = check.trajectory(ref, config, lat, stated, ex, gen.steps,
                                     "cpu")
            prog_gap = max(prog_gap, check.widest_gap(client.results[i], z_ref))
            if control:
                z_ctl = check.trajectory(ctl, config, lat, stated, ex,
                                         gen.steps, "cpu")
                ctl_gap = max(ctl_gap, check.widest_gap(z_ctl, z_ref))
        return prog_gap, ctl_gap


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 3.0], dtype=torch.float64)
    assert tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]
    z = torch.complex(x, -x)
    assert torch.equal(tf32_round(z).imag, -tf32_round(x))


@pytest.mark.parametrize("name", ["grid5x5_chi10.quench",
                                  "grid5x5_chi10.disorder32"])
def test_the_reference_follows_the_package_in_complex64(name):
    cell = small_cell(name, dims=(3, 3), chi=4, steps=4)
    cell["mix"]["members"] = min(cell["mix"]["members"], 4)
    prog, ctl = _gaps(cell, experiments=(0,), control=True)
    assert prog < 2e-5, prog
    # the control, in the program's place, fails the cell's own limit
    assert ctl > load_cell(name)["limits"]["max_abs_dz"]["limit"], ctl


@pytest.mark.parametrize("name", ["grid5x5_chi10.quench",
                                  "grid5x5_chi10.disorder32"])
def test_the_control_tool_judges_program_and_control_as_a_run_does(name):
    """``portbench.control`` puts the control in the program's place and
    judges both with the cell's limits: the program correct, the control
    not."""
    from portbench import control

    cell = small_cell(name, dims=(3, 3), chi=4, steps=4)
    cell["mix"]["members"] = min(cell["mix"]["members"], 4)
    cell["mix"]["check_experiments"] = 1
    with pinned(cell["config"]):
        (line,) = control.readings(cell, [SEED], pool=2, control_seeds=1,
                                   device="cpu")
    assert line["program_correct"] is True, line
    assert line["control_correct"] is False, line
    assert line["control"]["edges_off_schedule"]["value"] == 0
    assert line["control"]["max_abs_dz"]["value"] > \
        line["control"]["max_abs_dz"]["limit"]


def test_the_reference_follows_the_package_on_heavy_hex():
    """The Eagle lattice (degree 3, missing bonds) at a small bond
    dimension: its configuration waits for the program's repair (PERF.md)."""
    cell = small_cell(files_cell("eagle127_kicked_ising_chi64",
                                 "theta_h_sweep"), chi=3, steps=2)
    prog, ctl = _gaps(cell, experiments=(0,), control=True)
    assert prog < 2e-5 and ctl > 10 * prog, (prog, ctl)


def test_the_reference_agrees_with_the_package_in_complex128():
    cell = small_cell("grid5x5_chi10.quench", dims=(3, 3), chi=4, steps=4)
    cell["config"]["dtype"] = "complex128"
    prog, _ = _gaps(cell)
    # the package builds the gates of float32 angles in complex64 (its
    # dtype rule), which leaves ~1e-7 in each gate
    assert prog < 1e-6, prog


def test_the_schedule_check_refuses_a_wrong_colouring():
    vertices, edges = lattices.grid((2, 2))
    lat = Lattice(vertices, edges)
    lat.check_schedule([[edges[0], edges[2]], [edges[1], edges[3]]])
    with pytest.raises(ValueError):  # two edges at (2, 1)
        lat.check_schedule([[edges[0], edges[3]], [edges[1], edges[2]]])
    with pytest.raises(ValueError):  # an edge left out
        lat.check_schedule([[edges[0], edges[2]], [edges[1]]])


def test_edges_off_schedule_counts_each_misplaced_edge():
    vertices, edges = lattices.grid((2, 2))
    stated = [[edges[0], edges[2]], [edges[1], edges[3]]]
    assert check.edges_off_schedule(stated, stated) == 0
    # the same colouring with its edges named the other way round
    assert check.edges_off_schedule(
        [[e[::-1] for e in g] for g in stated], stated) == 0
    # the groups in the other order: a different circuit
    assert check.edges_off_schedule(stated[::-1], stated) == 4
    assert check.edges_off_schedule([stated[0]], stated) == 2
    assert check.edges_off_schedule([stated[0], stated[1] + [edges[0]]],
                                    stated) == 1


@pytest.mark.parametrize("config", ["grid5x5_tfim_chi10",
                                    "eagle127_kicked_ising_chi64"])
def test_the_stated_colouring_is_the_package_s_at_the_pinned_hash_seed(
        config):
    """The configuration's colour groups are the ones the package's
    edge_color gives users under the configuration's hash seed: checked in
    a fresh interpreter started under it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    stated = json.loads((Path(lattices.__file__).parent / "configs"
                         / f"{config}.json").read_text())
    code = ("import json, sys; from portbench import lattices; "
            "from portbench.tests.helpers import package_colouring; "
            "spec = json.loads(sys.argv[1]); "
            "print(json.dumps(package_colouring(*lattices.build(spec))))")
    root = Path(lattices.__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONHASHSEED": str(stated["python_hash_seed"]),
           "PYTHONPATH": os.pathsep.join(
               [str(root), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code,
                          json.dumps(stated["lattice"])],
                         capture_output=True, text=True, env=env, cwd=root,
                         check=True, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert [sorted(g) for g in got] == [sorted(g)
                                        for g in stated["colour_groups"]]


def test_lattices_equal_the_package_constructors():
    import tensornetworkquantumsimulator_torch as tq

    for ours, theirs in ((lattices.grid((5, 5)), tq.named_grid((5, 5))),
                         (lattices.ibm_eagle(), tq.ibm_eagle_lattice())):
        vertices, edges = ours
        assert vertices == list(theirs.vertices())
        assert {frozenset(e) for e in edges} == {
            frozenset((e.src, e.dst)) for e in theirs.edges()}
    v, e = lattices.ibm_eagle()
    assert len(v) == 127 and len(e) == 144
