"""A run with the timed path broken underneath reads ``correct`` false:
a step that returns its state unchanged, half of an ensemble left out
with the mean of the rest in its place, an answer altered where it is
produced, and a colouring other than the configuration's.  (Every cell runs on one card, so no exchange between cards can
be left out.)"""

from __future__ import annotations

import pytest

from portbench.systems import field_layer as system
from portbench.tests.helpers import run_small, small_cell

SMALL = dict(dims=(3, 3), chi=4, steps=3)


def test_the_unbroken_run_is_correct():
    result, _ = run_small(small_cell("grid5x5_chi10.disorder32", **SMALL))
    assert result["correct"] is True, result["check"]


@pytest.mark.parametrize("name", ["grid5x5_chi10.quench",
                                  "grid5x5_chi10.disorder32"])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, name):
    monkeypatch.setattr(system.Program, "step",
                        lambda self, state, site, bond: state)
    result, _ = run_small(small_cell(name, **SMALL))
    assert result["correct"] is False, result["check"]


def test_half_the_ensemble_left_out(monkeypatch):
    readout = system.Program.readout

    def half(self, state):
        z = readout(self, state).clone()
        keep = z.shape[0] // 2
        z[keep:] = z[:keep].mean(0)
        return z

    monkeypatch.setattr(system.Program, "readout", half)
    result, _ = run_small(small_cell("grid5x5_chi10.disorder32", **SMALL))
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", ["grid5x5_chi10.quench",
                                  "grid5x5_chi10.disorder32"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, name):
    cell = small_cell(name, **SMALL)
    nudge = 3 * cell["limits"]["max_abs_dz"]["limit"]
    readout = system.Program.readout

    def altered(self, state):
        z = readout(self, state).clone()
        z[0, 0] += nudge
        return z

    monkeypatch.setattr(system.Program, "readout", altered)
    result, _ = run_small(cell)
    assert result["correct"] is False, result["check"]


def test_a_colouring_other_than_the_stated_one():
    """The program schedules a valid colouring, but not the circuit the
    configuration states (its groups in another order)."""
    cell = small_cell("grid5x5_chi10.quench", **SMALL)
    cell["config"]["colour_groups"] = cell["config"]["colour_groups"][::-1]
    result, _ = run_small(cell)
    assert result["correct"] is False, result["check"]
    assert result["check"]["edges_off_schedule"]["value"] > 0
