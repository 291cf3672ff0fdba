"""The harness finds every cell, configuration, mix, limit and metric by
name, prints the contract's last line, refuses to run without a card, and
loads nothing of JAX."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.helpers import run_small, small_cell

ROOT = Path(run.__file__).resolve().parent
CHECKOUT = ROOT.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = run.load_cell(name)
    assert cell["config"]["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell["mix"]["members"] >= 1 and cell["mix"]["steps"] >= 1
    assert set(cell["end_to_end"]) >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for metric in cell["per_layer"]:
        assert callable(run.metric_reader(metric))
    assert cell["limits"]["max_abs_dz"]["limit"] > 0


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert json.loads((CHECKOUT / c["file"]).read_text())["name"] == c["name"]
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends and m["better"] in ("lower", "higher")
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "limits" / f"{w['name']}.json").is_file()


def test_last_line_keys_and_the_check_comes_last():
    result, info = run_small(small_cell("grid5x5_chi10.quench"))
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"steps_per_s", "step_ms_p95",
                                      "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] is True, result["check"]
    assert info["experiments_checked"] and not info["leftover_modules"]
    json.dumps(result)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == "" or not out.stdout.strip().splitlines()[
        -1].startswith("{")
    assert "CUDA" in out.stderr


def test_the_control_tool_without_a_card_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload", CELLS[0],
         "--seeds", "5"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "tensornetworkquantumsimulator_tpu"}
    for path in ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & forbidden, path


def test_the_reference_imports_nothing_of_the_package():
    for path in (ROOT / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "concurrent", "numpy", "torch"}, (
            path, tops)


def test_a_run_loads_no_module_of_jax():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench.tests.helpers import run_small, small_cell;"
        "from portbench.run import forbidden_modules;"
        "r, i = run_small(small_cell('grid5x5_chi10.quench', steps=2), 0.3);"
        "print(forbidden_modules(), i['leftover_modules'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] []"
