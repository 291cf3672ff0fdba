"""Shared set-up of the benchmark's CPU tests: a cell of the benchmark cut
to a size a test run can hold, and one run of it on the CPU through the
harness's own code (the run's look for a card is the only part skipped)."""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from pathlib import Path

from portbench import run

SEED = 2**31 + 4321  # past 32 signed bits: a run's seed may be that large


@contextmanager
def pinned(config):
    """The configuration's knobs in the environment, restored after."""
    want = run.pinned_env(config)
    saved = {k: os.environ.get(k) for k in want}
    os.environ.update(want)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def files_cell(config: str, mix: str) -> dict:
    """A cell made of a configuration file and a mix file alone (for the
    files that no cell of ``BENCHMARK.json`` uses yet)."""
    from portbench import traffic

    root = Path(run.__file__).resolve().parent
    return {"name": f"{config}.{mix}", "chips": 1,
            "config": json.loads((root / "configs" / f"{config}.json")
                                 .read_text()),
            "mix": traffic.load(mix), "limits": {}, "end_to_end": [],
            "per_layer": [], "units": {}}


def package_colouring(vertices, edges) -> list:
    """The package's colour groups of a lattice in this process (under its
    own hash seed), as indices into ``edges``."""
    import tensornetworkquantumsimulator_torch as tq
    from tensornetworkquantumsimulator_torch import parallel as par

    g = tq.NamedGraph(vertices)
    for u, v in edges:
        g.add_edge_inplace(tq.NamedEdge(u, v))
    spec = par.compile_graph(g)
    names = list(spec.vertices)
    where = {frozenset(e): i for i, e in enumerate(edges)}
    return [[where[frozenset((names[u], names[v]))] for b in group
             for u, v in zip(b.u_idx, b.v_idx)]
            for group in spec.color_groups]


def small_cell(name, *, dims=(3, 3), chi=4, steps=3):
    """The cell ``name`` (or a cell dict) on a smaller lattice and bond
    dimension, with shorter experiments; everything else as stated.  Its
    colour groups are the package's in this process, whose hash seed is
    not the configuration's."""
    from portbench import lattices

    cell = run.load_cell(name) if isinstance(name, str) else name
    config = cell["config"]
    if config["lattice"]["kind"] == "grid":
        config["lattice"]["dims"] = list(dims)
    config["chi"] = chi
    config["colour_groups"] = package_colouring(
        *lattices.build(config["lattice"]))
    cell["mix"]["steps"] = steps
    return cell


def run_small(cell, seconds=1.0, seed=SEED):
    """One run of ``cell`` on the CPU: (result line, run info)."""
    from tensornetworkquantumsimulator_torch import set_default_device

    with pinned(cell["config"]):
        try:
            return run.run_cell(cell, seed, seconds, False, time.time(),
                                device="cpu")
        finally:
            set_default_device(None)
