"""Readings behind a cell's limits, many seeds in one process, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 ... [--pool N] [--control-seeds K]

For each seed, the experiments a run of the cell would check (drawn as
``check.pick`` draws them from the first ``--pool`` experiments, the count
a window completes) are run through the timed path's entry (the package's
layer and readout, as ``run.py`` drives them, untimed) and judged as a
run judges them (``check.compare`` against the complex128 reference, then
``check.judge`` against the cell's limits): the lower readings.  On the
first ``--control-seeds`` seeds the same experiments also run through the
control, the reference with every contraction at TF32, put in the
program's place and judged the same way: the upper readings, and a
``correct`` that has to come out false.  One JSON line per seed, with the
card it ran on; without a CUDA card it exits 3 and prints nothing.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    from .run import card_facts, load_cell, pinned_env

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pool", type=int, default=8)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    want = pinned_env(cell["config"])
    if any(os.environ.get(k) != v for k, v in want.items()):
        os.execve(sys.executable,
                  [sys.executable, "-m", "portbench.control", *argv],
                  {**os.environ, **want})
    import torch

    if not torch.cuda.is_available():
        print("the control's readings are taken on a CUDA card; "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    facts = card_facts(torch)
    for line in readings(cell, args.seeds, args.pool, args.control_seeds,
                         "cuda"):
        line["device"] = facts
        print(json.dumps(line), flush=True)
    return 0


def readings(cell, seeds, pool, control_seeds, device):
    """One dict per seed: the program's numbers and ``correct``, and on the
    first ``control_seeds`` seeds the control's."""
    import tensornetworkquantumsimulator_torch as tq

    from . import check, lattices, systems
    from .reference import Lattice
    from .run import Client
    from .traffic import Generator

    config, mix = cell["config"], cell["mix"]
    dev = tq.select_device(device)
    vertices, edges = lattices.build(config["lattice"])
    lattice = Lattice(vertices, edges)
    stated = lattices.colouring(config, edges)
    system = systems.load(config)
    program = system.Program(config, vertices, edges, int(mix["members"]),
                             dev)
    ctl = check.reference_for(config, lattice, dev, tf32=True)
    for n, seed in enumerate(seeds):
        gen = Generator(mix, config, len(vertices), len(edges), seed)
        fake = {i: [None] * gen.steps for i in range(pool)}
        picks = check.pick(fake, gen.steps, int(mix["check_experiments"]),
                           seed)
        t0 = time.perf_counter()
        z_prog, z_ctl = {}, {}
        for i in picks:
            client = Client(program, gen)
            client.index = i - 1
            for _ in range(gen.steps):
                client.step()
            z_prog[i] = client.results[i]
            client.drop()
            if n < control_seeds:
                z_ctl[i] = check.trajectory(ctl, config, lattice, stated,
                                            gen.experiment(i), gen.steps, dev)
        line = {"seed": seed, "experiments": picks}
        for side, results, schedule in (("program", z_prog, program.schedule),
                                        ("control", z_ctl, stated)):
            if results:
                numbers = system.compare(config, vertices, edges, schedule,
                                         gen, results, picks, dev)
                line[f"{side}_correct"], line[side] = check.judge(
                    numbers, cell["limits"])
        line["seconds"] = time.perf_counter() - t0
        yield line


if __name__ == "__main__":
    sys.exit(main())
