"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``), the limits of its check (``limits/<cell>.json``)
and its metrics (``metrics/<name>.py``); nothing here names a cell.

A run re-executes itself under the configuration's ``PYTHONHASHSEED`` and
knobs before it imports the package (its edge colouring follows string
hashing), prints the colour groups, builds the state and the layer on the
card, warms up the cell's own shapes with two steps, then runs the mix's
experiments in a closed loop for ``--seconds``: a step is one Trotter
layer of every member followed by all-site ⟨Z⟩ read to the host.  With
``--trace 0`` it reports the end-to-end metrics, with ``--trace 1`` the
per-layer ones (spans over the window, then short profiled sub-windows).
Then the reference checks a sample of the window's experiments
(``check.py``).  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  Without a CUDA card it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
T0_ENV = "PORTBENCH_T0"
FORBIDDEN = {"jax", "jaxlib", "flax", "tensornetworkquantumsimulator_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_cell(name: str, benchmark: Path = CHECKOUT / "BENCHMARK.json"):
    from . import traffic

    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {benchmark.name}")
    cell = cells[name]

    def mine(metrics):
        return [m["name"] for m in metrics if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": int(cell["chips"]),
        "config": json.loads(
            (ROOT / "configs" / f"{cell['config']}.json").read_text()),
        "mix": traffic.load(cell["traffic"]),
        "limits": json.loads((ROOT / "limits" / f"{name}.json").read_text()),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }


def pinned_env(config: dict) -> dict:
    """The settings a run must start under: the hash seed, the knobs, one
    OpenMP thread (the host loop is one thread; a pool of spinning CPU
    threads only competes with it for the host's cores), and every kernel
    cache inside the checkout."""
    return {
        "PYTHONHASHSEED": str(config["python_hash_seed"]),
        **{k: str(v) for k, v in config["knobs"].items()},
        "OMP_NUM_THREADS": "1",
        "TORCH_EXTENSIONS_DIR": str(CHECKOUT / "build" / "torch_extensions"),
        "TRITON_CACHE_DIR": str(CHECKOUT / "build" / "triton_cache"),
    }


def card_facts(torch) -> dict:
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        facts["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        facts["power_limit"] = "not read"
    return facts


def metric_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Client:
    """The closed loop: one experiment at a time, each step timed from its
    start to its ⟨Z⟩ on the host."""

    def __init__(self, program, gen, spans=None):
        self.program, self.gen, self.spans = program, gen, spans
        self.index, self.k = -1, gen.steps
        self.results: dict = {}  # experiment → [⟨Z⟩ [E, V] per step]

    def step(self) -> float:
        import torch

        p = self.program
        if self.k >= self.gen.steps:
            self.index, self.k = self.index + 1, 0
            self.site, self.bond = p.angles(self.gen.experiment(self.index))
            self.state = p.state0
            self.results[self.index] = []
        t = time.perf_counter()
        with self._region("layer"):
            self.state = p.step(self.state, self.site, self.bond)
        with self._region("readout"):
            z = p.readout(self.state)
        z = z.cpu()
        dt = time.perf_counter() - t
        self.results[self.index].append(p.to_bench(z.to(torch.float64).numpy()))
        self.k += 1
        return dt

    def _region(self, name):
        return self.spans.region(name) if self.spans else \
            contextlib.nullcontext()

    def run(self, seconds=None, min_steps=1, max_steps=None) -> list:
        times = []
        t_end = time.perf_counter() + seconds
        while (len(times) < min_steps or time.perf_counter() < t_end) and (
                max_steps is None or len(times) < max_steps):
            times.append(self.step())
        return times

    def drop(self):
        self.state = self.site = self.bond = None


def tenths(times, window_s, members) -> list:
    """Member-steps per second in each tenth of the window (by the steps'
    cumulative times), to tell noise within a run from noise between
    runs."""
    import numpy as np

    ends = np.cumsum(times)
    edges = np.linspace(0, window_s, 11)
    counts = np.histogram(ends, bins=edges)[0]
    return [round(float(c) * members / (window_s / 10), 3) for c in counts]


class Record:
    """What the per-layer readers read."""

    def __init__(self, steps, spans, counts, profile, syncs):
        self.steps, self.spans, self.counts = steps, spans, counts
        self.profile, self.syncs = profile, syncs


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda") -> tuple[dict, dict]:
    """One run of ``cell``: (the result line, the numbers compared)."""
    import numpy as np
    import torch

    import tensornetworkquantumsimulator_torch as tq

    from . import check, lattices, systems, trace as tracing
    from .spans import Spans
    from .traffic import Generator

    setup_parts = {"imports": time.time() - t0}
    config, mix = cell["config"], cell["mix"]
    system = systems.load(config)
    dev = tq.select_device(device)
    on_card = dev.type == "cuda"
    vertices, edges = lattices.build(config["lattice"])
    spans = Spans() if trace else None
    with spans.installed() if trace else contextlib.nullcontext():
        program = system.Program(config, vertices, edges,
                                 int(mix["members"]), dev)
        print(f"[groups] {cell['name']}: edges per (slot pair) bucket, per "
              f"colour group: {program.bucket_sizes()}; PYTHONHASHSEED "
              f"{os.environ.get('PYTHONHASHSEED', 'unset')}", flush=True)
        if on_card:
            torch.cuda.synchronize()
        setup_parts["program"] = time.time() - t0 - setup_parts["imports"]
        gen = Generator(mix, config, len(vertices), len(edges), seed)
        warm = Client(program, gen)
        warm.run(0, min_steps=int(mix.get("warmup_steps", 2)))
        warm.drop()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.time() - t0
        setup_parts["warmup"] = setup_s - sum(setup_parts.values())

        client = Client(program, gen, spans)
        if spans:
            spans.enabled = True
        t_w = time.perf_counter()
        times = client.run(seconds)
        window_s = time.perf_counter() - t_w
        if spans:
            spans.enabled = False
        leftovers = forbidden_modules()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        facts = card_facts(torch) if on_card else {
            "platform": "cpu", "kind": "cpu", "count": 0}
        facts["memory_peak_bytes"] = int(peak)

        members = program.members
        steps = len(times)
        zs = [z for i in sorted(client.results) for z in client.results[i]]
        failed = int(sum(int((~np.isfinite(z)).any(axis=1).sum()) for z in zs))
        result = {"correct": False, "attempted": steps * members,
                  "failed": failed, "metrics": {}, "device": facts}
        if trace:
            record = Record(steps, spans.collect(), dict(spans.counts),
                            None, None)
            more = Client(program, gen, spans)
            # short sub-windows after the window: the device alone, the
            # host and device labelled, then the synchronizations
            record.profile = tracing.device_pass(
                lambda: len(more.run(0.5, min_steps=2, max_steps=50)))
            idle = tracing.labelled_pass(
                lambda: len(more.run(0.2, min_steps=1, max_steps=10)), spans)
            record.syncs = tracing.sync_pass(
                lambda: len(more.run(0.3, min_steps=2, max_steps=20)))
            more.drop()
            for name in cell["per_layer"]:
                value = metric_reader(name)(record)
                if value is not None:
                    result["metrics"][name] = {"value": float(value),
                                               "unit": cell["units"][name]}
            facts["busy_s"] = record.profile["busy_s"]
            facts["window_s"] = record.profile["window_s"]
            result["breakdown"] = {"device_ops": record.profile["top"],
                                   "idle_gaps": idle}
        else:
            values = {
                "steps_per_s": steps * members / window_s,
                "step_ms_p95": float(np.percentile(np.array(times) * 1e3, 95)),
                "setup_s": setup_s,
            }
            for name in cell["end_to_end"]:
                result["metrics"][name] = {"value": values[name],
                                           "unit": cell["units"][name]}
        client.drop()
        results = client.results
        schedule = program.schedule
        del warm, client, program
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    picks = check.pick(results, gen.steps, int(mix["check_experiments"]), seed)
    t_check = time.perf_counter()
    numbers = system.compare(config, vertices, edges, schedule, gen,
                             results, picks, dev)
    result["correct"], result["check"] = check.judge(numbers, cell["limits"],
                                                     failed)
    info = {"experiments_checked": picks, "steps_in_window": steps,
            "window_s": window_s, "check_s": time.perf_counter() - t_check,
            "setup_parts_s": setup_parts,
            "steps_per_s_by_tenth": tenths(times, window_s, members),
            "leftover_modules": leftovers}
    return result, info


def main(argv=None) -> int:
    t0 = float(os.environ.get(T0_ENV) or time.time())
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    want = pinned_env(cell["config"])
    if any(os.environ.get(k) != v for k, v in want.items()):
        if os.environ.get(T0_ENV):
            print("the re-executed run did not get its settings",
                  file=sys.stderr)
            return 2
        env = {**os.environ, **want, T0_ENV: repr(t0)}
        os.execve(sys.executable,
                  [sys.executable, "-m", "portbench.run", *argv], env)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t0)
    bad = sorted(set(info["leftover_modules"]) | set(forbidden_modules()))
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    print(f"[run] {json.dumps(info)}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
