"""The one generator of every traffic mix.

A mix (``traffic/<name>.json``) states the experiments a client runs in a
closed loop: how many members each folds (``members``), how many steps
each runs from |0…0⟩ (``steps``), and which of the configuration's
parameters it draws (``draw``):

- ``{"per": "experiment", "kind": "strata", "lo", "hi", "strata": k}``:
  one value for each of k equal strata of [lo, hi), drawn once from the
  seed; experiment i takes the stratum at position i mod k of an order the
  seed shuffles, so every seed runs the same strata, in another order and
  at other points inside them;
- ``{"per": "site" | "edge", "kind": "uniform", "lo", "hi"}``: one value
  per member and site (or edge), drawn anew for every experiment.

Parameters not drawn keep the configuration's ``params``.  Each rotation's
angle is the product of its factors (numbers or parameter names), so an
experiment becomes float32 site angles [E, S, V] and bond angles [E, B] in
the benchmark's vertex and edge order.  The same seed gives the same
experiments.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


@dataclasses.dataclass(frozen=True)
class Experiment:
    index: int
    site: np.ndarray  # [E, S, V] float32
    bond: np.ndarray  # [E, B] float32
    label: str  # the drawn per-experiment values, for the record


def _angle(factors, values: dict, shape) -> np.ndarray:
    out = np.ones(shape)
    for f in factors:
        out = out * (values[f] if isinstance(f, str) else float(f))
    return np.broadcast_to(out, shape)


class Generator:
    """Experiments of one mix on one configuration's lattice."""

    def __init__(self, mix: dict, config: dict, num_vertices: int,
                 num_edges: int, seed: int):
        self.mix, self.config = mix, config
        self.V, self.B, self.seed = num_vertices, num_edges, seed
        self.members, self.steps = int(mix["members"]), int(mix["steps"])
        rng = np.random.default_rng([seed, 0])
        self._strata = {}
        for d in mix["draw"]:
            if d["kind"] == "strata":
                k = int(d["strata"])
                width = (d["hi"] - d["lo"]) / k
                points = d["lo"] + (np.arange(k) + rng.random(k)) * width
                self._strata[d["param"]] = points[rng.permutation(k)]
            elif d["kind"] != "uniform":
                raise ValueError(f"unknown draw kind {d['kind']!r}")

    def experiment(self, i: int) -> Experiment:
        E, V, B = self.members, self.V, self.B
        values = {k: float(v) for k, v in self.config["params"].items()}
        label = {}
        rng = np.random.default_rng([self.seed, 1, i])
        for d in self.mix["draw"]:
            p = d["param"]
            if d["kind"] == "strata":
                pts = self._strata[p]
                values[p] = float(pts[i % len(pts)])
                label[p] = round(values[p], 6)
            else:
                n = V if d["per"] == "site" else B
                values[p] = rng.uniform(d["lo"], d["hi"], (E, n))
        per = {d["param"]: d["per"] for d in self.mix["draw"]}
        site_vals = {k: v for k, v in values.items() if per.get(k) != "edge"}
        edge_vals = {k: v for k, v in values.items() if per.get(k) != "site"}
        site = np.stack([_angle(f, site_vals, (E, V))
                         for _pauli, f in self.config["site_rotations"]], axis=1)
        bond = _angle(self.config["bond_rotation"][1], edge_vals, (E, B))
        return Experiment(i, site.astype(np.float32), bond.astype(np.float32),
                          json.dumps(label, sort_keys=True))

