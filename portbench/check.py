"""The comparison that decides ``correct``.

Once the window has closed, a sample of the experiments it completed,
drawn from the seed, is run again by the plain reference
(``reference/``) from the same angles and |0…0⟩, in the gate order that
the configuration states (its colour groups, checked to be a proper
colouring that covers every edge once).  Two numbers are compared:

- ``edges_off_schedule``: edges that the program's colour groups put in
  another group than the configuration's (or leave out, or repeat), limit
  0: the program has to run the stated circuit;
- ``max_abs_dz``: the widest gap, over every step of every sampled
  experiment, member and site, between the ⟨Z⟩ the timed path read to the
  host and the reference's.  A non-finite ⟨Z⟩ reads as an infinite gap.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import Lattice, Reference
from .reference.tns import pauli_rotation

ROOT_EPS = {"complex64": float(np.finfo(np.float32).eps),
            "complex128": float(np.finfo(np.float64).eps)}


def pick(results: dict, steps: int, count: int, seed: int) -> list:
    """``count`` experiments drawn from the seed among those the window
    completed (all ``steps`` steps); with none complete, the one that got
    furthest."""
    done = sorted(i for i, zs in results.items() if len(zs) == steps)
    if not done:
        return [max(results, key=lambda i: len(results[i]))] if results else []
    rng = np.random.default_rng([seed, 2])
    return sorted(int(i) for i in rng.choice(done, size=min(count, len(done)),
                                             replace=False))


def reference_for(config: dict, lattice: Lattice, device, tf32=False):
    return Reference(
        lattice, int(config["chi"]), cutoff=config["cutoff"],
        bp_maxiter=config["bp_maxiter"], bp_tolerance=config["bp_tolerance"],
        root_eps=ROOT_EPS[config["dtype"]],
        normalize=config["normalize_tensors"], device=device, tf32=tf32)


def gates(config: dict, lattice: Lattice, schedule, experiment, device):
    """(site gates [E, V, 2, 2], per group bond gates [E, n, 4, 4]) of an
    experiment, complex128, from its float32 angles."""
    cdt = torch.complex128
    site = torch.as_tensor(experiment.site, device=device).to(torch.float64)
    g = None
    for k, (pauli, _) in enumerate(config["site_rotations"]):
        r = pauli_rotation(pauli, site[:, k], cdt)
        g = r if g is None else r @ g
    bond = torch.as_tensor(experiment.bond, device=device).to(torch.float64)
    where = lattice.edge_index()
    pauli2 = config["bond_rotation"][0]
    per_group = [pauli_rotation(pauli2, bond[:, [where[frozenset(e)]
                                                 for e in group]], cdt)
                 for group in schedule]
    return g, per_group


def trajectory(ref: Reference, config, lattice, schedule, experiment, steps,
               device):
    """⟨Z⟩ [E, V] after each of ``steps`` steps, on the host."""
    g, bond = gates(config, lattice, schedule, experiment, device)
    T, M = ref.product_state(experiment.site.shape[0])
    out = []
    for _ in range(steps):
        T, M = ref.step(T, M, g, schedule, bond)
        out.append(ref.z(T, M).cpu().numpy())
    return out


def widest_gap(a: list, b: list) -> float:
    gaps = [np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
            for x, y in zip(a, b)]
    worst = max(float(np.max(np.where(np.isfinite(d), d, np.inf)))
                for d in gaps)
    return worst


def edges_off_schedule(schedule, stated) -> int:
    """Edges that ``schedule`` does not hold in their group of ``stated``
    (group k against group k, edges as sets of two names), plus edges that
    ``stated`` does not have."""
    want = {frozenset(e): k for k, group in enumerate(stated) for e in group}
    got: dict = {}
    for k, group in enumerate(schedule):
        for e in group:
            got.setdefault(frozenset(e), []).append(k)
    return (sum(got.get(e) != [k] for e, k in want.items())
            + sum(e not in want for e in got))


def compare(config, lattice, stated, schedule, gen, results, picks,
            device) -> dict:
    """The numbers compared: the program's colour groups ``schedule``
    against the configuration's ``stated`` ones, and the sampled
    experiments' ⟨Z⟩ against the reference's, which follows ``stated``."""
    lattice.check_schedule(stated)
    ref = reference_for(config, lattice, device)
    worst = 0.0
    for i in picks:
        zs = results[i]
        z_ref = trajectory(ref, config, lattice, stated, gen.experiment(i),
                           len(zs), device)
        worst = max(worst, widest_gap(zs, z_ref))
    return {"edges_off_schedule": edges_off_schedule(schedule, stated),
            "max_abs_dz": worst}


def judge(numbers: dict, limits: dict, failed: int = 0) -> tuple[bool, dict]:
    """(``correct``, each number beside its limit): correct when no answer
    failed and no number is over its limit."""
    compared = {k: {"value": v, "limit": limits[k]["limit"]}
                for k, v in numbers.items()}
    ok = failed == 0 and all(c["value"] <= c["limit"]
                             for c in compared.values())
    return bool(ok), compared
