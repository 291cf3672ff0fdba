"""The field layer, checked in two bands of steps.

The same program as ``field_layer`` (its ``Program`` is this module's), for
configurations whose bond cap binds partway through an experiment.  Before
the cap binds (the configuration's ``uncapped_steps``) the program and the
complex128 reference do the same arithmetic up to rounding, and their ⟨Z⟩
gap measures the program's precision.  Once it binds, each keeps the χ
largest values of cuts whose smaller values lie close together, and
complex64 and complex128 may keep different ones: the later steps' gap
measures that sensitivity as much as precision.  So three numbers are
compared:

- ``edges_off_schedule``: as in ``check.compare``, limit 0;
- ``max_rel_dz_uncapped``: over the first ``uncapped_steps`` steps of every
  sampled experiment and member, the widest ⟨Z⟩ gap over how far the
  reference's ⟨Z⟩ moved from |0…0⟩'s 1 (at least :data:`FLOOR`): the band
  that tells the program from a lower-precision one.  Rounding moves ⟨Z⟩
  in proportion to how far the state has moved: at small θ_h a TF32
  control's gap is as small as the program's is elsewhere, while its ratio
  stays at ~3e-3 whatever θ_h;
- ``max_abs_dz``: the widest gap over every step, a looser band that
  catches a wrong truncation or split once the cap binds.

A non-finite ⟨Z⟩ reads as an infinite gap in both bands.
"""

from __future__ import annotations

import numpy as np

from .. import check, lattices
from ..reference import Lattice
from .field_layer import Program

__all__ = ["Program", "compare", "relative_gap"]

# ⟨Z⟩ excursions below this count as this: float32 holds ⟨Z⟩ near 1 to
# ~1.2e-7, so on an experiment that barely moves the program's ratio stays
# at ~1.2e-4, not 1.2e-7 over a vanishing excursion
FLOOR = 1e-3


def relative_gap(zs: list, z_ref: list) -> float:
    """max over members of (widest |Δ⟨Z⟩| over steps and sites) / max(widest
    |1 − ⟨Z⟩_ref|, FLOOR); ``zs``, ``z_ref``: [E, V] per step."""
    z = np.asarray(zs, np.float64)
    ref = np.asarray(z_ref, np.float64)
    d = np.abs(z - ref)
    gap = np.where(np.isfinite(d), d, np.inf).max(axis=(0, 2))
    moved = np.abs(1.0 - ref).max(axis=(0, 2))
    return float((gap / np.maximum(moved, FLOOR)).max())


def compare(config, vertices, edges, schedule, gen, results, picks, device):
    """The numbers compared, against the plain reference in the
    configuration's gate order."""
    lattice = Lattice(vertices, edges)
    stated = lattices.colouring(config, edges)
    lattice.check_schedule(stated)
    ref = check.reference_for(config, lattice, device)
    uncapped = int(config["uncapped_steps"])
    worst = worst_uncapped = 0.0
    for i in picks:
        zs = results[i]
        z_ref = check.trajectory(ref, config, lattice, stated,
                                 gen.experiment(i), len(zs), device)
        worst = max(worst, check.widest_gap(zs, z_ref))
        worst_uncapped = max(worst_uncapped,
                             relative_gap(zs[:uncapped], z_ref[:uncapped]))
    return {"edges_off_schedule": check.edges_off_schedule(schedule, stated),
            "max_rel_dz_uncapped": worst_uncapped, "max_abs_dz": worst}
