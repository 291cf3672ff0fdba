"""The field layer, built from a configuration.

Everything here goes through the package's public entry points:
``batched_product_state`` → ``make_field_layer_fn`` (one Trotter step:
a composed rotation per site, then per colour group a BP refresh and the
simple update of its edges, then a final refresh), ``ensemble_fn`` for a
folded ensemble, and ``local_expectations`` /
``make_ensemble_expectation_fn`` for all-site ⟨Z⟩.  The benchmark hands
the package its own lattice (vertex names and edges) and its own angles;
it reads back ⟨Z⟩ and the colour groups the package scheduled, which the
check holds to the configuration's own (``lattices.colouring``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import check, lattices
from ..reference import Lattice


class Program:
    """One configuration's layer, initial state and readout on ``device``,
    for experiments of ``members`` folded members."""

    def __init__(self, config: dict, vertices, edges, members: int, device):
        import tensornetworkquantumsimulator_torch as tq
        from tensornetworkquantumsimulator_torch import parallel as par

        g = tq.NamedGraph(vertices)
        for u, v in edges:
            g.add_edge_inplace(tq.NamedEdge(u, v))
        chi = int(config["chi"])
        dtype = getattr(torch, config["dtype"])
        self.members, self.device = members, torch.device(device)
        self.spec, state0 = par.batched_product_state(
            g, chi=chi, dtype=dtype, device=self.device)
        _, self.layer = par.make_field_layer_fn(
            g, chi, site_pauli=tuple(p for p, _ in config["site_rotations"]),
            bond_pauli=config["bond_rotation"][0], cutoff=config["cutoff"],
            normalize_tensors=config["normalize_tensors"],
            bp_maxiter=config["bp_maxiter"],
            bp_tolerance=config["bp_tolerance"], spec=self.spec,
            device=self.device)
        z = tq.op_matrix("Z", 2)
        spec = self.spec
        names = list(spec.vertices)
        # program position of each benchmark vertex, and back
        self.prog_of_bench = np.array([spec.vertex_position(v)
                                       for v in vertices])
        self.bench_of_prog = np.argsort(self.prog_of_bench)
        edge_pos = {frozenset(e): i for i, e in enumerate(edges)}
        self.bench_edge_of_prog = np.array(
            [edge_pos[frozenset((names[iu], names[iv]))]
             for iu, iv, _su, _sv in spec.edges])
        self.schedule = [
            [(names[u], names[v]) for b in group
             for u, v in zip(b.u_idx, b.v_idx)]
            for group in spec.color_groups]
        if members == 1:
            self.state0 = state0
            self._run = self.layer
            self._z = lambda st: par.local_expectations(spec, st, z).real
        else:
            self.state0 = par.stack_states([state0] * members)
            self._run = par.ensemble_fn(self.layer)
            self._z = par.make_ensemble_expectation_fn(spec, z,
                                                       real_output=True)

    def bucket_sizes(self):
        """Edges per (slot pair) bucket, per colour group."""
        return [[len(b.u_idx) for b in group]
                for group in self.spec.color_groups]

    def angles(self, experiment):
        """An experiment's angles on the device, in the program's vertex and
        edge order: site [E, S, V], bond [E, B] (E dropped for one member)."""
        site = experiment.site[..., self.bench_of_prog]
        bond = experiment.bond[..., self.bench_edge_of_prog]
        if self.members == 1:
            site, bond = site[0], bond[0]
        return (torch.as_tensor(np.ascontiguousarray(site), device=self.device),
                torch.as_tensor(np.ascontiguousarray(bond), device=self.device))

    def step(self, state, site, bond):
        return self._run(state, site, bond)[0]

    def readout(self, state):
        """⟨Z⟩ on the device, [E, V] (program order)."""
        z = self._z(state)
        return z.reshape(self.members, -1)

    def to_bench(self, z_host: np.ndarray) -> np.ndarray:
        """A host copy of :meth:`readout` in the benchmark's vertex order."""
        return z_host[:, self.prog_of_bench]


def compare(config, vertices, edges, schedule, gen, results, picks, device):
    """The numbers compared: ``check.compare`` with the plain reference, in
    the configuration's gate order."""
    return check.compare(config, Lattice(vertices, edges),
                         lattices.colouring(config, edges), schedule, gen,
                         results, picks, device)
