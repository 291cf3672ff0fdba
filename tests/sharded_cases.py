"""Shared inputs of the port's sharded-engine tests
(``tests/test_torch_sharding*.py``).

The JAX side runs on the 8 virtual CPU devices that ``tests/conftest.py``
asks XLA for; the port's side on a ``ShardMesh`` of S ``cpu`` devices in
one process.  A case is one strip-ordered (or block-ordered) spec of both
packages, with the same numpy state handed to each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

from measure_states import random_peps

COLLECTIVES = ("all-gather", "collective-permute", "all-reduce",
               "all-to-all", "reduce-scatter")


def hlo_counts(compiled_text: str) -> dict:
    """Occurrences of each collective in optimized HLO text (as
    ``tests/test_sharded_smoke.py`` reads them)."""
    return {op: compiled_text.count(op + "(") for op in COLLECTIVES}


def j_mesh(shape, names=("v",)):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def j_sharded(tensors, messages, mesh, spec=P("v")):
    sh = NamedSharding(mesh, spec)
    return jp.BatchedState(jax.device_put(jnp.asarray(tensors), sh),
                           jax.device_put(jnp.asarray(messages), sh))


def lattices(name):
    """The same lattice in both packages."""
    make = {
        "grid4x4": lambda lat: lat.named_grid((4, 4)),
        "grid4x3": lambda lat: lat.named_grid((4, 3)),
        "grid6x4": lambda lat: lat.named_grid((6, 4)),
        "heavyhex": lambda lat: lat.heavy_hexagonal_lattice(1, 2),
    }[name]
    return make(j_lat), make(tt)


def same_spec(a, b) -> bool:
    """The two packages' compiled specs agree field by field (the colour
    groups bucket by bucket)."""
    groups = [[[(x.slot_u, x.slot_v, x.u_idx, x.v_idx) for x in grp]
               for grp in spec.color_groups] for spec in (a, b)]
    return (a.vertices == b.vertices and a.edges == b.edges
            and a.nbr == b.nbr and a.nbr_slot == b.nbr_slot
            and a.slot_mask == b.slot_mask and groups[0] == groups[1])


def strip_case(name, S, chi, seed=0, dtype=np.complex128, converge=True):
    """(JAX sspec, port sspec, tensors, messages): a random state on the
    strip-ordered spec of both packages; with ``converge`` its messages are
    JAX's BP fixed point (tolerance 1e-14), else identities."""
    jg, tg = lattices(name)
    jss, tss = jp.shard_spec(jg, S), tp.shard_spec(tg, S)
    assert same_spec(jss.spec, tss.spec)
    spec = tss.spec
    t = random_peps(spec, chi, seed=seed)
    V, D = spec.num_vertices, spec.degree
    state = jp.BatchedState(jnp.asarray(t),
                            jp.identity_messages(V, D, chi, np.complex128))
    if converge:
        state = jp.bp_update(jss.spec, state, maxiter=500, tolerance=1e-14)
    return (jss, tss, t.astype(dtype),
            np.asarray(state.messages).astype(dtype))


def cpu_mesh(shape, names=("v",)):
    """A port mesh of ``cpu`` shards, named explicitly (module-scoped
    fixtures run before the per-test CPU default is set)."""
    n = int(np.prod(shape))
    return tp.ShardMesh(shape, names, devices=["cpu"] * n)


def port_sharded(mesh, tensors, messages):
    return mesh.shard(tp.state_from_numpy(tensors, messages, device="cpu"))


def to_np(x) -> np.ndarray:
    if isinstance(x, (list, tuple)):
        return np.concatenate([to_np(y) for y in x])
    return x.detach().cpu().resolve_conj().numpy()


def gates(dtype=np.complex128):
    from tensornetworkquantumsimulator_tpu.models.gates import gate_matrix

    gate2 = np.asarray(gate_matrix("Rzz", 0.35)).reshape(2, 2, 2, 2)
    gate1 = np.asarray(gate_matrix("Rx", 0.8))
    return gate2.astype(dtype), gate1.astype(dtype)


class DrawsByGenerator:
    """Stands in for a sampler's draw hook when each shard draws with its
    own ``torch.Generator``: each generator gets its own block of forced
    bitstrings ``[n, calls]``, one column per call, in call order."""

    def __init__(self, blocks: dict):
        self.blocks = {id(g): torch.as_tensor(np.array(b), dtype=torch.long)
                       for g, b in blocks.items()}
        self.calls = {k: 0 for k in self.blocks}

    def __call__(self, probs, generator=None):
        k = id(generator)
        out = self.blocks[k][:, self.calls[k]]
        self.calls[k] += 1
        return out.to(probs.device)
