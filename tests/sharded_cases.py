"""Shared inputs of the port's sharded-engine tests
(``tests/test_torch_sharding*.py``).

The JAX side runs on the 8 virtual CPU devices that ``tests/conftest.py``
asks XLA for; the port's side on a ``ShardMesh`` of S ``cpu`` devices in
one process.  A case is one strip-ordered (or block-ordered) spec of both
packages, with the same numpy state handed to each.
"""

import os

if __name__ == "__main__":  # run alone: conftest.py's CPU devices, set
    # before JAX starts
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_ENABLE_X64"] = "1"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

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


# ---------------------------------------------------------------------------
# Readings behind the complex64 bars of test_layer_matches_jax_complex64 and
# test_truncate_complex64_fast_stack_within_band, one hash seed a process:
#   for s in $(seq 0 63); do
#     PYTHONHASHSEED=$s PYTHONPATH=. python tests/sharded_cases.py; done
# (arguments: any of "layer", "stops", "truncate"; default the first and last)
# ---------------------------------------------------------------------------

_S, _CHI = 4, 3
_Z = np.diag([1.0, -1.0]).astype(np.complex128)
F32_EPS = float(np.finfo(np.float32).eps)


def layer_z(case, dtype, tolerance, port):
    """Site ⟨Z⟩ and truncation errors after the strip layer of the
    complex64 test (10 BP sweeps at most per refresh) in one package."""
    jss, tss, t, m = case
    gate2, gate1 = gates(dtype)
    kw = dict(cutoff=1e-12, bp_maxiter=10, bp_tolerance=tolerance)
    if port:
        from tensornetworkquantumsimulator_torch.parallel import sharded_layer

        mesh = tp.ShardMesh(_S, devices=["cpu"] * _S)
        out, errs = tp.make_sharded_layer(tss, mesh, gate2, gate1, _CHI, **kw)(
            port_sharded(mesh, t.astype(dtype), m.astype(dtype)))
        z = sharded_layer.make_sharded_site_expectations(tss, mesh, _Z)(out)
        return to_np(z), to_np(errs)
    jmesh = j_mesh((_S,))
    out, errs = jp.make_sharded_layer(jss, jmesh, gate2, gate1, _CHI, **kw)(
        j_sharded(t.astype(dtype), m.astype(dtype), jmesh))
    return np.asarray(jp.local_expectations(jss.spec, out, _Z)), np.asarray(errs)


def layer_readings() -> dict:
    """Max site |Δ⟨Z⟩| between the complex64 layers (port ``t64``, JAX
    ``j64``) and JAX's complex128 one, at tolerance 0 (``t0``) and with every
    refresh at 10 sweeps (``pin``, tolerance −1), from identity messages
    (``fresh``) and from the BP fixed point (``conv``); ``band``: JAX's
    complex128 layer at tolerance ε32 against tolerance 0."""
    d = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    out = {}
    for name, conv in (("fresh", False), ("conv", True)):
        case = strip_case("grid4x4", _S, _CHI, seed=11, converge=conv)
        out["groups"] = [sum(len(b.u_idx) for b in g)
                         for g in case[1].spec.color_groups]
        z128 = layer_z(case, np.complex128, 0.0, False)[0]
        out[f"{name}_band"] = d(layer_z(case, np.complex128, F32_EPS,
                                        False)[0], z128)
        for tol, tag in ((0.0, "t0"), (-1.0, "pin")):
            zj, ej = layer_z(case, np.complex64, tol, False)
            zt, et = layer_z(case, np.complex64, tol, True)
            out[f"{name}_{tag}"] = dict(t64_j64=d(zt, zj), t64_j128=d(zt, z128),
                                        j64_j128=d(zj, z128), errs=d(et, ej))
    return out


def stop_sweeps() -> dict:
    """The unsharded port layer in the test's group order: ⟨Z⟩ of its
    complex64 run against its complex128 run after each stage (``dz``), and
    at which sweep each package's complex64 refresh stops at tolerance 0 on
    the same input (the complex128 state before the refresh, cast down)."""
    from tensornetworkquantumsimulator_tpu.parallel import engine as je

    jss, tss, t, m = strip_case("grid4x4", _S, _CHI, seed=11, converge=False)
    spec, zt = tss.spec, torch.as_tensor(_Z)

    def run(dtype):
        gate2, gate1 = (torch.as_tensor(g) for g in gates(dtype))
        st = tp.apply_one_site(tp.state_from_numpy(
            t.astype(dtype), m.astype(dtype), device="cpu"), gate1)
        stages = []
        for grp in spec.color_groups:
            stages.append(st)
            st = tp.bp_update(spec, st, maxiter=10, tolerance=0.0)
            stages.append(st)
            st, _ = tp.apply_color_group(st, grp, gate2, _CHI, 1e-12)
        stages.append(st)
        return stages + [tp.bp_update(spec, st, maxiter=10, tolerance=0.0)]

    def z(st):
        return tp.local_expectations(spec, st, zt.to(st.tensors.dtype)
                                     ).real.double().numpy()

    s128, s64 = run(np.complex128), run(np.complex64)
    dz = [float(np.abs(z(a) - z(b)).max()) for a, b in zip(s64, s128)]
    sweeps = []
    for st in s128[2::2]:  # the input of every refresh after the first
        tt_, mm = (x.to(torch.complex64) for x in (st.tensors, st.messages))
        tst = st._replace(tensors=tt_, messages=mm)
        jst = je.BatchedState(jnp.asarray(tt_.numpy()), jnp.asarray(mm.numpy()))
        ref_t = tp.bp_update(spec, tst, maxiter=10, tolerance=0.0).messages
        ref_j = np.asarray(je.bp_update(jss.spec, jst, maxiter=10,
                                        tolerance=0.0).messages)
        port = next(k for k in range(1, 11) if torch.equal(
            tp.bp_update(spec, tst, maxiter=k, tolerance=-1.0).messages, ref_t))
        jax_ = next(k for k in range(1, 11) if np.array_equal(np.asarray(
            je.bp_update(jss.spec, jst, maxiter=k, tolerance=-1.0).messages),
            ref_j))
        # how far complex128 moves ⟨Z⟩ between the port's stop and 10 sweeps
        moved = float(np.abs(z(tp.bp_update(spec, st, maxiter=port,
                                            tolerance=-1.0))
                             - z(tp.bp_update(spec, st, maxiter=10,
                                              tolerance=0.0))).max())
        sweeps.append(dict(jax=jax_, port=port, c128_moved=moved))
    return dict(dz_after_stage=dz, stops=sweeps)


def truncate_readings() -> dict:
    """The complex64 truncate test's readings: the port's complex64
    ``batched_truncate`` (100 sweeps at most) against JAX's complex128 one,
    default and fast stacks, tolerance 0 and −1; ``band``: JAX's complex128
    truncation at tolerance ε32 against 1e-14; ``j64``: JAX's complex64."""
    from tensornetworkquantumsimulator_tpu.parallel.truncate import (
        batched_truncate as j_truncate)

    from measure_states import converged, port_state

    jspec, jstate, *_ = converged("grid3x3", 3)

    def jz(state, tol):
        out, _ = jax.jit(lambda st: j_truncate(
            jspec, st, chi=3, cutoff=0.03, bp_maxiter=100,
            bp_tolerance=tol))(state)
        return np.real(np.asarray(jp.local_expectations(jspec, out, _Z)))

    z_j = jz(jstate, 1e-14)
    j64 = jp.BatchedState(jstate.tensors.astype(np.complex64),
                          jstate.messages.astype(np.complex64))
    out = {"band": float(np.abs(jz(jstate, F32_EPS) - z_j).max()),
           "j64_t0": float(np.abs(jz(j64, 0.0) - z_j).max())}
    fast = {"TNQS_EIGH_ALG": "jacobi", "TNQS_SVD_ALG": "gram",
            "TNQS_QR_ALG": "cholqr2"}
    for name, stack in (("default", {}), ("fast", fast)):
        saved = {k: os.environ.pop(k, None) for k in fast}
        os.environ.update(stack)
        try:
            for tol, tag in ((0.0, "t0"), (-1.0, "pin")):
                tspec, state = port_state("grid3x3", 3, dtype=np.complex64)
                st, _ = tp.batched_truncate(tspec, state, chi=3, cutoff=0.03,
                                            bp_maxiter=100, bp_tolerance=tol)
                zt = tt.local_expectations(tspec, st, _Z).real.numpy()
                out[f"{name}_{tag}"] = float(np.abs(zt - z_j).max())
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
    return out


if __name__ == "__main__":
    import json
    import sys

    torch.set_num_threads(1)
    tt.set_default_device("cpu")
    what = sys.argv[1:] or ["layer", "truncate"]
    readings = {"hashseed": os.environ.get("PYTHONHASHSEED")}
    for w in what:
        readings[w] = {"layer": layer_readings, "stops": stop_sweeps,
                       "truncate": truncate_readings}[w]()
    print(json.dumps(readings))
