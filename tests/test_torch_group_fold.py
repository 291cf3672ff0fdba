"""PyTorch port, one simple update per colour group in the field layer
(``parallel/ensemble.py`` ``FieldLayer``): every slot-pair bucket of a
colour group goes into one ``apply_color_group`` call, each edge with its
own gate, stacked in bucket order (``engine._bucket_gates``).

The fold changes only how the update's library calls are batched: the
edges of a colour group share no vertex, and every factorization works
matrix by matrix.  So in complex128 on the CPU the folded layer is held to
the per-bucket updates (``TNQS_FUSE_BUCKETS=0``, and the per-bucket loop
written out here) with the truncation errors in the same ``[E, n]`` column
order; ``_group_core`` on a stacked per-edge gate is held to one call per
bucket, and two planted faults in the slicing must fail that check.  On
the card (``card`` tests) one Eagle χ=64 step makes one K2 launch at n=256
per colour group, every update replayed from its group's graphs.

No JAX here: the card's test runs in this file too."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as par
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import engine
from tensornetworkquantumsimulator_torch.parallel import ensemble as te
from tensornetworkquantumsimulator_torch.parallel import su_graphs
from tensornetworkquantumsimulator_torch.parallel.structure import (
    SlotPairBucket,
)
from tensornetworkquantumsimulator_torch.utils import profiling

torch.set_num_threads(1)

_Z = tt.op_matrix("Z", 2)
_HERE = Path(__file__).resolve().parent

# lattice -> (graph function, χ, members, steps): the 5×5 grid with
# per-member disorder folded three times, and Eagle's 127-qubit heavy hex;
# χ and the steps are chosen so that the last step truncates (errors up to
# 1.5e-3 and 1.4e-4)
_LATTICES = {
    "grid5x5_disorder_e3": (lambda: tt.named_grid((5, 5)), 2, 3, 3),
    "heavyhex127_chi4": (tt.ibm_eagle_lattice, 4, 1, 5),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _field(lattice, dtype=torch.complex128, device="cpu"):
    """(spec, one member's |0…0⟩, layer, members, steps) of ``lattice``."""
    make_graph, chi, members, steps = _LATTICES[lattice]
    g = make_graph()
    spec, state = par.batched_product_state(g, chi=chi, dtype=dtype,
                                            device=device)
    _, layer = par.make_field_layer_fn(
        g, chi, site_pauli=("X",), cutoff=1e-10, bp_maxiter=30,
        bp_tolerance=1e-10, spec=spec, device=device)
    return spec, state, layer, members, steps


def _disorder(spec, members, seed):
    """Per-member site [E, 1, V] and per-edge bond [E, Eb] angles, as the
    disorder traffic draws them (hx ~ U(0.5, 1.5), J ~ U(0.8, 1.2))."""
    gen = torch.Generator().manual_seed(seed)
    V, Eb = spec.num_vertices, len(spec.edges)
    site = 2 * 0.25 * (0.5 + torch.rand((members, 1, V), generator=gen,
                                        dtype=torch.float64))
    bond = 2 * 0.25 * (0.8 + 0.4 * torch.rand((members, Eb), generator=gen,
                                              dtype=torch.float64))
    return site, bond


def _layer_step(layer, estate, site, bond):
    """The field layer over stacked states [E, V, ...]."""
    return par.ensemble_fn(layer)(estate, site, bond)


def _bucket_loop(layer, estate, site, bond):
    """One field layer written out as it ran before the fold: one
    ``apply_color_group`` per slot-pair bucket, each with the gates of its
    own edges, the errors ``[E, B]`` per bucket concatenated."""
    spec, E = layer.spec, site.shape[0]
    V = spec.num_vertices
    tables = engine.member_tables(engine.GraphTables(
        layer.nbr, layer.nbr_slot, layer.mask), E, V)

    def refresh(st):
        return engine.bp_update(spec, st, tables=tables, members=E,
                                **layer.bp_kwargs)

    state = engine.fold_members(estate)
    dtype = state.tensors.dtype
    gate = te.rot1("X", site[:, 0])
    state = engine.apply_one_site(state, gate.reshape(E * V, 2, 2).to(dtype))
    errs = []
    for group, eidxs in zip(spec.color_groups, te._group_angle_tables(spec)):
        state = refresh(state)
        for b, eidx in zip(group, eidxs):
            bucket = SlotPairBucket(
                b.slot_u, b.slot_v,
                engine.member_indices(torch.as_tensor(b.u_idx), E, V),
                engine.member_indices(torch.as_tensor(b.v_idx), E, V))
            gmat = te.rot2("ZZ", bond[:, torch.as_tensor(eidx)])
            state, err = engine.apply_color_group(
                state, (bucket,), gmat.reshape(-1, 2, 2, 2, 2).to(dtype),
                layer.chi, layer.cutoff, layer.normalize_tensors)
            errs.append(err.reshape(E, -1))
    state = engine.unfold_members(refresh(state), E)
    return state, torch.cat(errs, dim=1)


def _run(lattice, step=_layer_step, seed=17):
    """(⟨Z⟩ [E, V], errors [E, n] of the last step) after the lattice's
    disorder steps from |0…0⟩."""
    spec, state, layer, members, steps = _field(lattice)
    estate = par.stack_states([state] * members)
    for k in range(steps):
        estate, err = step(layer, estate, *_disorder(spec, members, seed + k))
    z = par.local_expectations(spec, engine.fold_members(estate), _Z)
    return z.real.reshape(members, -1), err


@pytest.mark.parametrize("reference", ["fuse_off", "bucket_loop"])
@pytest.mark.parametrize("lattice", sorted(_LATTICES))
def test_folded_layer_equals_per_bucket_updates(monkeypatch, lattice,
                                                reference):
    """Disorder steps in complex128: ⟨Z⟩ of the folded layer within
    1e-6 of per-bucket updates (``TNQS_FUSE_BUCKETS=0``, or the per-bucket
    loop), the truncation errors equal in the same ``[E, n]`` order."""
    spec = _field(lattice)[0]
    members = _LATTICES[lattice][2]
    # some colour group has several buckets, so the fold has work to do
    assert any(len(group) > 1 for group in spec.color_groups)
    z_fold, e_fold = _run(lattice)
    if reference == "fuse_off":
        monkeypatch.setenv("TNQS_FUSE_BUCKETS", "0")
        z_ref, e_ref = _run(lattice)
    else:
        z_ref, e_ref = _run(lattice, step=_bucket_loop)
    assert e_fold.shape == e_ref.shape == (members, len(spec.edges))
    assert float((z_fold - z_ref).abs().max()) <= 1e-6
    np.testing.assert_allclose(e_fold.numpy(), e_ref.numpy(), rtol=1e-6,
                               atol=1e-14)
    assert float(e_ref.max()) > 1e-5  # the last step truncates


# ---------------------------------------------------------------------------
# _group_core on per-edge gates
# ---------------------------------------------------------------------------

def _random_items(seed, sizes=(2, 2, 3), chi=3, d=2):
    """Gathered rows of a degree-3 colour group's buckets (slot pairs (0,
    1), (1, 2), (2, 0)), random complex128 tensors and PSD messages, and
    one random 2-site unitary per edge, stacked [ΣB, d, d, d, d]."""
    gen = torch.Generator().manual_seed(seed)

    def randc(*shape):
        return torch.complex(torch.randn(shape, generator=gen,
                                         dtype=torch.float64),
                             torch.randn(shape, generator=gen,
                                         dtype=torch.float64))

    def psd(B):
        a = randc(B, 3, chi, chi)
        return a @ a.conj().transpose(-1, -2) / chi

    items = [(su, sv, randc(B, chi, chi, chi, d), randc(B, chi, chi, chi, d),
              psd(B), psd(B))
             for (su, sv), B in zip(((0, 1), (1, 2), (2, 0)), sizes)]
    q, _ = torch.linalg.qr(randc(sum(sizes), d * d, d * d))
    return items, q.reshape(-1, d, d, d, d)


def _fused_and_split(items, gate, chi=3):
    """(θ [ΣB, r·d, r·d], [(tu_new, tv_new, msg, err)]) of one stacked
    update of ``items`` under ``gate``."""
    roots, _inv = engine._pseudo_roots(engine._su_env(items))
    _q, _r, theta = engine._su_reduce(items, roots, gate, chi)
    return theta, engine._group_core(items, gate, chi, 1e-10, True)


def _swap_first_two(gate, sizes):
    parts = list(torch.split(gate, list(sizes)))
    if len(parts) > 1:
        parts[0], parts[1] = parts[1], parts[0]
    return parts


_FAULTS = {
    "none": None,
    "whole_gate_to_every_bucket": lambda gate, sizes: [gate] * len(sizes),
    "two_buckets_swapped": _swap_first_two,
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_group_core_hands_each_bucket_its_own_gate_slice(monkeypatch,
                                                         fault):
    """Three buckets, each edge with its own gate, in one ``_group_core``:
    θ and every updated row equal one call per bucket on its slice.  A
    planted fault in the slicing (the whole stack to every bucket, or two
    buckets' slices swapped) must fail that comparison."""
    items, gate = _random_items(3)
    sizes = [it[2].shape[0] for it in items]
    per_bucket = [_fused_and_split([it], g)
                  for it, g in zip(items, torch.split(gate, sizes))]
    want_theta = torch.cat([t for t, _ in per_bucket])
    want_rows = [r for _, rows in per_bucket for r in rows]
    if _FAULTS[fault] is not None:
        monkeypatch.setattr(engine, "_bucket_gates", _FAULTS[fault])
    try:
        theta, rows = _fused_and_split(items, gate)
        same = (torch.allclose(theta, want_theta, rtol=0, atol=1e-12)
                and len(rows) == len(want_rows)
                and all(torch.allclose(a, b, rtol=0, atol=1e-12)
                        for got, want in zip(rows, want_rows)
                        for a, b in zip(got, want)))
    except RuntimeError:  # the stacked gate does not fit a bucket
        same = False
    assert same == (fault == "none")


def test_a_shared_gate_reaches_every_bucket_whole():
    """A gate [d, d, d, d] goes to every bucket as it is, fused or not."""
    gate = torch.eye(4, dtype=torch.complex128).reshape(2, 2, 2, 2)
    assert all(g is gate for g in engine._bucket_gates(gate, (2, 2, 3)))
    stacked = torch.zeros(7, 2, 2, 2, 2, dtype=torch.complex128)
    assert [g.shape[0] for g in engine._bucket_gates(stacked, (2, 2, 3))] == [
        2, 2, 3]
    with pytest.raises(RuntimeError):
        engine._bucket_gates(stacked, (2, 2))


# ---------------------------------------------------------------------------
# the engagement counter
# ---------------------------------------------------------------------------

def _step_counts(lattice) -> tuple:
    """((``su.group`` spans, ``su.group.buckets``) of one field-layer step
    of one member, (colour groups, slot-pair buckets) of the spec)."""
    spec, state, layer, _members, _steps = _field(lattice)
    site, bond = _disorder(spec, 1, 5)
    with profiling.tracing() as handle:
        layer(state, site[0], bond[0])
        data = handle.collect()
    calls = sum(s.name == "su.group" for s in data["spans"])
    return ((calls, data["counters"]["su.group.buckets"]),
            (len(spec.color_groups),
             sum(len(group) for group in spec.color_groups)))


@pytest.mark.parametrize("lattice", sorted(_LATTICES))
def test_one_step_makes_one_update_call_per_colour_group(lattice):
    """Under ``tracing()`` one layer step opens one ``su.group`` span per
    colour group and hands it all of the group's buckets."""
    counted, expected = _step_counts(lattice)
    assert counted == expected


def test_update_calls_and_buckets_at_hash_seed_zero():
    """At ``PYTHONHASHSEED=0`` (the benchmark's colouring): 4 update calls
    and 15 buckets a step on the 5×5 grid, 3 and 13 on the heavy hex."""
    code = ("import test_torch_group_fold as t\n"
            "from tensornetworkquantumsimulator_torch import "
            "set_default_device\n"
            "set_default_device('cpu')\n"
            "for lat in ('grid5x5_disorder_e3', 'heavyhex127_chi4'):\n"
            "    print(lat, *t._step_counts(lat)[0])\n")
    env = dict(os.environ, PYTHONHASHSEED="0",
               PYTHONPATH=os.pathsep.join([str(_HERE), str(_HERE.parent)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=_HERE, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["grid5x5_disorder_e3", "4", "15",
                                  "heavyhex127_chi4", "3", "13"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_CARD = "needs a CUDA card: K2 and the update's graphs run only there"


@pytest.mark.card
def test_an_eagle_chi64_step_launches_k2_at_n256_once_per_colour_group(
        monkeypatch):
    """The benchmark's Eagle χ=64 field layer (Rx(θ_h), Rzz(−π/2), the fast
    stack with K3): after two warm-up steps (eager, capture) one step makes
    one K2 launch at n=256 per colour group, the graphs hold one key per
    colour group, and every update of the step replays."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    for knob, value in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                        ("TNQS_QR_ALG", "cholqr2"), ("TNQS_BP_KERNEL", "1")):
        monkeypatch.setenv(knob, value)
    monkeypatch.setattr(su_graphs, "_cache", type(su_graphs._cache)())
    set_default_device("cuda")
    g = tt.ibm_eagle_lattice()
    spec, state = par.batched_product_state(g, chi=64, dtype=torch.complex64,
                                            device="cuda")
    _, layer = par.make_field_layer_fn(
        g, 64, site_pauli=("X",), cutoff=1e-10, bp_maxiter=25,
        bp_tolerance=1e-5, spec=spec, device="cuda")
    site = torch.full((1, spec.num_vertices), 0.6, device="cuda")
    bond = torch.full((len(spec.edges),), -np.pi / 2, device="cuda")
    sizes = []
    inner = engine.jacobi_eigh

    def recorded(h, *args, **kwargs):
        sizes.append(h.shape[-1])
        return inner(h, *args, **kwargs)

    monkeypatch.setattr(engine, "jacobi_eigh", recorded)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = layer(state, site, bond)
    sizes.clear()
    with profiling.tracing() as handle:
        state, _ = layer(state, site, bond)
        c = handle.collect()["counters"]
    torch.cuda.synchronize()
    groups = len(spec.color_groups)
    replays = c["su.graph.replays"] / 3
    print(f"eagle chi64 step: K2 launches at n=256 {sizes.count(256)}, all "
          f"{c['launches.jacobi_eigh']}; graph keys {len(su_graphs._cache)}; "
          f"replay share {replays / (replays + c['su.graph.eager']):.3f}; "
          f"peak {torch.cuda.max_memory_allocated()} bytes")
    assert sizes.count(256) == groups == 3
    assert c["su.group.buckets"] == sum(len(grp) for grp in spec.color_groups)
    assert len(su_graphs._cache) == groups
    assert c["su.graph.eager"] == 0 and replays == groups
    z = par.local_expectations(spec, state, _Z).real
    assert torch.isfinite(z).all()
