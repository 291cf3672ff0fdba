"""PyTorch port, the program's spans and counters (``utils/profiling.py``):
off by default and then free of effects, on through ``tracing()`` with
the parents, steps and self times the span sites give, the counters
against what they count, and ``trace()`` writing the program's ranges and
counters beside the profiler's trace.  One test holds the Jacobi kernels'
sweep counters to the kernels' own ``sweeps=`` buffers on the card.

No JAX here: the card's test runs in this file too."""

import collections
import ctypes
import json
import os

import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as par
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import cuda_bp
from tensornetworkquantumsimulator_torch.parallel import cuda_linalg
from tensornetworkquantumsimulator_torch.parallel import cuda_matmul
from tensornetworkquantumsimulator_torch.parallel import engine
from tensornetworkquantumsimulator_torch.utils import profiling

torch.set_num_threads(1)

# the parent of each span, as the span sites give it
PARENT = {
    "layer": None, "readout": None,
    "bp.update": "layer", "bp.sweep": "bp.update",
    "bp.messages": "bp.sweep", "bp.converge_read": "bp.sweep",
    "su.group": "layer", "su.roots": "su.group", "su.qr": "su.group",
    "su.qr.cholesky": "su.qr",
    "su.theta": "su.group", "su.split": "su.group", "su.finish": "su.group",
    "linalg.roots": "su.roots", "linalg.eigh": "su.split",
}
_Z = tt.op_matrix("Z", 2)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.fixture
def gram_split(monkeypatch):
    """The benchmark's stack, whose split runs an eigh (``linalg.eigh``)."""
    monkeypatch.setenv("TNQS_SVD_ALG", "gram")
    monkeypatch.setenv("TNQS_QR_ALG", "cholqr2")


def _field(dtype=torch.complex64, chi=4):
    g = tt.named_grid((3, 3))
    spec, state = par.batched_product_state(g, chi=chi, dtype=dtype)
    _, layer = par.make_field_layer_fn(
        g, chi, site_pauli=("X", "Z"), cutoff=1e-10, bp_maxiter=20,
        spec=spec)
    V, E = spec.num_vertices, len(spec.edges)
    site = torch.tensor([[0.5] * V, [0.4] * V], dtype=torch.float64)
    bond = torch.linspace(0.2, 0.9, E, dtype=torch.float64)
    return spec, state, layer, site, bond


def _fused():
    """A BP refresh and the simple update of the colour group with the most
    slot-pair buckets under one gate (the fused group update), inside a
    ``layer`` span as a layer's own would be."""
    spec, state, _layer, _site, _bond = _field()
    group = max(spec.color_groups, key=len)
    assert len(group) > 1
    gate = par.rot2("ZZ", torch.tensor(0.3)).reshape(2, 2, 2, 2).to(
        torch.complex64)

    def run():
        with profiling.span("layer"):
            st = par.bp_update(spec, state, maxiter=20)
            return engine.apply_color_group(st, group, gate, 4, 1e-10)

    return spec, run


def _names_and_parents(spans):
    by_id = {s.id: s for s in spans}
    return collections.Counter(
        (s.name, by_id[s.parent].name if s.parent else None) for s in spans)


def _under(event, name) -> bool:
    """Whether a profiler event ran inside a range ``name``."""
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.cpu_parent
    return False


def test_tracing_is_off_by_default_and_the_off_path_changes_nothing(
        gram_split, monkeypatch):
    """Off: the layer's outputs are bit for bit those of a traced run, no
    counter moves, no CUDA event is made, and the profiler records the
    same operations as in a traced run, less the program's ranges and the
    device sums of its counters (CholeskyQR's shifted matrices; each put
    under a range of its own here)."""
    spec, state, layer, site, bond = _field()
    assert not profiling.is_tracing()
    accumulate = profiling._Tracer.accumulate

    def labelled(self, name, x):
        with torch.profiler.record_function("tnqs.device_sum"):
            accumulate(self, name, x)

    monkeypatch.setattr(profiling._Tracer, "accumulate", labelled)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    layer(state, site, bond)  # fills the layer's caches of constant gates
    before = {n: c.count for n, c in profiling.COUNTERS.items()}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as off_prof:
        off, off_err = layer(state, site, bond)
        z_off = par.local_expectations(spec, off, _Z)
    assert {n: c.count for n, c in profiling.COUNTERS.items()} == before
    with profiling.tracing() as handle:
        with torch.profiler.profile(activities=acts) as on_prof:
            on, on_err = layer(state, site, bond)
            z_on = par.local_expectations(spec, on, _Z)
        data = handle.collect()
    assert torch.equal(off.tensors, on.tensors)
    assert torch.equal(off.messages, on.messages)
    assert torch.equal(off_err, on_err) and torch.equal(z_off, z_on)
    assert data["spans"] and data["counters"]["bp.sweeps"] > 0

    off_ops = collections.Counter(e.name for e in off_prof.events())
    on_ops = collections.Counter(e.name for e in on_prof.events()
                                 if not _under(e, "tnqs.device_sum"))
    ranges = {n for n in on_ops if n.startswith("tnqs.")}
    assert "tnqs.layer" in ranges and "tnqs.readout" in ranges
    assert on_ops["tnqs.device_sum"] > 0
    assert not any(n.startswith("tnqs.") for n in off_ops)
    assert off_ops == on_ops - collections.Counter(
        {n: on_ops[n] for n in ranges})
    # a session opened now finds nothing of the off run
    with profiling.tracing() as handle:
        empty = handle.collect()
    assert empty["spans"] == []
    assert not any(empty["counters"].values())


@pytest.mark.parametrize("which", ["field", "fused"])
def test_every_span_has_the_parent_its_site_gives(gram_split, which):
    if which == "field":
        spec, state, layer, site, bond = _field()
        run = lambda: layer(state, site, bond)  # noqa: E731
    else:
        spec, run = _fused()
    with profiling.tracing() as handle:
        out, _ = run()
        par.local_expectations(spec, out, _Z)
        spans = handle.collect()["spans"]
    seen = _names_and_parents(spans)
    assert {parent for (_n, parent) in seen} <= set(PARENT.values())
    for (name, parent), _count in seen.items():
        assert PARENT[name] == parent, (name, parent)
    assert set(PARENT) == {name for name, _ in seen}
    assert seen[("layer", None)] == 1 and seen[("readout", None)] == 1
    # one split and one finish of the group's own per group update
    assert seen[("su.split", "su.group")] == seen[("su.group", "layer")]


def test_the_spans_of_a_layer_call_share_its_step(gram_split):
    spec, state, layer, site, bond = _field()
    with profiling.tracing() as handle:
        for _ in range(2):
            state, _ = layer(state, site, bond)
            par.local_expectations(spec, state, _Z)
        spans = handle.collect()["spans"]
    by_id = {s.id: s for s in spans}
    layers = sorted((s for s in spans if s.name == "layer"),
                    key=lambda s: s.start_ns)
    assert [s.step for s in layers] == [1, 2]
    for s in spans:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.step == root.step
        if root.name == "layer":
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # a readout after a layer carries that layer's step
    assert sorted(s.step for s in spans if s.name == "readout") == [1, 2]


def test_self_time_is_never_negative_and_tiles_the_layer(gram_split):
    spec, state, layer, site, bond = _field()
    with profiling.tracing() as handle:
        layer(state, site, bond)
        spans = handle.collect()["spans"]
    assert all(s.self_ns >= 0 for s in spans)
    assert all(s.end_ns >= s.start_ns for s in spans)
    (root,) = [s for s in spans if s.name == "layer"]
    # the self times of a tree add up to its root's duration
    assert sum(s.self_ns for s in spans) == root.end_ns - root.start_ns


def test_bp_sweeps_count_the_calls_of_bp_iteration(gram_split, monkeypatch):
    spec, state, layer, site, bond = _field()
    calls = []
    inner = engine.bp_iteration

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(engine, "bp_iteration", counted)
    with profiling.tracing() as handle:
        for _ in range(2):
            state, _ = layer(state, site, bond)
        data = handle.collect()
    c = data["counters"]
    names = collections.Counter(s.name for s in data["spans"])
    assert c["bp.sweeps"] == len(calls) == names["bp.sweep"] > 0
    assert c["host.reads.bp.converge"] == c["bp.sweeps"]
    assert names["bp.converge_read"] == c["bp.sweeps"]
    assert c["bp.member_sweeps_computed"] == c["bp.sweeps"]
    assert c["bp.member_sweeps_active"] == c["bp.sweeps"]


def test_a_folded_ensemble_counts_the_sweeps_of_stopped_members():
    """Two members, one a product state under zero angles (BP stops after
    one sweep) and one entangled by two layers: the fold computes both
    until the second stops, so fewer member-sweeps were active."""
    spec, state, layer, site, bond = _field(dtype=torch.complex128)
    site, bond = 2 * site, 2 * bond
    entangled = state
    for _ in range(2):
        entangled, _ = layer(entangled, site, bond)
    members = par.stack_states([state, entangled])
    sites = torch.stack([torch.zeros_like(site), site])
    bonds = torch.stack([torch.zeros_like(bond), bond])
    with profiling.tracing() as handle:
        par.ensemble_fn(layer)(members, sites, bonds)
        c = handle.collect()["counters"]
    assert c["bp.member_sweeps_computed"] == 2 * c["bp.sweeps"]
    assert c["bp.sweeps"] < c["bp.member_sweeps_active"] < c[
        "bp.member_sweeps_computed"]


def test_linalg_spans_take_one_depth_and_carry_their_batch(monkeypatch):
    """The roots stage through an eigh (``TNQS_ROOTS_FUSED=0``) is one
    ``linalg.roots`` span, with no ``linalg.eigh`` under it."""
    monkeypatch.setenv("TNQS_EIGH_ALG", "jacobi")
    monkeypatch.setenv("TNQS_ROOTS_FUSED", "0")
    spec, state, layer, site, bond = _field()
    with profiling.tracing() as handle:
        layer(state, site, bond)
        spans = handle.collect()["spans"]
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "linalg.roots"]
    assert roots and all(s.n == 4 and s.batch >= 1 for s in roots)
    assert not any(s.name == "linalg.eigh" and by_id[s.parent].name
                   == "linalg.roots" for s in spans)
    with profiling.tracing() as handle:
        engine._eigh(torch.eye(6, dtype=torch.complex64).expand(
            3, 2, 6, 6).contiguous())
        (s,) = handle.collect()["spans"]
    assert (s.name, s.batch, s.n, s.parent) == ("linalg.eigh", 6, 6, None)


def test_trace_writes_program_ranges_and_counters(tmp_path, gram_split):
    spec, state, layer, site, bond = _field()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        out, _ = layer(state, site, bond)
        par.local_expectations(spec, out, _Z)
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"tnqs.layer", "tnqs.bp.update", "tnqs.su.group",
            "tnqs.readout"} <= names
    with open(os.path.join(log_dir, "counters.json")) as f:
        counters = json.load(f)
    assert counters["bp.sweeps"] > 0
    assert counters["host.reads.bp.converge"] == counters["bp.sweeps"]
    with open(os.path.join(log_dir, "spans.json")) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"] for e in events} == {f"tnqs.{n}" for n in PARENT}
    assert all(e["ph"] == "X" and e["dur"] >= e["args"]["self_us"] >= 0
               for e in events)
    assert not profiling.is_tracing()


def test_sessions_do_not_nest_and_read_after_they_end():
    with profiling.tracing() as handle:
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.tracing():
                pass
        with profiling.span("layer"):
            pass
    assert not profiling.is_tracing()
    (s,) = handle.collect()["spans"]
    assert (s.name, s.parent, s.step) == ("layer", None, 1)


def test_kernel_launch_counters_are_the_program_counters():
    for name, counter in (
            ("launches.jacobi_pseudo_roots", cuda_linalg.roots_launches),
            ("launches.jacobi_eigh", cuda_linalg.eigh_launches),
            ("launches.bp_outgoing_d3", cuda_bp.bp_launches),
            ("launches.complex_matmul", cuda_matmul.matmul_launches)):
        assert isinstance(counter, profiling.Counter)
        assert profiling.COUNTERS[name] is counter
    c = profiling.Counter("test.tracing.counter")
    try:
        c.add(3)  # off: not counted
        assert c.count == 0
        with profiling.tracing() as handle:
            c.add(3)
            c.add_device(torch.tensor([True, False, True]))
            assert handle.collect()["counters"]["test.tracing.counter"] == 5
        assert c.count == 3
        c.reset()
        assert c.count == 0
    finally:
        del profiling.COUNTERS["test.tracing.counter"]


def test_device_slots_are_summed_at_collect_and_folded_when_full(
        monkeypatch):
    """A counter's slots are consecutive int32s of one buffer per device,
    whatever a kernel writes there is added up at ``collect()``, and a
    full buffer is folded into the counter before it is reused.  Here
    host memory stands in for the card's."""
    monkeypatch.setattr(profiling, "_SLOTS", 8)
    cpu = torch.device("cpu")
    c = profiling.Counter("test.tracing.slots")
    try:
        assert c.device_slots(3, cpu) == 0  # off: no slots
        with profiling.tracing() as handle:
            written, ptrs = 0, []
            for n, value in ((3, 4), (4, 5), (6, 7), (2, 1)):
                ptrs.append(c.device_slots(n, cpu))
                (ctypes.c_int32 * n).from_address(ptrs[-1])[:] = [value] * n
                written += n * value
            # 3 + 4 slots fit; 6 more fold them and start the buffer again
            assert ptrs[1] - ptrs[0] == 3 * 4
            assert ptrs[2] == ptrs[0] and ptrs[3] - ptrs[2] == 6 * 4
            assert handle.collect()["counters"]["test.tracing.slots"] == (
                written)
    finally:
        del profiling.COUNTERS["test.tracing.slots"]


@pytest.mark.card
def test_jacobi_sweep_counters_equal_the_kernels_own_buffers():
    """K1 and K2 on the card: the counters read, for launches given a
    ``sweeps`` buffer and for launches given none, the sum of the
    kernel's own per-matrix counts on the same batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 run only there")
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn(12, 40, 10, dtype=torch.complex64, device="cuda",
                    generator=g)
    b = torch.randn(72, 10, 10, dtype=torch.complex64, device="cuda",
                    generator=g)
    gram, env = a @ a.mH, b @ b.mH
    own_e = torch.zeros(12, dtype=torch.int32, device="cuda")
    own_r = torch.zeros(72, dtype=torch.int32, device="cuda")
    with profiling.tracing() as handle:
        cuda_linalg.jacobi_eigh(gram, sweeps=own_e)
        cuda_linalg.jacobi_pseudo_roots(env, sweeps=own_r)
        given = handle.collect()["counters"]
    with profiling.tracing() as handle:
        cuda_linalg.jacobi_eigh(gram)
        cuda_linalg.jacobi_pseudo_roots(env)
        none = handle.collect()["counters"]
    assert int(own_e.min()) >= 1 and int(own_r.min()) >= 1
    for c in (given, none):
        assert c["jacobi.eigh_sweeps"] == int(own_e.sum())
        assert c["jacobi.roots_sweeps"] == int(own_r.sum())
        assert (c["jacobi.eigh_matrices"], c["jacobi.roots_matrices"]) == (
            12, 72)
        assert c["launches.jacobi_eigh"] == c[
            "launches.jacobi_pseudo_roots"] == 1
