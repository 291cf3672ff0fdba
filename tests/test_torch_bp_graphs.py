"""PyTorch port, flooding BP replayed as CUDA graphs
(``parallel/bp_graphs.py``).

On the CPU the sweep's stretch runner is driven with capture replaced by a
plain call (``_Plain``): a "replay" runs the stretch again and copies what
it returns into the outputs of the first run, as a graph's replay refills
its outputs in place.  It also keeps the shared pool's hazard: a replay
first scribbles over the fresh outputs of every stretch captured after it,
whose memory a real replay may reuse for its intermediates.  So the
runner's fixed buffers, its copies in and out, their order and the host's
one read a sweep are held bit for bit to the eager refresh, over refreshes
with new tensors, where a stale or overwritten buffer would show.  On the
card (``card`` tests) the real graphs are held to the eager path.

No JAX here: the card's tests run in this file too."""

import collections

import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as par
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import bp_graphs, cuda_bp
from tensornetworkquantumsimulator_torch.parallel import engine, su_graphs
from tensornetworkquantumsimulator_torch.utils import profiling

torch.set_num_threads(1)

_Z = tt.op_matrix("Z", 2)
_COUNTERS = ("bp.graph.captures", "bp.graph.replays", "bp.graph.eager",
             "bp.graph.evictions", "bp.sweeps")


class _Plain:
    """Capture as a plain call, in one shared pool (see the module's
    docstring).  An output whose storage is the same in both calls of the
    stretch is an input passed through, which no replay overwrites."""

    def __init__(self, device):
        self.device = device
        self.fresh = []  # the fresh outputs of each stretch, in capture order

    def __call__(self, fn):
        first, outs = fn(), fn()
        index = len(self.fresh)
        self.fresh.append([out for out, f in zip(outs, first)
                           if out.data_ptr() != f.data_ptr()])

        def replay():
            for later in self.fresh[index + 1:]:
                for out in later:
                    _scribble(out)
            for out, new in zip(outs, fn()):
                out.copy_(new)

        return replay, outs


def _scribble(x):
    """What a later replay may leave in ``x``'s memory: NaN, and all
    members active (a stopped member revived)."""
    x.fill_(True if x.dtype == torch.bool else float("nan"))


class _Refused:
    """A capture that raises, as one refused by the card would."""

    def __init__(self, device):
        pass

    def __call__(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    """The port's entry points default to CUDA: these tests ask for the
    CPU, with an empty graph cache."""
    prev = set_default_device("cpu")
    monkeypatch.setattr(bp_graphs, "_cache", collections.OrderedDict())
    monkeypatch.setattr(su_graphs, "_captures", {})
    yield
    set_default_device(prev)


@pytest.fixture
def plain_graphs(monkeypatch):
    """BP's graph path on the CPU, each capture a plain call."""
    monkeypatch.setattr(su_graphs, "Capture", _Plain)
    monkeypatch.setattr(bp_graphs, "_capturable", lambda device: True)


def _eager(monkeypatch):
    monkeypatch.setattr(bp_graphs, "_capturable", lambda device: False)


def _field(dims=(3, 3), chi=4, bp_maxiter=20, bp_tolerance=None,
           device="cpu"):
    g = tt.named_grid(dims)
    spec, state = par.batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=device)
    _, layer = par.make_field_layer_fn(
        g, chi, site_pauli=("X", "Z"), cutoff=1e-10, bp_maxiter=bp_maxiter,
        bp_tolerance=bp_tolerance, spec=spec, device=device)
    return spec, state, layer


def _angles(spec, members, gen, device="cpu"):
    """New site [(E,) 2, V] and bond [(E,) Eb] angles."""
    lead = () if members == 1 else (members,)
    V, Eb = spec.num_vertices, len(spec.edges)
    site = 0.2 + 0.6 * torch.rand(lead + (2, V), generator=gen,
                                  dtype=torch.float64)
    bond = 0.1 + 0.5 * torch.rand(lead + (Eb,), generator=gen,
                                  dtype=torch.float64)
    return site.to(device), bond.to(device)


def _steps(spec, state, layer, members, steps, seed=5):
    """([(state, errors)] after each of ``steps`` layers with new angles,
    the sweeps of each BP refresh, the counters)."""
    run = layer if members == 1 else par.ensemble_fn(layer)
    if members > 1:
        state = par.stack_states([state] * members)
    gen = torch.Generator().manual_seed(seed)
    out, sweeps = [], []
    refresh, iteration = engine.bp_update, engine.bp_iteration

    def counted_refresh(*args, **kwargs):
        sweeps.append(0)
        return refresh(*args, **kwargs)

    def counted_iteration(*args, **kwargs):
        sweeps[-1] += 1
        return iteration(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "bp_update", counted_refresh)
        mp.setattr(engine, "bp_iteration", counted_iteration)
        with profiling.tracing() as handle:
            for _ in range(steps):
                state, err = run(state, *_angles(spec, members, gen))
                out.append((state, err))
            c = handle.collect()["counters"]
    return out, sweeps, {name: c.get(name, 0) for name in _COUNTERS}


def _assert_equal_runs(graphs, eager):
    for (g_state, g_err), (e_state, e_err) in zip(graphs, eager):
        assert torch.equal(g_state.tensors, e_state.tensors)
        assert torch.equal(g_state.messages, e_state.messages)
        assert torch.equal(g_err, e_err)


@pytest.mark.parametrize("members", [1, 3])
def test_the_replayed_fixed_point_equals_the_eager_one_bit_for_bit(
        plain_graphs, monkeypatch, members):
    """A 3×3 field layer, 3 steps of 5 refreshes: the first refresh runs
    eagerly, the second captures M, N1 and N2, every later one replays.
    States, messages and errors equal the eager layer's bit for bit (E = 3:
    the members freeze apart)."""
    spec, state, layer = _field()
    graphs, g_sweeps, counts = _steps(spec, state, layer, members, 3)
    assert len(bp_graphs._cache) == 1
    _eager(monkeypatch)
    eager, e_sweeps, e_counts = _steps(spec, state, layer, members, 3)
    _assert_equal_runs(graphs, eager)
    assert g_sweeps == e_sweeps and len(g_sweeps) == 15
    assert counts["bp.sweeps"] == e_counts["bp.sweeps"] == sum(g_sweeps)
    assert counts["bp.graph.captures"] == 3
    assert counts["bp.graph.eager"] == g_sweeps[0]
    assert counts["bp.graph.replays"] == 3 * sum(g_sweeps[1:])
    assert e_counts["bp.graph.eager"] == sum(e_sweeps)
    assert e_counts["bp.graph.replays"] == e_counts["bp.graph.captures"] == 0


def _random_state(state, gen):
    """``state`` with random tensors of its shapes (its messages kept)."""
    t = torch.randn(state.tensors.shape, generator=gen,
                    dtype=state.tensors.dtype)
    return state._replace(tensors=(t / state.chi).to(state.tensors.device))


def _refreshes(spec, states, tables, **kw):
    return [engine.bp_update(spec, s, tables=tables, **kw) for s in states]


def _folded(states, spec):
    """``states`` folded into one state of members·V vertices, and the
    tables of that fold."""
    members = len(states)
    device = states[0].tensors.device
    tables = engine.member_tables(engine.graph_tables(spec, device), members,
                                  spec.num_vertices)
    return engine.fold_members(par.stack_states(states)), tables


def _several_sweeps(members, monkeypatch, device="cpu"):
    """Refreshes from random tensors take several sweeps at a tolerance of
    1e-6, each stopping short of ``maxiter`` (E = 3: the members at their
    own sweeps, the product state frozen first): each refresh stops on the
    sweep the eager refresh stops on, ``bp.sweeps`` and
    ``bp.member_sweeps_active`` (a device sum, which replayed sweeps must
    feed) are equal, and the messages equal bit for bit."""
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64,
                                             device=device)
    gen = torch.Generator().manual_seed(1)
    # with E = 3 the first member is the product state, which stops first
    refreshes = [_folded([state0] * (members > 1) + [
        _random_state(state0, gen) for _ in range(members - (members > 1))],
        spec) for _ in range(4)]
    names = ("bp.sweeps", "bp.member_sweeps_computed",
             "bp.member_sweeps_active", "bp.graph.eager",
             "bp.graph.replays")

    def run():
        sweeps, outs = [], []
        with profiling.tracing() as handle:
            for state, tables in refreshes:
                before = handle.collect()["counters"].get("bp.sweeps", 0)
                outs.append(engine.bp_update(spec, state, maxiter=40,
                                             tolerance=1e-6, tables=tables,
                                             members=members))
                sweeps.append(handle.collect()["counters"]["bp.sweeps"]
                              - before)
            c = handle.collect()["counters"]
        return outs, sweeps, {name: c.get(name, 0) for name in names}

    graphs, g_sweeps, counts = run()
    _eager(monkeypatch)
    eager, e_sweeps, e_counts = run()
    assert all(1 < s < 40 for s in g_sweeps), g_sweeps
    assert g_sweeps == e_sweeps
    assert counts["bp.graph.eager"] == g_sweeps[0]  # the key's first call
    assert counts["bp.graph.replays"] == 3 * sum(g_sweeps[1:])
    moved = ("bp.sweeps", "bp.member_sweeps_computed",
             "bp.member_sweeps_active")
    assert ({k: counts[k] for k in moved}
            == {k: e_counts[k] for k in moved})
    if members > 1:  # some member stopped before the refresh's last sweep
        assert counts["bp.member_sweeps_active"] < counts[
            "bp.member_sweeps_computed"]
    for a, b in zip(graphs, eager):
        assert torch.equal(a.messages, b.messages)


@pytest.mark.parametrize("members", [1, 3])
def test_refreshes_of_several_sweeps_stop_on_the_same_sweep(
        plain_graphs, monkeypatch, members):
    """:func:`_several_sweeps` on the CPU, each capture a plain call."""
    _several_sweeps(members, monkeypatch)


@pytest.mark.parametrize("damping", [0.0, 0.3])
def test_new_tensors_between_refreshes_are_copied_in(plain_graphs,
                                                     monkeypatch, damping):
    """Refreshes of one key on new tensors of the same shapes, then on the
    same tensor written in place: each equals the eager
    refresh bit for bit, so no buffer keeps an old tensor."""
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64)
    tables = engine.graph_tables(spec, "cpu")
    gen = torch.Generator().manual_seed(2)
    states = [_random_state(state0, gen) for _ in range(4)]

    def run():
        out = _refreshes(spec, states, tables, maxiter=12, tolerance=1e-6,
                         damping=damping)
        kept = states[-1].tensors.clone()
        states[-1].tensors.mul_(1.5)  # in place: the same tensor, new values
        out += _refreshes(spec, states[-1:], tables, maxiter=12,
                          tolerance=1e-6, damping=damping)
        states[-1].tensors.copy_(kept)
        return out

    graphs = run()
    assert len(bp_graphs._cache) == 1
    (entry,) = bp_graphs._cache.values()
    assert set(entry.stretches) == {"m", "n1", "n2"}
    _eager(monkeypatch)
    eager = run()
    for a, b in zip(graphs, eager):
        assert torch.equal(a.messages, b.messages)
    assert not torch.equal(graphs[-1].messages, graphs[-2].messages)


def test_the_returned_messages_are_not_overwritten_by_later_replays(
        plain_graphs):
    """What ``bp_update`` returns is copied out of the graphs' outputs: the
    messages of refresh k read the same after refreshes k+1 and k+2 of the
    same key."""
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64)
    tables = engine.graph_tables(spec, "cpu")
    gen = torch.Generator().manual_seed(3)
    states = [_random_state(state0, gen) for _ in range(4)]
    out = _refreshes(spec, states[:2], tables, maxiter=8)  # eager, capture
    kept = out[1].messages.clone()
    _refreshes(spec, states[2:], tables, maxiter=8)  # replays
    assert torch.equal(out[1].messages, kept)


def _key(spec, state, **kw):
    args = dict(tables=engine.graph_tables(spec, "cpu"), members=1,
                damping=0.0, tolerance=1e-5)
    args.update(kw)
    return bp_graphs._key(state, args["tables"], args["members"],
                          args["damping"], args["tolerance"])


def test_the_key_changes_with_shape_members_damping_tolerance_and_route(
        monkeypatch):
    """New values of the same shapes keep the key; χ, the lattice, the
    members, damping, tolerance and the message route (K3 or the einsum
    chain) each change it."""
    gen = torch.Generator().manual_seed(4)
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64)
    state = _random_state(state0, gen)
    base = _key(spec, state)
    assert base == _key(spec, _random_state(state0, gen))
    spec4, state4 = par.batched_product_state(g, chi=4,
                                              dtype=torch.complex64)
    h = tt.heavy_hexagonal_lattice(2, 2)
    spec_h, state_h = par.batched_product_state(h, chi=3,
                                                dtype=torch.complex64)
    folded = engine.fold_members(par.stack_states([state] * 2))
    tables2 = engine.member_tables(engine.graph_tables(spec, "cpu"), 2,
                                   spec.num_vertices)
    others = [_key(spec4, _random_state(state4, gen)),
              _key(spec_h, state_h),
              _key(spec, folded, tables=tables2, members=2),
              _key(spec, folded, tables=tables2, members=1),
              _key(spec, state, damping=0.1),
              _key(spec, state, tolerance=1e-6)]
    assert len({base, *others}) == 1 + len(others)
    einsum = _key(spec_h, state_h)
    monkeypatch.setenv("TNQS_BP_KERNEL", "1")
    assert engine._k3_route(state_h.tensors, state_h.messages)
    assert _key(spec_h, state_h) != einsum


def test_the_k3_route_replays_n1_and_n2_around_the_eager_kernel(
        plain_graphs, monkeypatch):
    """``TNQS_BP_KERNEL=1`` on a degree-3 complex64 state: K3's wrapper is
    called once per sweep (eagerly; on the CPU it runs its plain version),
    only N1 and N2 are captured, and the refreshes equal the eager ones
    bit for bit."""
    monkeypatch.setenv("TNQS_BP_KERNEL", "1")
    calls = collections.Counter()
    inner = cuda_bp.bp_outgoing_d3

    def counted(*args, **kwargs):
        calls["k3"] += 1
        return inner(*args, **kwargs)

    monkeypatch.setattr(cuda_bp, "bp_outgoing_d3", counted)
    h = tt.heavy_hexagonal_lattice(2, 2)
    spec, state0 = par.batched_product_state(h, chi=3, dtype=torch.complex64)
    tables = engine.graph_tables(spec, "cpu")
    gen = torch.Generator().manual_seed(6)
    states = [_random_state(state0, gen) for _ in range(4)]
    with profiling.tracing() as handle:
        graphs = _refreshes(spec, states, tables, maxiter=10, tolerance=1e-6)
        counts = handle.collect()["counters"]
    (entry,) = bp_graphs._cache.values()
    assert set(entry.stretches) == {"n1", "n2"}
    assert calls["k3"] == counts["bp.sweeps"]
    assert counts["bp.graph.replays"] == 2 * (counts["bp.sweeps"]
                                              - counts["bp.graph.eager"])
    _eager(monkeypatch)
    eager = _refreshes(spec, states, tables, maxiter=10, tolerance=1e-6)
    for a, b in zip(graphs, eager):
        assert torch.equal(a.messages, b.messages)


@pytest.mark.parametrize("why", ["grad", "cpu"])
def test_grad_recording_and_the_cpu_stay_eager(monkeypatch, why):
    """Autograd recording through the state, and a CPU tensor (the real
    capture check), run every sweep eagerly: none captures or replays, and
    the gradient flows."""
    if why == "grad":
        monkeypatch.setattr(su_graphs, "Capture", _Plain)
        monkeypatch.setattr(bp_graphs, "_capturable", lambda device: True)
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64)
    gen = torch.Generator().manual_seed(7)
    state = _random_state(state0, gen)
    if why == "grad":
        state = state._replace(tensors=state.tensors.requires_grad_())
    with profiling.tracing() as handle:
        for _ in range(3):
            out = engine.bp_update(spec, state, maxiter=5)
        counts = handle.collect()["counters"]
    assert counts["bp.graph.captures"] == counts["bp.graph.replays"] == 0
    assert counts["bp.graph.eager"] == counts["bp.sweeps"] > 0
    assert not bp_graphs._cache
    if why == "grad":
        assert out.messages.grad_fn is not None


def test_a_capturing_stream_is_not_captured_again(monkeypatch):
    """The capture check: a CUDA tensor on a stream that is not capturing
    engages, one on a stream that is capturing already (BP called inside
    another graph's capture) does not, and neither does a CPU tensor."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert bp_graphs._capturable(cuda)
    assert not bp_graphs._capturable(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert not bp_graphs._capturable(cuda)


def test_a_refused_capture_leaves_its_key_eager_and_warns(plain_graphs,
                                                          monkeypatch):
    """The refresh that tried to capture still returns the eager result;
    the key stays eager from then on, every sweep counted, one warning."""
    monkeypatch.setattr(su_graphs, "Capture", _Refused)
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64)
    tables = engine.graph_tables(spec, "cpu")
    state = _random_state(state0, torch.Generator().manual_seed(8))
    with profiling.tracing() as handle:
        with pytest.warns(RuntimeWarning, match="capture failed") as seen:
            outs = _refreshes(spec, [state] * 4, tables, maxiter=6)
        counts = handle.collect()["counters"]
    assert len(seen) == 1
    assert counts["bp.graph.captures"] == counts["bp.graph.replays"] == 0
    assert counts["bp.graph.eager"] == counts["bp.sweeps"]
    (entry,) = bp_graphs._cache.values()
    assert entry.failed and not entry.stretches
    for out in outs[1:]:
        assert torch.equal(out.messages, outs[0].messages)


def test_wrappers_on_engine_see_one_call_per_sweep_on_replays(
        plain_graphs, monkeypatch):
    """``engine.bp_iteration`` and ``engine._outgoing_messages`` stay host
    calls looked up on ``engine``: a wrapper put on each sees one call per
    sweep in every refresh, eager, capturing or replaying."""
    calls = collections.Counter()
    for name in ("bp_iteration", "_outgoing_messages"):
        inner = getattr(engine, name)

        def counted(*args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)

        monkeypatch.setattr(engine, name, counted)
    g = tt.named_grid((3, 3))
    spec, state0 = par.batched_product_state(g, chi=3, dtype=torch.complex64)
    tables = engine.graph_tables(spec, "cpu")
    gen = torch.Generator().manual_seed(9)
    per_refresh = []
    with profiling.tracing() as handle:
        for _ in range(4):
            before = handle.collect()["counters"].get("bp.sweeps", 0)
            calls.clear()
            engine.bp_update(spec, _random_state(state0, gen),
                             tables=tables, maxiter=8, tolerance=1e-6)
            sweeps = handle.collect()["counters"]["bp.sweeps"] - before
            per_refresh.append((calls["bp_iteration"],
                                calls["_outgoing_messages"], sweeps))
        counts = handle.collect()["counters"]
    assert all(it == msg == sw > 0 for it, msg, sw in per_refresh)
    assert counts["bp.graph.replays"] > 0


def test_the_cache_drops_its_least_recent_key(plain_graphs, monkeypatch):
    """At most ``MAX_KEYS`` keys; the least recently used goes, counted."""
    monkeypatch.setattr(bp_graphs, "MAX_KEYS", 2)
    g = tt.named_grid((3, 3))
    gen = torch.Generator().manual_seed(10)
    with profiling.tracing() as handle:
        for chi in (2, 3, 4, 2):
            spec, state = par.batched_product_state(g, chi=chi,
                                                    dtype=torch.complex64)
            state = _random_state(state, gen)
            for _ in range(2):
                engine.bp_update(spec, state, maxiter=3)
        counts = handle.collect()["counters"]
    assert len(bp_graphs._cache) == 2
    assert counts["bp.graph.evictions"] == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_CARD = "needs a CUDA card: the graphs capture only there"


def _quench(members, eager, monkeypatch):
    """⟨Z⟩ [steps, E, V] of a 5×5 χ=10 complex64 TFIM quench (hx per
    experiment, hz = 0.8, J = 0.5, dt = 0.25, two experiments of 20 steps
    from |0…0⟩) and the BP counters of each step."""
    monkeypatch.setattr(bp_graphs, "_capturable",
                        (lambda device: False) if eager
                        else bp_graphs._capturable)
    spec, state0, layer = _field(dims=(5, 5), chi=10, bp_maxiter=25,
                                 bp_tolerance=1e-5, device="cuda")
    run = layer if members == 1 else par.ensemble_fn(layer)
    if members > 1:
        state0 = par.stack_states([state0] * members)
    V, Eb = spec.num_vertices, len(spec.edges)
    gen = torch.Generator().manual_seed(31)
    zs, counts = [], []
    for _ in range(2):
        hx = 0.5 + torch.rand((members, 1), generator=gen,
                              dtype=torch.float64)
        site = torch.stack([2 * hx * 0.25 * torch.ones(members, V,
                                                       dtype=torch.float64),
                            torch.full((members, V), 2 * 0.8 * 0.25,
                                       dtype=torch.float64)], dim=1)
        bond = torch.full((members, Eb), 2 * 0.5 * 0.25, dtype=torch.float64)
        if members == 1:
            site, bond = site[0], bond[0]
        site, bond = site.cuda(), bond.cuda()
        state = state0
        for _ in range(20):
            with profiling.tracing() as handle:
                state, _ = run(state, site, bond)
                c = handle.collect()["counters"]
            counts.append({name: c.get(name, 0) for name in _COUNTERS})
            z = par.local_expectations(spec, engine.fold_members(state)
                                       if members > 1 else state, _Z)
            zs.append(z.real.reshape(members, V).cpu())
    return torch.stack(zs), counts


@pytest.mark.card
@pytest.mark.parametrize("members", [1, 4])
def test_replayed_bp_quench_matches_the_eager_path_on_the_card(
        monkeypatch, members):
    """Two 20-step experiments, a new hx each (per member for E = 4), the
    update on its own graphs in both runs: ⟨Z⟩ with BP replayed within
    1e-6 of BP run eagerly, the same sweeps, and every sweep after the two
    warm-up steps replayed (three stretches a sweep)."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    for knob, value in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                        ("TNQS_QR_ALG", "cholqr2")):
        monkeypatch.setenv(knob, value)
    z_graph, counts = _quench(members, False, monkeypatch)
    z_eager, e_counts = _quench(members, True, monkeypatch)
    dz = float((z_graph - z_eager).abs().max())
    print(f"BP graphs E={members}: max |dZ| {dz:.3e}")
    assert dz <= 1e-6
    assert sum(c["bp.graph.captures"] for c in counts[:2]) == 3
    after = counts[2:]
    assert all(c["bp.graph.eager"] == 0 and c["bp.graph.captures"] == 0
               and c["bp.graph.replays"] == 3 * c["bp.sweeps"]
               for c in after), after
    assert (sum(c["bp.sweeps"] for c in counts)
            == sum(c["bp.sweeps"] for c in e_counts))


@pytest.mark.card
@pytest.mark.parametrize("members", [1, 3])
def test_several_sweep_refreshes_match_the_eager_path_on_the_card(
        monkeypatch, members):
    """:func:`_several_sweeps` with the real graphs, in the pool the
    update's graphs share: a replay that overwrote an output still to be
    read (the members still active, E = 3) would show in the stop sweeps,
    ``bp.member_sweeps_active`` or the messages."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    _several_sweeps(members, monkeypatch, "cuda")


@pytest.mark.card
def test_k3_launches_once_per_sweep_on_the_graph_path(monkeypatch):
    """A degree-3 χ=16 complex64 state with ``TNQS_BP_KERNEL=1``:
    ``launches.bp_outgoing_d3`` counts one launch per sweep over refreshes
    that replay N1 and N2, and the messages stay within 1e-6 of the eager
    refreshes'."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    monkeypatch.setenv("TNQS_BP_KERNEL", "1")
    h = tt.heavy_hexagonal_lattice(3, 3)
    spec, state0 = par.batched_product_state(h, chi=16,
                                             dtype=torch.complex64,
                                             device="cuda")
    tables = engine.graph_tables(spec, "cuda")
    gen = torch.Generator().manual_seed(12)
    states = [state0._replace(tensors=(torch.randn(
        state0.tensors.shape, generator=gen, dtype=torch.complex64) / 16
    ).cuda()) for _ in range(4)]

    def run():
        with profiling.tracing() as handle:
            out = _refreshes(spec, states, tables, maxiter=12,
                             tolerance=1e-6)
            return out, handle.collect()["counters"]

    graphs, counts = run()
    (entry,) = bp_graphs._cache.values()
    assert set(entry.stretches) == {"n1", "n2"}
    assert counts["launches.bp_outgoing_d3"] == counts["bp.sweeps"] > 0
    assert counts["bp.graph.replays"] == 2 * (counts["bp.sweeps"]
                                              - counts["bp.graph.eager"]) > 0
    monkeypatch.setattr(bp_graphs, "_capturable", lambda device: False)
    eager, _ = run()
    for a, b in zip(graphs, eager):
        assert float((a.messages - b.messages).abs().max()) <= 1e-6
