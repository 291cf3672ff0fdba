"""PyTorch port, the simple update replayed as CUDA graphs
(``parallel/su_graphs.py``).

On the CPU the stretch runner is driven with capture replaced by a plain
call (``_Plain``): a "replay" runs the stretch again and copies what it
returns into the outputs of the first run, as a graph's replay refills its
outputs in place.  So the runner's static buffers, its copies of K1's and
K2's outputs and its write-back are held bit for bit to the eager update,
over steps with new angles, where a stale buffer would show.  On the card
(``card`` tests) the real graphs are held to the eager path.

No JAX here: the card's tests run in this file too."""

import collections
import warnings

import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import parallel as par
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import engine, su_graphs
from tensornetworkquantumsimulator_torch.utils import profiling

torch.set_num_threads(1)

_Z = tt.op_matrix("Z", 2)
_COUNTERS = ("su.graph.captures", "su.graph.replays", "su.graph.eager",
             "su.graph.evictions")


class _Plain:
    """Capture as a plain call (see the module's docstring)."""

    def __init__(self, device):
        self.device = device

    def __call__(self, fn):
        outs = fn()

        def replay():
            for out, new in zip(outs, fn()):
                out.copy_(new)

        return replay, outs


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.fixture
def fast_stack(monkeypatch):
    """The benchmark's route (the Jacobi eigh, the Gram split, CholeskyQR2)
    and an empty graph cache."""
    for knob, value in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                        ("TNQS_QR_ALG", "cholqr2")):
        monkeypatch.setenv(knob, value)
    monkeypatch.setattr(su_graphs, "_cache", collections.OrderedDict())
    monkeypatch.setattr(su_graphs, "_captures", {})


@pytest.fixture
def plain_graphs(fast_stack, monkeypatch):
    """The graph path on the CPU, each capture a plain call."""
    monkeypatch.setattr(su_graphs, "Capture", _Plain)
    monkeypatch.setattr(su_graphs, "_capturable", lambda device: True)


def _field(chi=4, dims=(3, 3), device="cpu", bp_maxiter=20,
           bp_tolerance=None):
    g = tt.named_grid(dims)
    spec, state = par.batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=device)
    _, layer = par.make_field_layer_fn(
        g, chi, site_pauli=("X", "Z"), cutoff=1e-10, bp_maxiter=bp_maxiter,
        bp_tolerance=bp_tolerance, spec=spec, device=device)
    return spec, state, layer


def _updates(layer) -> int:
    """Updates a layer step makes: one ``apply_color_group`` per colour
    group, its slot-pair buckets stacked."""
    return len(layer._groups)


def _angles(spec, members, gen, device="cpu"):
    """New site [(E,) 2, V] and bond [(E,) Eb] angles."""
    lead = () if members == 1 else (members,)
    V, Eb = spec.num_vertices, len(spec.edges)
    site = 0.2 + 0.6 * torch.rand(lead + (2, V), generator=gen,
                                  dtype=torch.float64)
    bond = 0.1 + 0.5 * torch.rand(lead + (Eb,), generator=gen,
                                  dtype=torch.float64)
    return site.to(device), bond.to(device)


def _steps(spec, state, layer, members, steps, seed=5, device="cpu"):
    """[(state, errors)] after each of ``steps`` layers with new angles."""
    run = layer if members == 1 else par.ensemble_fn(layer)
    if members > 1:
        state = par.stack_states([state] * members)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        state, err = run(state, *_angles(spec, members, gen, device))
        out.append((state, err))
    return out


def _counts(handle) -> dict:
    c = handle.collect()["counters"]
    return {name: c.get(name, 0) for name in _COUNTERS}


@pytest.mark.parametrize("members", [1, 3])
def test_the_segmented_update_equals_the_eager_one_bit_for_bit(
        plain_graphs, monkeypatch, members):
    """Step 1 runs every key eagerly, step 2 captures, step 3 replays: the
    states, messages and errors equal the eager layer's bit for bit."""
    spec, state, layer = _field()
    with profiling.tracing() as handle:
        graphs = _steps(spec, state, layer, members, 3)
        counts = _counts(handle)
    keys = len(su_graphs._cache)
    monkeypatch.setattr(su_graphs, "_capturable", lambda device: False)
    eager = _steps(spec, state, layer, members, 3)
    for (g_state, g_err), (e_state, e_err) in zip(graphs, eager):
        assert torch.equal(g_state.tensors, e_state.tensors)
        assert torch.equal(g_state.messages, e_state.messages)
        assert torch.equal(g_err, e_err)
    nb = _updates(layer)
    assert 1 <= keys <= nb
    # each key's first call ran eagerly, every other call replayed S0-S2
    assert counts["su.graph.eager"] == keys
    assert counts["su.graph.captures"] == 3 * keys
    assert counts["su.graph.eager"] + counts["su.graph.replays"] // 3 == (
        3 * nb)
    assert counts["su.graph.evictions"] == 0


def test_the_fused_group_update_replays_bit_for_bit(plain_graphs,
                                                    monkeypatch):
    """Several buckets under one gate in one call (``batched_truncate``'s
    and ``TrotterLayer``'s fused colour group): three calls, the last two
    through the graph path, equal the eager ones."""
    spec, state, layer = _field()
    state = _steps(spec, state, layer, 1, 1)[0][0]
    su_graphs._cache.clear()
    group = max(spec.color_groups, key=len)
    assert len(group) > 1
    gates = [par.rot2("ZZ", torch.tensor(a)).reshape(2, 2, 2, 2).to(
        torch.complex64) for a in (0.3, 0.5, 0.7)]

    def run():
        st, errs = state, []
        for gate in gates:
            st, err = engine.apply_color_group(st, group, gate, 4, 1e-10)
            errs.append(err)
        return st, errs

    g_state, g_errs = run()
    assert len(su_graphs._cache) == 1
    assert (next(iter(su_graphs._cache.values())).calls, len(next(iter(
        su_graphs._cache.values())).stretches)) == (3, 3)
    monkeypatch.setattr(su_graphs, "_capturable", lambda device: False)
    e_state, e_errs = run()
    assert torch.equal(g_state.tensors, e_state.tensors)
    assert torch.equal(g_state.messages, e_state.messages)
    assert all(torch.equal(a, b) for a, b in zip(g_errs, e_errs))


def test_k1_and_k2_are_called_once_per_bucket_on_the_graph_path(
        plain_graphs, monkeypatch):
    """``engine._pseudo_roots`` and ``engine._eigh`` stay eager calls looked
    up on ``engine``: a wrapper put there sees one call of each per update
    (one per colour group, its buckets stacked) in every step, eager,
    capturing or replaying."""
    calls = collections.Counter()
    for name in ("_pseudo_roots", "_eigh"):
        inner = getattr(engine, name)

        def counted(*args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)

        monkeypatch.setattr(engine, name, counted)
    spec, state, layer = _field()
    gen = torch.Generator().manual_seed(11)
    per_step = []
    with profiling.tracing() as handle:
        for _ in range(3):
            calls.clear()
            state, _ = layer(state, *_angles(spec, 1, gen))
            per_step.append(dict(calls))
        counts = _counts(handle)
    nb = _updates(layer)
    assert per_step == [{"_pseudo_roots": nb, "_eigh": nb}] * 3
    assert counts["su.graph.replays"] > 0


@pytest.mark.parametrize("why", ["grad", "cpu", "householder"])
def test_these_routes_take_the_eager_path(fast_stack, monkeypatch, why):
    """Autograd recording through the state, a CPU tensor (the real
    capture check) and the Householder QR (a host read) each run eagerly:
    every call counts ``su.graph.eager``, none captures or replays."""
    spec, state, layer = _field()
    state = _steps(spec, state, layer, 1, 1)[0][0]
    if why != "cpu":
        monkeypatch.setattr(su_graphs, "Capture", _Plain)
        monkeypatch.setattr(su_graphs, "_capturable", lambda device: True)
    if why == "householder":
        monkeypatch.delenv("TNQS_QR_ALG")
    if why == "grad":
        state = state._replace(
            tensors=state.tensors.detach().clone().requires_grad_())
    group = spec.color_groups[0]
    gate = par.rot2("ZZ", torch.tensor(0.4)).reshape(2, 2, 2, 2).to(
        torch.complex64)
    with profiling.tracing() as handle:
        for _ in range(3):
            out, _err = engine.apply_color_group(state, group, gate, 4, 1e-10)
        counts = _counts(handle)
    assert counts == {"su.graph.captures": 0, "su.graph.replays": 0,
                      "su.graph.eager": 3, "su.graph.evictions": 0}
    assert not su_graphs._cache
    if why == "grad":
        assert out.tensors.grad_fn is not None


def _keys(members, chi=4, seed=5):
    su_graphs._cache.clear()
    spec, state, layer = _field(chi=chi)
    _steps(spec, state, layer, members, 2, seed=seed)
    return set(su_graphs._cache)


def _per_member(key, members):
    """``key`` with each bucket's rows and the gate's leading axis divided
    by ``members`` (each a multiple of it)."""
    buckets, gate_shape = key[4], key[5]
    assert all(rows % members == 0 for _, _, rows in buckets)
    assert gate_shape[0] % members == 0
    return key[:4] + (tuple((su, sv, rows // members)
                            for su, sv, rows in buckets),
                      (gate_shape[0] // members,) + gate_shape[1:]) + key[6:]


def test_the_key_changes_with_chi_members_and_slot_pair_only(plain_graphs):
    """The cells' traffic changes angles (one hx per experiment; per-site hx
    and per-edge J per member) and restarts from the initial state: none of
    that changes a key.  χ, the ensemble size and the slot pair do."""
    one, one_again = _keys(1), _keys(1, seed=99)
    three, three_again = _keys(3), _keys(3, seed=99)
    assert one == one_again and three == three_again
    # E enters through the rows alone: per member, the folded ensemble's
    # keys are the single run's.  (A 3-edge bucket of one member can share
    # its key with a 1-edge bucket of three: same shapes, same graphs.)
    assert one != three
    assert {_per_member(k, 3) for k in three} == {_per_member(k, 1)
                                                  for k in one}
    assert not one & _keys(1, chi=5)
    spec, state, _layer = _field()
    gate = torch.zeros(2, 2, 2, 2, dtype=torch.complex64)
    u, v = torch.tensor([0, 3]), torch.tensor([1, 4])

    def key(su, sv, u_idx, v_idx):
        return su_graphs._key(state, [(su, sv, u_idx, v_idx)], gate, 4, 1e-10,
                              True)

    assert key(0, 2, u, v) == key(0, 2, torch.tensor([6, 7]),
                                  torch.tensor([8, 5]))
    assert key(0, 2, u, v) != key(1, 3, u, v)
    assert key(0, 2, u, v) != key(0, 2, u[:1], v[:1])


def test_the_cache_drops_its_least_recent_key(plain_graphs, monkeypatch):
    """At most ``MAX_KEYS`` keys; the least recently used goes, counted."""
    monkeypatch.setattr(su_graphs, "MAX_KEYS", 2)
    spec, state, layer = _field()
    with profiling.tracing() as handle:
        _steps(spec, state, layer, 1, 2)
        counts = _counts(handle)
    assert len(su_graphs._cache) == 2
    assert counts["su.graph.evictions"] > 0


class _Refused:
    """A capture that raises, as one refused by the card would."""

    def __init__(self, device):
        pass

    def __call__(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


def test_a_refused_capture_leaves_its_key_eager_and_warns(
        plain_graphs, monkeypatch):
    """The update that tried to capture still returns the eager result; the
    key stays eager from then on, each call counted, with one warning."""
    monkeypatch.setattr(su_graphs, "Capture", _Refused)
    spec, state, layer = _field()
    group = spec.color_groups[0][:1]
    gate = par.rot2("ZZ", torch.tensor(0.4)).reshape(2, 2, 2, 2).to(
        torch.complex64)
    outs = []
    with profiling.tracing() as handle:
        with pytest.warns(RuntimeWarning, match="capture failed") as seen:
            for _ in range(4):
                outs.append(engine.apply_color_group(state, group, gate, 4,
                                                     1e-10))
        counts = _counts(handle)
    assert len(seen) == 1
    assert counts == {"su.graph.captures": 0, "su.graph.replays": 0,
                      "su.graph.eager": 4, "su.graph.evictions": 0}
    (entry,) = su_graphs._cache.values()
    assert entry.failed and not entry.stretches
    for out, err in outs[1:]:
        assert torch.equal(out.tensors, outs[0][0].tensors)
        assert torch.equal(err, outs[0][1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_CARD = "needs a CUDA card: the graphs capture only there"


def _quench(members, experiments, eager, monkeypatch):
    """⟨Z⟩ [steps, E, V] of a 5×5 χ=10 complex64 TFIM quench (hx per
    experiment, hz = 0.8, J = 0.5, dt = 0.25, 20 steps from |0…0⟩), and
    the counters of each step."""
    monkeypatch.setattr(su_graphs, "_capturable",
                        (lambda device: False) if eager
                        else su_graphs._capturable)
    spec, state0, layer = _field(chi=10, dims=(5, 5), device="cuda",
                                 bp_maxiter=25, bp_tolerance=1e-5)
    run = layer if members == 1 else par.ensemble_fn(layer)
    if members > 1:
        state0 = par.stack_states([state0] * members)
    V, Eb = spec.num_vertices, len(spec.edges)
    gen = torch.Generator().manual_seed(31)
    zs, counts = [], []
    for _ in range(experiments):
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
                counts.append(_counts(handle))
            z = par.local_expectations(spec, engine.fold_members(state)
                                       if members > 1 else state, _Z)
            zs.append(z.real.reshape(members, V).cpu())
    return torch.stack(zs), counts, _updates(layer)


@pytest.mark.card
@pytest.mark.parametrize("members", [1, 4])
def test_replayed_quench_matches_the_eager_path_on_the_card(
        fast_stack, monkeypatch, members):
    """Two 20-step experiments, a new hx each (per member for E = 4): ⟨Z⟩
    of the replayed layer within 1e-6 of the eager layer's; captures (3 per
    key) only in the first two steps, then 3 replays per update a step."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    z_graph, counts, nb = _quench(members, 2, False, monkeypatch)
    keys = len(su_graphs._cache)
    z_eager, _, _ = _quench(members, 2, True, monkeypatch)
    print(f"max |dZ| E={members}: "
          f"{float((z_graph - z_eager).abs().max()):.3e}")
    assert float((z_graph - z_eager).abs().max()) <= 1e-6
    assert 1 <= keys <= nb
    assert sum(c["su.graph.captures"] for c in counts[:2]) == 3 * keys
    assert all(c == {"su.graph.captures": 0, "su.graph.replays": 3 * nb,
                     "su.graph.eager": 0, "su.graph.evictions": 0}
               for c in counts[2:])


@pytest.mark.card
def test_a_kept_state_is_not_overwritten_by_later_replays(fast_stack):
    """The layer's outputs never alias a graph's memory: a state kept from
    step k reads the same after steps k+1 and k+2."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    spec, state, layer = _field(chi=10, dims=(5, 5), device="cuda")
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):  # eager, capture, replay
        state, err = layer(state, *_angles(spec, 1, gen, "cuda"))
    kept = (state.tensors.clone(), state.messages.clone(), err.clone())
    later = state
    for _ in range(2):
        later, _ = layer(later, *_angles(spec, 1, gen, "cuda"))
    assert su_graphs._cache and all(
        len(e.stretches) == 3 for e in su_graphs._cache.values())
    assert torch.equal(state.tensors, kept[0])
    assert torch.equal(state.messages, kept[1])
    assert torch.equal(err, kept[2])


@pytest.mark.card
def test_the_graphs_capture_again_after_every_key_is_dropped(fast_stack,
                                                            monkeypatch):
    """Emptying the cache drops every key's graphs; the next captures share
    the same pool and succeed (no key falls back to the eager path), and
    the replayed layer still equals the eager one."""
    if not torch.cuda.is_available():
        pytest.skip(_CARD)
    set_default_device("cuda")
    spec, state0, layer = _field(chi=10, dims=(5, 5), device="cuda")
    gen = torch.Generator().manual_seed(4)
    angles = [_angles(spec, 1, gen, "cuda") for _ in range(3)]

    def three_steps():
        state = state0
        for site, bond in angles:  # eager, capture, replay
            state, _ = layer(state, site, bond)
        return state

    three_steps()
    pool = su_graphs._captures[torch.device("cuda", 0)].pool
    su_graphs._cache.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        with profiling.tracing() as handle:
            graphs = three_steps()
            counts = _counts(handle)
    keys = len(su_graphs._cache)
    assert su_graphs._captures[torch.device("cuda", 0)].pool == pool
    assert all(len(e.stretches) == 3 and not e.failed
               for e in su_graphs._cache.values())
    assert counts["su.graph.captures"] == 3 * keys
    monkeypatch.setattr(su_graphs, "_capturable", lambda device: False)
    eager = three_steps()
    z_graphs, z_eager = (par.local_expectations(spec, s, _Z).real.cpu()
                         for s in (graphs, eager))
    assert float((z_graphs - z_eager).abs().max()) <= 1e-6
