"""PyTorch port, the generic engine's samplers (``sampling.py``) against
the JAX package: the BP sampler, the boundary-MPS sampler with its p/q
(``sample_directly_certified``), ``sample_certified`` and the
density-matrix sampler.  The JAX sampler draws; its bitstrings are forced
on the port through the port's draw hook (``sampling._draw``), and every
conditional distribution offered, ``logq``, ``poverq`` and ``logp`` are
compared, to 1e-8 in complex128.  ``logq`` of full-rank boundary-MPS
sampling is also held to the dense state, and GHZ and product states to
their known samples."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import sampling as t_sampling
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.models import state_from_numpy
from tensornetworkquantumsimulator_tpu import sampling as j_sampling
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

from generic_carry import pair, plain

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


class _Recorder:
    """Stands in for JAX's ``_sample_weights``: draws as it does, and keeps
    each distribution offered and each outcome."""

    def __init__(self, orig):
        self.orig, self.probs, self.draws = orig, [], []

    def __call__(self, probs):
        self.probs.append(np.asarray(probs, dtype=np.float64))
        self.draws.append(self.orig(probs))
        return self.draws[-1]


class _Forced:
    """Stands in for the port's ``_draw``: hands out the given outcomes in
    call order and keeps each distribution offered."""

    def __init__(self, draws):
        self.draws, self.probs = list(draws), []

    def __call__(self, probs, generator=None):
        self.probs.append(np.asarray(probs))
        return self.draws[len(self.probs) - 1]


def _both(monkeypatch, run_j, run_t):
    """Run the JAX sampler, then the port's on JAX's draws."""
    rec = _Recorder(j_sampling._sample_weights)
    monkeypatch.setattr(j_sampling, "_sample_weights", rec)
    j_sampling.seed_sampler(3)
    out_j = run_j()
    forced = _Forced(rec.draws)
    monkeypatch.setattr(t_sampling, "_draw", forced)
    out_t = run_t()
    assert len(forced.probs) == len(rec.probs) > 0
    for pt, pj in zip(forced.probs, rec.probs):
        np.testing.assert_allclose(pt, pj / pj.sum(), atol=1e-8)
    return out_j, out_t


def test_bp_sampler(monkeypatch):
    """3×3 χ=2, 3 samples: the BP sampler's conditionals at every vertex."""
    psi_j, psi_t = pair(jnp.complex128, seed=1)
    out_j, out_t = _both(monkeypatch,
                         lambda: tnqs.sample(psi_j, 3, alg="bp"),
                         lambda: tt.sample(psi_t, 3, alg="bp"))
    assert out_t == out_j


@pytest.mark.parametrize("ranks", [(1, 2), (2, 4), (4, 16)])
def test_boundarymps_sampler_logq_poverq(monkeypatch, ranks):
    """3×3 χ=2 (row partitions), 2 samples at projected/norm ranks:
    bitstrings, ``logq`` and ``poverq``; ``sample_certified`` re-contracts
    the same samples."""
    proj, norm = ranks
    psi_j, psi_t = pair(jnp.complex128, seed=2)
    kw = dict(alg="boundarymps", projected_mps_bond_dimension=proj,
              norm_mps_bond_dimension=norm)
    out_j, out_t = _both(
        monkeypatch, lambda: tnqs.sample_directly_certified(psi_j, 2, **kw),
        lambda: tt.sample_directly_certified(psi_t, 2, **kw))
    for a, b in zip(out_t, out_j):
        assert a["bitstring"] == b["bitstring"]
        np.testing.assert_allclose(a["logq"], b["logq"], atol=1e-8)
        np.testing.assert_allclose(a["poverq"], b["poverq"], rtol=1e-8)
    ckw = dict(kw, certification_mps_bond_dimension=norm)
    out_j, out_t = _both(monkeypatch,
                         lambda: tnqs.sample_certified(psi_j, 2, **ckw),
                         lambda: tt.sample_certified(psi_t, 2, **ckw))
    for a, b in zip(out_t, out_j):
        assert a["bitstring"] == b["bitstring"]
        np.testing.assert_allclose(a["poverq"], b["poverq"], rtol=1e-8)


def test_boundarymps_logq_against_the_dense_state():
    """At full rank q is the state's own distribution: logq equals
    log |⟨x|ψ⟩|²/⟨ψ|ψ⟩ from the exact contraction."""
    psi_j, psi_t = pair(jnp.complex128, shape=(3, 3), seed=4)
    out = tt.sample_directly_certified(
        psi_t, 3, alg="boundarymps", projected_mps_bond_dimension=16,
        norm_mps_bond_dimension=16, generator=torch.Generator().manual_seed(1))
    nrm = tt.norm_sqr(psi_t, alg="exact")
    s = psi_t.siteinds()
    for r in out:
        amp = tt.TensorNetwork({
            v: psi_t[v] * tt.Tensor(torch.eye(2, dtype=torch.complex128)[
                r["bitstring"][v]], (s[v][0],))
            for v in psi_t.vertices()}, psi_t.graph().copy())
        p = abs(tt.contract(amp, alg="exact")) ** 2 / np.real(nrm)
        np.testing.assert_allclose(r["logq"], np.log(p), atol=1e-8)


def test_density_matrix_sampler(monkeypatch):
    """A 2×2 noisy density matrix (d=4): the conditionals and ``logp`` of
    3 samples."""
    gj = j_lat.named_grid((2, 2))
    rho_j = tnqs.density_matrix_tensornetworkstate(jnp.complex128,
                                                   lambda v: "+", gj)
    circ = [("Ry", [v], 0.7) for v in gj.vertices()]
    circ += [("Rzz", [e.src, e.dst], 0.4) for e in gj.edges()]
    circ += [("amplitude_damping", [v], 0.2) for v in gj.vertices()]
    rho_j, _ = tnqs.apply_circuit(circ, rho_j, apply_kwargs=dict(maxdim=4))
    rho_t = state_from_numpy(plain(rho_j))
    out_j, out_t = _both(monkeypatch,
                         lambda: tnqs.sample_density_matrix(rho_j, 3),
                         lambda: tt.sample_density_matrix(rho_t, 3))
    for a, b in zip(out_t, out_j):
        assert a["bitstring"] == b["bitstring"]
        np.testing.assert_allclose(a["logp"], b["logp"], atol=1e-8)


def test_known_samples_and_generator():
    """A product state samples all 0 (both samplers); a GHZ state all-0 or
    all-1; one generator seed gives one sequence; a density matrix refuses
    the wavefunction samplers."""
    g = tt.named_hexagonal_lattice_graph(2, 2)
    psi = tt.gauge_and_scale(tt.tensornetworkstate(torch.complex128,
                                                   lambda v: "↑", g))
    for alg, kw in (("bp", {}), ("boundarymps", dict(
            norm_mps_bond_dimension=1, projected_mps_bond_dimension=1))):
        (b,) = tt.sample(psi, 1, alg=alg, gauge_state=False, **kw)
        assert set(b.values()) == {0}
    g = tt.named_grid((3, 3))
    s = tt.siteinds("S=1/2", g)
    ghz = tt.gauge_and_scale(
        tt.tensornetworkstate(torch.float64, lambda v: "↑", g, s)
        + tt.tensornetworkstate(torch.float64, lambda v: "↓", g, s))
    runs = [tt.sample(ghz, 6, alg="bp", gauge_state=False,
                      generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(set(b.values()) in ({0}, {1}) for b in runs[0])
    rho = tt.density_matrix_tensornetworkstate(torch.float64,
                                               lambda v: "+", g)
    with pytest.raises(ValueError, match="sample_density_matrix"):
        tt.sample(rho, 1, alg="bp")
