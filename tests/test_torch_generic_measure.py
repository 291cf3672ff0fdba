"""PyTorch port, the generic engine's measurements (``measure.py``,
``gauge.py``) against the JAX package on states carried across as plain
data: ``expect``, ``norm``/``norm_sqr``, ``inner``, ``pauli_expectation``,
``heisenberg_expectation``, ``purity`` and ``rdm`` with the "exact" and "bp"
backends; ``normalize``, the symmetric gauge and ``entanglement``; BP ⟨Z⟩
on the 3×3 TFIM against the dense-statevector oracle; and the
"boundarymps" and "loopcorrections" backends on the same states."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.models import state_from_numpy
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

sys.path.insert(0, str(Path(__file__).resolve().parent))
from dense_oracle import dense_z_trajectory  # noqa: E402

torch.set_num_threads(1)
_BP = dict(cache_update_kwargs=dict(maxiter=80, tolerance=1e-14))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _plain(j):
    """A JAX network as the port's plain form (``state_to_numpy``)."""
    def ind(i):
        return (i.id, i.dim, tuple(i.tags), i.plev)

    out = {"vertices": list(j.vertices()),
           "edges": [(e.src, e.dst) for e in j.edges()],
           "tensors": {v: (np.asarray(j[v].data), [ind(i) for i in j[v].inds])
                       for v in j.vertices()}}
    if type(j).__name__ == "TensorNetworkState":
        out["siteinds"] = {v: [ind(i) for i in s]
                           for v, s in j.siteinds().items()}
    return out


def _pair(dtype_j=jnp.complex128, bond=2, seed=0, shape=(3, 3)):
    g = j_lat.named_grid(shape)
    psi_j = tnqs.random_tensornetworkstate(dtype_j, g, bond_dimension=bond,
                                           key=jax.random.PRNGKey(seed))
    return psi_j, state_from_numpy(_plain(psi_j))


OBS = [("Z", [(2, 2)]), ("X", [(1, 1)], 0.5), ("ZZ", [(1, 1), (1, 2)]),
       ("XY", [(2, 1), (3, 3)]), (["Y", "Z"], [(3, 1), (3, 2)], -1.0)]


@pytest.mark.parametrize("alg", ["exact", "bp"])
@pytest.mark.parametrize("dtype_j,tol", [(jnp.complex128, 1e-10),
                                         (jnp.complex64, 1e-5)])
def test_expect_norm_inner(alg, dtype_j, tol):
    psi_j, psi_t = _pair(dtype_j)
    kw = _BP if alg == "bp" else {}
    np.testing.assert_allclose(tt.expect(psi_t, OBS, alg=alg, **kw),
                               tnqs.expect(psi_j, OBS, alg=alg, **kw),
                               atol=tol * 10)
    for f in ("norm_sqr", "norm"):
        np.testing.assert_allclose(getattr(tt, f)(psi_t, alg=alg, **kw),
                                   getattr(tnqs, f)(psi_j, alg=alg, **kw),
                                   rtol=tol * 10)
    same_j = tnqs.TensorNetworkState(psi_j.tensornetwork().copy()
                                     .map_tensors_inplace(lambda t: t * 1.5),
                                     psi_j.siteinds())
    same_t = state_from_numpy(_plain(same_j))
    ikw = dict(cache_update_kwargs=dict(maxiter=80, tolerance=1e-14)) \
        if alg == "bp" else {}
    np.testing.assert_allclose(tt.inner(psi_t, same_t, alg=alg, **ikw),
                               tnqs.inner(psi_j, same_j, alg=alg, **ikw),
                               rtol=tol * 10)


def test_expect_on_a_cache_and_coefficients():
    psi_j, psi_t = _pair()
    cj = tnqs.BeliefPropagationCache(psi_j).update(maxiter=80, tolerance=1e-14)
    ct = tt.BeliefPropagationCache(psi_t).update(maxiter=80, tolerance=1e-14)
    np.testing.assert_allclose(tt.expect(ct, OBS), tnqs.expect(cj, OBS),
                               atol=1e-10)
    assert tt.expect(ct, ("Z", [(1, 1)], 0)) == 0
    np.testing.assert_allclose(tt.norm_sqr(ct), tnqs.norm_sqr(cj), rtol=1e-10)


@pytest.mark.parametrize("alg", ["exact", "bp"])
def test_rdm_matches_jax(alg):
    psi_j, psi_t = _pair()
    kw = _BP if alg == "bp" else {}
    for verts in ([(2, 2)], [(1, 1), (1, 2)], [(1, 1), (2, 2)]):
        rj = tnqs.rdm(psi_j, verts, alg=alg, **dict(kw))
        rt = tt.rdm(psi_t, verts, alg=alg, **dict(kw))
        pos = {(i.id, i.plev): k for k, i in enumerate(rt.inds)}
        got = np.transpose(rt.numpy(), [pos[(i.id, i.plev)] for i in rj.inds])
        np.testing.assert_allclose(got, np.asarray(rj.data), atol=1e-10)
        np.testing.assert_allclose(tt.ops.trace(rt), 1.0, atol=1e-12)
    raw = tt.rdm(psi_t, [(2, 2)], alg=alg, normalize=False, **dict(kw))
    np.testing.assert_allclose(tt.ops.trace(tt.measure.normalize_rdm(raw)),
                               1.0, atol=1e-12)


@pytest.mark.parametrize("alg", ["exact", "bp"])
def test_pauli_pictures_match_jax(alg):
    """A noisy density-matrix state (``pauli_expectation``, ``purity``) and
    an evolved Heisenberg operator (``heisenberg_expectation``)."""
    g = j_lat.named_grid((2, 3))
    rho_j = tnqs.density_matrix_tensornetworkstate(
        jnp.complex128, lambda v: "+" if v[1] % 2 else "y+", g)
    circ = [("Rx", [v], 0.3) for v in g.vertices()]
    circ += [("Rzz", [e.src, e.dst], 0.5) for e in g.edges()]
    circ += [("depolarizing", [v], 0.05) for v in g.vertices()]
    ak = dict(apply_kwargs=dict(maxdim=4, cutoff=1e-12,
                                normalize_tensors=False))
    rho_j, _ = tnqs.apply_circuit(circ, rho_j, **ak)
    rho_t = state_from_numpy(_plain(rho_j))
    obs = [("Z", [(1, 1)]), ("X", [(2, 3)]), ("ZZ", [(1, 1), (2, 1)]),
           ("Y", [(1, 2)], 2.0)]
    np.testing.assert_allclose(tt.pauli_expectation(rho_t, obs, alg=alg),
                               tnqs.pauli_expectation(rho_j, obs, alg=alg),
                               atol=1e-10)
    # expect routes a density-matrix network to the linear functional
    np.testing.assert_allclose(tt.expect(rho_t, obs, alg=alg),
                               tnqs.expect(rho_j, obs, alg=alg), atol=1e-10)
    np.testing.assert_allclose(tt.purity(rho_t, alg=alg),
                               tnqs.purity(rho_j, alg=alg), rtol=1e-10)

    op_j = tnqs.paulitensornetworkstate(jnp.float64,
                                        lambda v: "Z" if v == (1, 2) else "I",
                                        g)
    hcirc = [("Rx", [v], 0.2) for v in g.vertices()]
    hcirc += [("Rzz", [e.src, e.dst], 0.4) for e in g.edges()]
    op_j, _ = tnqs.apply_circuit(list(reversed(hcirc)), op_j, **ak)
    op_t = state_from_numpy(_plain(op_j))
    for init in ("0", "+", lambda v: "0" if v[0] == 1 else "1"):
        np.testing.assert_allclose(
            tt.heisenberg_expectation(op_t, init, alg=alg),
            tnqs.heisenberg_expectation(op_j, init, alg=alg), rtol=1e-10)


def test_normalize_gauge_and_entanglement():
    psi_j, psi_t = _pair(bond=3, seed=5)
    nj, nt = tnqs.normalize(psi_j, alg="bp"), tt.normalize(psi_t, alg="bp")
    np.testing.assert_allclose(tt.norm_sqr(nt, alg="bp"), 1.0, rtol=1e-10)
    np.testing.assert_allclose(tt.norm_sqr(nt, alg="exact"),
                               tnqs.norm_sqr(nj, alg="exact"), rtol=1e-8)
    # the symmetric gauge keeps every BP observable
    gt = tt.symmetric_gauge(psi_t)
    z0 = tt.expect(psi_t, OBS, alg="bp", **_BP)
    np.testing.assert_allclose(tt.expect(gt, OBS, alg="bp", **_BP), z0,
                               atol=1e-8)
    sj, st = tnqs.gauge_and_scale(psi_j), tt.gauge_and_scale(psi_t)
    np.testing.assert_allclose(tt.norm_sqr(st, alg="bp"),
                               tnqs.norm_sqr(sj, alg="bp"), rtol=1e-8)
    for e in list(psi_j.edges())[:4]:
        ej = type(e)(e.src, e.dst)
        et = tt.NamedEdge(e.src, e.dst)
        np.testing.assert_allclose(
            tt.entanglement(psi_t, et, alg="bp"),
            tnqs.entanglement(psi_j, ej, alg="bp"), rtol=1e-8, atol=1e-12)


def _tfim(g, dt=0.25, hx=1.0, hz=0.8, J=0.5):
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for ce in tt.edge_color(g, 4):
        layer += [("Rzz", [p.src, p.dst], 2 * J * dt) for p in ce]
    return layer


def test_bp_z_against_dense_oracle():
    """3×3 TFIM, χ=8 with no cutoff, complex128, three layers: BP ⟨Z⟩ at
    the centre within 1e-4 of the dense statevector, layer by layer."""
    g = tt.named_grid((3, 3))
    layer = _tfim(g)
    golden = dense_z_trajectory(g, layer, 3, (2, 2))
    psi = tt.zerostate(torch.complex128, g)
    traj = []
    for _ in range(3):
        psi, _ = tt.apply_circuit(
            layer, psi, apply_kwargs=dict(maxdim=8, normalize_tensors=False),
            bp_update_kwargs=dict(maxiter=100, tolerance=1e-14))
        traj.append(float(np.real(tt.expect(psi, ("Z", [(2, 2)]), alg="bp",
                                            **_BP))))
    assert np.abs(np.array(traj) - np.array(golden)).max() <= 1e-4, (
        traj, golden)


@pytest.mark.parametrize("alg", ["boundarymps", "loopcorrections"])
def test_unported_backends_raise(alg):
    """The backends the first half of the engine left out now answer, as
    JAX does on the same state (they raised ``NotImplementedError`` until
    they were ported); an unknown backend still raises ``ValueError``."""
    psi_j, psi_t = _pair(shape=(2, 3))
    # ϕ: ψ on bonds of its own (the loop series of both packages needs
    # the bra's bonds apart from the ket's), scaled, so ⟨ψ|ϕ⟩ = 1.5⟨ψ|ψ⟩
    # and BP converges on it as on the norm network
    phi_j = psi_j.map_virtualinds(lambda i: i.sim()).map_tensors(
        lambda t: t * 1.5 ** (1 / 6))
    phi_t = state_from_numpy(_plain(phi_j))
    kw = dict(mps_bond_dimension=4, max_configuration_size=4)
    calls = ["expect", "norm_sqr", "norm", "inner"]
    if alg == "boundarymps":
        calls.append("rdm")
    for name in calls:
        args_j = {"expect": ([("Z", [(1, 1)]), ("XX", [(2, 1), (2, 2)])],),
                  "inner": (phi_j,), "rdm": ([(1, 1)],)}.get(name, ())
        args_t = tuple(phi_t if a is phi_j else a for a in args_j)
        got = getattr(tt, name)(psi_t, *args_t, alg=alg, **kw)
        ref = getattr(tnqs, name)(psi_j, *args_j, alg=alg, **kw)
        if name == "rdm":
            got, ref = got.numpy(), np.asarray(ref.data)
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        tt.expect(psi_t, ("Z", [(1, 1)]), alg="nonsense")


@pytest.mark.parametrize("alg", ["exact", "bp"])
def test_complex_operator_on_a_real_state(alg):
    """⟨YY⟩ on a real float64 state.  The JAX package casts Y to float64 and
    loses its imaginary part (it reads 0 there); the port keeps Y complex
    and agrees with JAX on the same state cast to complex128."""
    psi_j, psi_t = _pair(jnp.float64, seed=2)
    obs = [("YY", [(1, 1), (1, 2)]), ("Y", [(2, 2)]), ("XZ", [(1, 1), (2, 1)])]
    kw = _BP if alg == "bp" else {}
    ref = tnqs.expect(psi_j.astype(jnp.complex128), obs, alg=alg, **kw)
    got = tt.expect(psi_t, obs, alg=alg, **kw)
    np.testing.assert_allclose(got, ref, atol=1e-10)
    assert abs(ref[0]) > 1e-3  # the value the cast would lose
