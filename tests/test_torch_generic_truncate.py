"""PyTorch port, ``truncate.py`` (bond truncation as identity gates, "bp"
and "boundarymps") against the JAX package on states carried across as
plain data.  The truncated states carry a gauge of their own, so each is
compared through gauge-free numbers: its fidelity with the untruncated
state, its exact norm and ⟨Z⟩, ⟨X⟩, and its bond dimensions.  Bars 1e-8 in
complex128, 1e-4 in complex64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.models import state_from_numpy
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

from generic_carry import pair, plain

torch.set_num_threads(1)
DTYPES = [(jnp.complex128, 1e-8), (jnp.complex64, 1e-4)]


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _readout(pkg, phi, psi):
    """Fidelity with ``psi``, exact norm², ⟨Z⟩ and ⟨X⟩ at two sites."""
    ip = pkg.inner(phi, psi, alg="exact")
    f = ip / np.sqrt(abs(pkg.norm_sqr(phi, alg="exact"))
                     * abs(pkg.norm_sqr(psi, alg="exact")))
    v = phi.vertices()
    obs = [("Z", [v[0]]), ("X", [v[-1]])]
    return np.concatenate([[abs(f) ** 2], np.real(pkg.expect(phi, obs,
                                                             alg="exact"))])


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_truncate_bp_and_boundarymps(dtype, tol):
    """The 2×2 honeycomb at χ=3 cut to χ=2, by BP (edge groups and single
    edges, on a state and on a cache) and by the boundary MPS (rank 9)."""
    g = j_lat.named_hexagonal_lattice_graph(2, 2)
    psi_j, _ = pair(dtype, graph=g, bond=3, seed=5)
    psi_j = tnqs.gauge_and_scale(psi_j)
    psi_t = state_from_numpy(plain(psi_j))
    kw = dict(maxdim=2, cutoff=1e-10, normalize_tensors=False)
    runs = [
        (lambda p: tnqs.truncate(p, alg="bp", **kw),
         lambda p: tt.truncate(p, alg="bp", **kw)),
        (lambda p: tnqs.truncate(tnqs.BeliefPropagationCache(p).update(),
                                 use_edge_color=False, **kw).network(),
         lambda p: tt.truncate(tt.BeliefPropagationCache(p).update(),
                               use_edge_color=False, **kw).network()),
        (lambda p: tnqs.truncate(p, alg="boundarymps", gauge_state=False,
                                 mps_bond_dimension=9, **kw),
         lambda p: tt.truncate(p, alg="boundarymps", gauge_state=False,
                               mps_bond_dimension=9, **kw)),
    ]
    fids = []
    for run_j, run_t in runs:
        phi_j, phi_t = run_j(psi_j), run_t(psi_t)
        assert phi_t.maxvirtualdim() == phi_j.maxvirtualdim() == 2
        got = _readout(tt, phi_t, psi_t)
        np.testing.assert_allclose(got, _readout(tnqs, phi_j, psi_j),
                                   atol=tol)
        fids.append(got[0])
    assert all(0 < f <= 1 + 1e-6 for f in fids)
    assert fids[2] >= fids[0] - 1e-6  # the boundary MPS sees the loops


def test_truncate_rejects_unknown():
    _, psi_t = pair(jnp.complex128, shape=(2, 2))
    with pytest.raises(ValueError):
        tt.truncate(psi_t, alg="nonsense", maxdim=1)
