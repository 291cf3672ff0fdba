"""PyTorch port, the generic engine's loop corrections
(``engines/loopcorrection.py``, the "loopcorrections" branches of
``measure.py``) and BP diagnostics (``engines/diagnostics.py``) against the
JAX package on states carried across as plain data: loop-corrected Z,
⟨ψ|ϕ⟩ and ⟨O⟩ at configuration sizes 3-6, the series exact on a single
loop, the triangular lattice, and ``loop_correlation(s)``.  Bars: 1e-10
in complex128 (relative for partition functions), 1e-4 in complex64."""

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
_CONV = dict(cache_update_kwargs=dict(maxiter=500, tolerance=1e-16))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


@pytest.mark.parametrize("dtype,tol", [(jnp.complex128, 1e-10),
                                       (jnp.complex64, 1e-4)])
@pytest.mark.parametrize("shape,size", [((2, 3), 4), ((2, 3), 6)])
def test_partition_function_and_expect(dtype, tol, shape, size):
    """2×3 χ=2: Z with loops (through ``norm_sqr`` and
    ``loopcorrected_partitionfunction`` on a cache), ⟨ψ|ϕ⟩, and ⟨O⟩ for
    one- and two-site observables."""
    psi_j, psi_t = pair(dtype, shape=shape, seed=size)
    kw = dict(max_configuration_size=size)
    np.testing.assert_allclose(
        tt.norm_sqr(psi_t, alg="loopcorrections", **kw),
        tnqs.norm_sqr(psi_j, alg="loopcorrections", **kw), rtol=tol)
    ct = tt.BeliefPropagationCache(psi_t).update()
    cj = tnqs.BeliefPropagationCache(psi_j).update()
    np.testing.assert_allclose(tt.loopcorrected_partitionfunction(ct, size),
                               tnqs.loopcorrected_partitionfunction(cj, size),
                               rtol=tol)
    phi_j = psi_j.map_virtualinds(lambda i: i.sim()).map_tensors(
        lambda t: t * 1.1)
    phi_t = state_from_numpy(plain(phi_j))
    np.testing.assert_allclose(
        tt.inner(psi_t, phi_t, alg="loopcorrections", **kw),
        tnqs.inner(psi_j, phi_j, alg="loopcorrections", **kw), rtol=tol)
    obs = [("Z", [(2, 2)]), ("XX", [(1, 1), (1, 2)], 0.5), ("Y", [(2, 1)])]
    np.testing.assert_allclose(
        tt.expect(psi_t, obs, alg="loopcorrections", **kw),
        tnqs.expect(psi_j, obs, alg="loopcorrections", **kw), atol=tol)


def test_exact_on_a_single_loop():
    """2×2 χ=3: the size-4 series is the whole contraction, for the norm
    and for ⟨Z⟩ (also through ``expect_loopcorrect``)."""
    psi_j, psi_t = pair(jnp.complex128, shape=(2, 2), bond=3, seed=21)
    obs = ("Z", [(1, 1)])
    got = tt.expect(psi_t, obs, alg="loopcorrections",
                    max_configuration_size=4, **_CONV)
    np.testing.assert_allclose(complex(got),
                               complex(tt.expect(psi_t, obs, alg="exact")),
                               rtol=1e-8)
    np.testing.assert_allclose(
        complex(tt.expect_loopcorrect(psi_t, obs, max_configuration_size=4,
                                      **_CONV)), complex(got), rtol=1e-12)
    np.testing.assert_allclose(
        tt.norm_sqr(psi_t, alg="loopcorrections", max_configuration_size=4,
                    **_CONV),
        tt.norm_sqr(psi_t, alg="exact"), rtol=1e-8)


def test_triangular_lattice():
    """3×3 triangular patch (triangles are the shortest loops; 8 of them
    at size 3): the size-3 series against JAX."""
    g = j_lat.triangular_lattice(3, 3)
    assert len(tt.utils.edgeinduced_subgraphs_no_leaves(
        tt.triangular_lattice(3, 3), 3)) == 8
    psi_j, psi_t = pair(jnp.complex128, graph=g, seed=7)
    psi_t = tt.normalize(psi_t, alg="bp")
    psi_j = tnqs.normalize(psi_j, alg="bp")
    kw = dict(max_configuration_size=3)
    np.testing.assert_allclose(
        tt.norm_sqr(psi_t, alg="loopcorrections", **kw),
        tnqs.norm_sqr(psi_j, alg="loopcorrections", **kw), rtol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(jnp.complex128, 1e-10),
                                       (jnp.complex64, 1e-4)])
def test_loop_correlations(dtype, tol):
    """The four plaquettes of a 3×3 grid and the hexagons of a 2×2
    honeycomb: one correlation per loop, as JAX computes them, each in
    [0, 1]; a tree has none."""
    for g, size in ((j_lat.named_grid((3, 3)), 4),
                    (j_lat.named_hexagonal_lattice_graph(2, 2), 6)):
        psi_j, psi_t = pair(dtype, graph=g, seed=3)
        got = tt.loop_correlations(psi_t, size)
        ref = tnqs.loop_correlations(psi_j, size)
        assert len(got) == len(ref) > 0
        np.testing.assert_allclose(got, ref, atol=tol)
        assert all(0 <= c <= 1 for c in got)
    tree_j, tree_t = pair(dtype, graph=j_lat.named_comb_tree((3, 3)))
    assert tt.loop_correlations(tree_t, 4) == [] == tnqs.loop_correlations(
        tree_j, 4)
    # one loop by hand, on a cache
    ct = tt.BeliefPropagationCache(psi_t).update()
    cj = tnqs.BeliefPropagationCache(psi_j).update()
    from tensornetworkquantumsimulator_torch.utils.graphs import (
        cycle_to_path, unique_simplecycles_limited_length)
    cyc = unique_simplecycles_limited_length(ct.graph(), 6)[0]
    path = cycle_to_path(cyc)
    from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
    path_j = j_graphs.cycle_to_path(cyc)
    np.testing.assert_allclose(
        tt.loop_correlation(ct, path[:-1], path[-1].reverse()),
        tnqs.loop_correlation(cj, path_j[:-1], path_j[-1].reverse()),
        atol=tol)
