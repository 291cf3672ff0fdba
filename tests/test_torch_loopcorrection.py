"""PyTorch port, loop corrections to BP (``parallel/loopcorrection.py``)
against the JAX package on the same numpy inputs.

The states come from ``measure_states.converged``: one seeded random PEPS
per lattice at the BP fixed point, handed to both packages.  The host
tables of ``LoopConfigurations`` must equal the JAX ones array for array;
the weights, Z and ⟨O⟩ must agree to 1e-8 in complex128 (1e-10 for the
scalars) and to 1e-4 in complex64 against the complex128 reference.  The
2×2 grid's single loop is exact, checked against the dense state."""

import functools
import shutil

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel import loopcorrection as tl
from tensornetworkquantumsimulator_torch.utils import graphs as t_graphs
from tensornetworkquantumsimulator_tpu.parallel import loopcorrection as jl
from tensornetworkquantumsimulator_tpu.parallel.structure import (
    compile_graph as j_compile_graph,
)
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

import measure_states as ms

torch.set_num_threads(1)
_PAULI = {"X": np.array([[0, 1], [1, 0]]), "Y": np.array([[0, -1j], [1j, 0]]),
          "Z": np.diag([1.0, -1.0])}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _pair(lattice, chi=2, seed=0, dtype=None):
    """(JAX spec, JAX state, JAX graph, port spec, port state, port graph)."""
    jspec, jstate, tspec, _, _ = ms.converged(lattice, chi, seed)
    _, tstate = ms.port_state(lattice, chi, seed, dtype=dtype)
    return (jspec, jstate, ms.LATTICES[lattice](j_lat), tspec, tstate,
            ms.LATTICES[lattice](tt))


def _c(x) -> complex:
    return complex(np.asarray(x))


def _assert_tables_equal(cj, ct):
    assert ct.n_configurations == cj.n_configurations
    assert ct.n_skipped == cj.n_skipped == 0
    assert len(ct.buckets) == len(cj.buckets)
    for (ij, sj), (it, st) in zip(cj.buckets, ct.buckets):
        assert st == sj and it.dtype == ij.dtype and np.array_equal(it, ij)
    assert len(ct.general_buckets) == len(cj.general_buckets)
    for (ij, sj), (it, st) in zip(cj.general_buckets, ct.general_buckets):
        assert st == sj and np.array_equal(it, ij)
    assert list(ct.groups) == list(cj.groups)
    for n in cj.groups:
        assert np.array_equal(ct.groups[n], cj.groups[n])
    if cj.op_covered is None:
        assert ct.op_covered is None and ct.op_positions is None
    else:
        assert np.array_equal(ct.op_positions, cj.op_positions)
        assert list(ct.op_covered) == list(cj.op_covered)
        for n in cj.op_covered:
            assert np.array_equal(ct.op_covered[n], cj.op_covered[n])


@pytest.mark.parametrize("lattice", ["grid3x3", "heavyhex1x1", "cube2x2x2"])
def test_torch_loop_scalars_rescale_match_jax(lattice):
    jspec, jstate, _, tspec, tstate, _ = _pair(lattice, chi=3)
    np.testing.assert_allclose(tl.vertex_scalars(tspec, tstate).numpy(),
                               np.asarray(jl.vertex_scalars(jspec, jstate)),
                               rtol=1e-10)
    np.testing.assert_allclose(tl.edge_scalars(tspec, tstate).numpy(),
                               np.asarray(jl.edge_scalars(jspec, jstate)),
                               rtol=1e-10)
    zj = _c(jl.batched_partitionfunction(jspec, jstate))
    zt = _c(tl.batched_partitionfunction(tspec, tstate))
    assert abs(zt - zj) <= 1e-10 * abs(zj)
    rj, rt = jl.rescale(jspec, jstate), tl.rescale(tspec, tstate)
    np.testing.assert_allclose(rt.tensors.numpy(), np.asarray(rj.tensors),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rt.messages.numpy(), np.asarray(rj.messages),
                               rtol=1e-10, atol=1e-12)
    # the rescaled gauge: every z_v and s_e is one
    np.testing.assert_allclose(tl.vertex_scalars(tspec, rt).numpy(), 1.0,
                               rtol=1e-10)
    np.testing.assert_allclose(tl.edge_scalars(tspec, rt).numpy(), 1.0,
                               rtol=1e-10)


@pytest.mark.parametrize("lattice, size, n_configs, leaves", [
    ("grid5x5", 4, 16, None),
    ("grid5x5", 6, 40, None),
    ("grid5x5", 8, 221, None),
    ("grid5x5", 6, None, ((2, 2), (3, 3))),
    ("heavyhex2x2", 12, None, None),
    ("eagle", 12, 18, None),
    ("grid3x3", 6, None, ((1, 2),)),
])
def test_torch_loop_configuration_tables_equal_jax(lattice, size, n_configs,
                                                   leaves):
    gj, gt = ms.LATTICES[lattice](j_lat), ms.LATTICES[lattice](tt)
    jspec, tspec = j_compile_graph(gj), tt.compile_graph(gt)
    kw = {}
    if leaves is not None:
        kw = dict(allowed_leaves=list(leaves),
                  op_positions=[tspec.vertex_position(v) for v in leaves])
    cj = jl.LoopConfigurations(jspec, gj, size, **kw)
    ct = tl.LoopConfigurations(tspec, gt, size, **kw)
    if n_configs is not None:
        assert ct.n_configurations == n_configs
    _assert_tables_equal(cj, ct)


@pytest.mark.parametrize("lattice", ["grid3x3", "cube2x2x2"])
def test_torch_loop_find_plaquettes_equal_jax(lattice):
    gj, gt = ms.LATTICES[lattice](j_lat), ms.LATTICES[lattice](tt)
    pj = jl.find_plaquettes(j_compile_graph(gj), gj)
    pt = tl.find_plaquettes(tt.compile_graph(gt), gt)
    assert len(pt) == len(pj)
    for (sj, ij, slj), (st, it, slt) in zip(pj, pt):
        assert st == sj and slt == slj and np.array_equal(it, ij)


# (lattice, chi, max_configuration_size): None runs the plaquette default
_Z_CASES = [("grid3x3", 2, 6), ("grid2x2", 3, 4), ("cube2x2x2", 2, None),
            ("cube2x2x2", 2, 6), ("heavyhex1x1", 2, 12)]


@pytest.mark.parametrize("dtype, tol", [(np.complex128, 1e-8),
                                        (np.complex64, 1e-4)])
@pytest.mark.parametrize("lattice, chi, size", _Z_CASES)
def test_torch_loopcorrected_z_matches_jax(lattice, chi, size, dtype, tol):
    jspec, jstate, gj, tspec, tstate, gt = _pair(lattice, chi, dtype=dtype)
    zj = _c(jl.loopcorrected_partitionfunction(
        jspec, jstate, gj, max_configuration_size=size))
    zt = _c(tl.loopcorrected_partitionfunction(
        tspec, tstate, gt, max_configuration_size=size))
    zbp = _c(jl.batched_partitionfunction(jspec, jstate))
    assert abs(zj - zbp) > 1e-6 * abs(zbp)  # the loops do correct Z_BP
    assert abs(zt - zj) <= tol * abs(zj), (zt, zj)


def _observables(g):
    verts = list(g.vertices())
    return [("Z", [verts[0]]), ("X", [verts[0]]), ("Y", [verts[-1]]),
            ("ZZ", [verts[1], verts[2]], 0.5), ("Z", [verts[2]], 0)]


@functools.lru_cache(maxsize=None)
def _jax_expectations(lattice, chi, size):
    """The JAX package's loop-corrected ⟨O⟩ in complex128 (the reference of
    both dtypes' cases, computed once)."""
    jspec, jstate, gj, _, _, _ = _pair(lattice, chi)
    obs = _observables(gj)
    return np.asarray(jl.make_loopcorrected_expectations(
        jspec, gj, obs, max_configuration_size=size)(jstate))


@pytest.mark.parametrize("dtype, tol", [(np.complex128, 1e-8),
                                        (np.complex64, 1e-4)])
@pytest.mark.parametrize("lattice, chi, size", [
    ("grid3x3", 2, 6), ("grid2x2", 3, 4), ("cube2x2x2", 2, 4),
    ("heavyhex1x1", 2, 12)])
def test_torch_loopcorrected_expectations_match_jax(lattice, chi, size,
                                                    dtype, tol):
    _, _, _, tspec, tstate, gt = _pair(lattice, chi, dtype=dtype)
    obs = _observables(gt)
    ft = tl.make_loopcorrected_expectations(tspec, gt, obs,
                                            max_configuration_size=size,
                                            jit=False)
    want = _jax_expectations(lattice, chi, size)
    got = ft(tstate)
    assert got.shape == (len(obs),) and got.is_complex()
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_torch_loopcorrected_single_loop_exact_on_dense():
    """2×2 grid: the size-4 series (the one loop) is the exact contraction
    of numerator and denominator."""
    _, _, tspec, tensors, _ = ms.converged("grid2x2", 3)
    _, tstate = ms.port_state("grid2x2", 3)
    g = ms.LATTICES["grid2x2"](tt)
    psi = ms.dense_statevector(tspec, tensors)
    pos = {v: i for i, v in enumerate(tspec.vertices)}
    obs = [("Z", [(1, 1)]), ("XY", [(1, 2), (2, 1)]), ("Y", [(2, 2)], 0.3)]
    got = tl.make_loopcorrected_expectations(
        tspec, g, obs, max_configuration_size=4)(tstate).numpy()
    for k, (ops, verts, *coeff) in enumerate(obs):
        x = psi
        for o, v in zip(ops, verts):
            i = pos[v]
            x = np.moveaxis(np.tensordot(_PAULI[o], x, axes=(1, i)), 0, i)
        exact = (coeff[0] if coeff else 1) * np.vdot(psi, x) / np.vdot(psi, psi)
        # exact up to the BP fixed point's own precision (tolerance 1e-14)
        np.testing.assert_allclose(got[k], exact, rtol=1e-6, atol=1e-9)


def test_torch_loopcorrected_z_closer_than_bp_on_dense():
    """3×3 grid, all sites: loop-corrected ⟨Z⟩ (size 8) is closer to the
    dense state than BP's ⟨Z⟩, in total over the sites."""
    _, _, tspec, tensors, _ = ms.converged("grid3x3", 2, seed=3, amp=0.5)
    _, tstate = ms.port_state("grid3x3", 2, seed=3, amp=0.5)
    g = ms.LATTICES["grid3x3"](tt)
    exact = ms.dense_site_expectations(
        ms.dense_statevector(tspec, tensors), _PAULI["Z"])
    bp = tt.local_expectations(tspec, tstate, _PAULI["Z"]).real.numpy()
    obs = [("Z", [v]) for v in tspec.vertices]
    lc = tl.make_loopcorrected_expectations(
        tspec, g, obs, max_configuration_size=8)(tstate).real.numpy()
    err_bp, err_lc = np.abs(bp - exact).sum(), np.abs(lc - exact).sum()
    assert err_bp > 1e-4  # the state's loops matter
    assert err_lc < 0.5 * err_bp, (err_lc, err_bp)


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++: the native enumerator cannot be built")
@pytest.mark.parametrize("lattice, size, leaves", [
    ("grid3x3", 8, ()), ("grid3x3", 6, ((2, 2),)), ("heavyhex1x1", 12, ()),
    ("cube2x2x2", 6, ()), ("grid3x4", 7, ((1, 1), (3, 4)))])
def test_torch_native_enumerator_matches_python(lattice, size, leaves):
    from tensornetworkquantumsimulator_torch import native

    g = ms.LATTICES[lattice](tt)
    edges = g.edges()
    sets = t_graphs._leaffree_edge_sets_native(g, edges, size,
                                               frozenset(leaves))
    assert sets is not None and native.get_subgraphs() is not None
    native_graphs = t_graphs.edgeinduced_subgraphs_no_leaves(
        g, size, allowed_leaves=leaves)
    python_graphs = t_graphs._edgeinduced_subgraphs_no_leaves_py(
        g, size, frozenset(leaves))

    def key(sub):
        return frozenset(frozenset(e) for e in sub.nx().edges)

    assert len(native_graphs) == len(python_graphs) == len(sets) > 0
    assert [key(s) for s in native_graphs] == [key(s) for s in python_graphs]
