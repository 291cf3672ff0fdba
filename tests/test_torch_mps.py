"""PyTorch port, the MPS machinery of the boundary-MPS engine
(``engines/mps.py``) against the JAX package on random chains built alike
in both from one numpy draw: norm, normalization, orthogonalization,
truncation, internal-tensor merging, link combining and the MPO×MPS
``generic_apply``.  A chain's gauge is not unique, so each result is
compared through the chain contracted to one tensor; bars 1e-10 in
complex128, 1e-4 in complex64."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.engines import mps as t_mps
from tensornetworkquantumsimulator_tpu.engines import mps as j_mps

from generic_carry import Chain, aligned, full, random_mps

torch.set_num_threads(1)
DTYPES = [(np.complex128, 1e-10), (np.complex64, 1e-4)]


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _same_full(ts_t, ts_j, tol):
    fj = full(ts_j)
    ref = np.asarray(fj.data)
    np.testing.assert_allclose(aligned(full(ts_t), fj.inds), ref,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_norm_normalize_orthogonalize(dtype, tol):
    c = Chain(random_mps(np.random.default_rng(0), 5, 3, 2, dtype))
    np.testing.assert_allclose(t_mps.mps_norm(c.t), j_mps.mps_norm(c.j),
                               rtol=tol)
    _same_full(t_mps.mps_normalize(c.t), j_mps.mps_normalize(c.j), tol)
    np.testing.assert_allclose(t_mps.mps_norm(t_mps.mps_normalize(c.t)), 1.0,
                               rtol=tol)
    orth = t_mps.mps_orthogonalize(c.t)
    _same_full(orth, j_mps.mps_orthogonalize(c.j), tol)
    for t, nxt in zip(orth, orth[1:]):  # left-isometries
        (right,) = [i for i in t.inds if i in nxt.inds]
        rows = [i for i in t.inds if i != right]
        m = t.numpy(rows + [right]).reshape(-1, right.dim)
        np.testing.assert_allclose(m.conj().T @ m, np.eye(m.shape[1]),
                                   atol=tol * 10)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("maxdim,cutoff", [(2, None), (3, 1e-3), (None, 1e-2)])
def test_truncate(dtype, tol, maxdim, cutoff):
    c = Chain(random_mps(np.random.default_rng(1), 5, 4, 2, dtype))
    got = t_mps.mps_truncate(c.t, maxdim=maxdim, cutoff=cutoff)
    ref = j_mps.mps_truncate(c.j, maxdim=maxdim, cutoff=cutoff)
    assert [t.shape for t in got] == [tuple(t.data.shape) for t in ref]
    _same_full(got, ref, tol)


def test_merge_internal_and_combine_links():
    """A chain with a site-less middle tensor and a doubled link: the
    middle is folded into a neighbour and the double link fused."""
    rng = np.random.default_rng(2)
    spec = random_mps(rng, 3, 2, 2)
    mid_in, mid_out = spec[1][1][0], spec[1][1][2]
    spec[1] = (rng.standard_normal((2, 2)) + 0j, [mid_in, mid_out])
    extra = (10**6 + 500, 3, ("link",), 0)
    a, inds = spec[2]
    spec[2] = (np.repeat(a[..., None], 3, -1) * rng.standard_normal(3),
               inds + [extra])
    a, inds = spec[1]
    spec[1] = (np.repeat(a[..., None], 3, -1), inds + [extra])
    c = Chain(spec)
    got, ref = t_mps.merge_internal_tensors(c.t), j_mps.merge_internal_tensors(c.j)
    assert len(got) == len(ref) == 2
    _same_full(got, ref, 1e-12)
    got = t_mps.combine_consecutive_links(got)
    ref = j_mps.combine_consecutive_links(ref)
    assert [t.shape for t in got] == [tuple(t.data.shape) for t in ref]
    _same_full(got, ref, 1e-12)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_generic_apply(dtype, tol):
    """MPO × MPS densified and truncated back to rank 3 (normalized), and
    the MPO alone (no MPS) truncated; the same chain in both packages."""
    rng = np.random.default_rng(3)
    m = random_mps(rng, 4, 2, 2, dtype)
    lower = [inds[1 if k else 0] for k, (_, inds) in enumerate(m)]
    o = random_mps(rng, 4, 2, 2, dtype, first_id=2 * 10**6, sites=lower)
    # upper site legs of the MPO
    for k, (a, inds) in enumerate(o):
        up = (3 * 10**6 + k, 2, ("up",), 0)
        o[k] = ((a[..., None] * rng.standard_normal(2)).astype(dtype),
                inds + [up])
    c, cm = Chain(o), Chain(m)
    for mt, mj in ((cm.t, cm.j), (None, None)):
        got = t_mps.generic_apply(c.t, mt, normalize=True, maxdim=3,
                                  cutoff=1e-12)
        ref = j_mps.generic_apply(c.j, mj, normalize=True, maxdim=3,
                                  cutoff=1e-12)
        assert [t.shape for t in got] == [tuple(t.data.shape) for t in ref]
        _same_full(got, ref, tol)
