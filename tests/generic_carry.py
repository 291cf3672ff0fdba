"""Shared helpers of the generic-engine parity tests (``test_torch_*``):
JAX networks carried into the port as plain data, and named-index tensor
chains built alike in both packages from one numpy draw."""

import jax
import numpy as np

import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch.models import state_from_numpy
from tensornetworkquantumsimulator_torch.ops import index as t_index
from tensornetworkquantumsimulator_torch.ops import tensor as t_tensor
from tensornetworkquantumsimulator_tpu.ops import index as j_index
from tensornetworkquantumsimulator_tpu.ops import tensor as j_tensor
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat


def plain(j):
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


def pair(dtype_j, shape=(3, 3), bond=2, seed=0, graph=None):
    """A random JAX state on a grid (or on ``graph``) and its port copy."""
    g = graph if graph is not None else j_lat.named_grid(shape)
    psi_j = tnqs.random_tensornetworkstate(dtype_j, g, bond_dimension=bond,
                                           key=jax.random.PRNGKey(seed))
    return psi_j, state_from_numpy(plain(psi_j))


def aligned(t, inds):
    """A tensor's data (port or JAX) in the order of ``inds``, matched by
    (id, plev)."""
    pos = {(i.id, i.plev): k for k, i in enumerate(t.inds)}
    data = t.numpy() if hasattr(t, "numpy") else np.asarray(t.data)
    return np.transpose(data, [pos[(i.id, i.plev)] for i in inds])


class Chain:
    """One list of tensors built in both packages: the same arrays on
    indices of the same ids.  ``spec`` is ``[(array, [(id, dim, tags,
    plev), ...]), ...]``."""

    def __init__(self, spec):
        t_index.reserve_ids(max(p[0] for _, inds in spec for p in inds))
        self.j = [j_tensor.Tensor(np.asarray(a), tuple(
            j_index.Index(d, tags=t, plev=pl, id=i) for i, d, t, pl in inds))
            for a, inds in spec]
        self.t = [t_tensor.from_array(np.asarray(a), [
            t_index.Index(d, tags=t, plev=pl, id=i) for i, d, t, pl in inds])
            for a, inds in spec]


def random_mps(rng, n, bond, phys, dtype=np.complex128, first_id=10**6,
               sites=None):
    """An open chain of ``n`` random tensors (site dim ``phys``, bond
    ``bond``) as a :class:`Chain` spec; ``sites`` reuses given site-index
    specs (for an MPO's lower legs)."""
    links = [(first_id + k, bond, ("link",), 0) for k in range(n - 1)]
    sites = sites or [(first_id + 1000 + k, phys, ("site",), 0)
                      for k in range(n)]
    spec = []
    for k in range(n):
        inds = ([links[k - 1]] if k > 0 else []) + [sites[k]] + (
            [links[k]] if k < n - 1 else [])
        shape = tuple(p[1] for p in inds)
        a = rng.standard_normal(shape)
        if np.iscomplexobj(np.zeros((), dtype)):
            a = a + 1j * rng.standard_normal(shape)
        spec.append((a.astype(dtype), inds))
    return spec


def full(ts):
    """The chain contracted to one tensor (either package)."""
    out = ts[0]
    for t in ts[1:]:
        out = out * t
    return out
