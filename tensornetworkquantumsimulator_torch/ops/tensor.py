"""Dense named-index tensors on one torch device.

The counterpart of ``tensornetworkquantumsimulator_tpu.ops.tensor``: the
dense-`ITensor` subset the reference relies on (contraction `*`, `dag`,
`prime`, `delta`, `onehot`, `random_itensor`, `replaceinds`, `noprime`,
elementwise algebra; see the reference's `src/imports.jl` and usage
throughout its `src/`).

A :class:`Tensor` holds a ``torch.Tensor`` and a tuple of indices.  Every
pairwise contraction is one ``torch.einsum``.  Operands must lie on one
device: an operation that mixes devices raises, and nothing moves data
between devices behind the caller's back.  Data handed in as numpy goes to
the package's default device (CUDA unless :func:`~..devices.
set_default_device` chose another).  Tensors never write into their data:
a constant (a gate matrix, a basis vector) may be shared between many.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..devices import resolve_device
from .index import Index, commoninds, uniqueinds


def complex_of(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of ``dtype``'s precision."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def real_of(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of ``dtype``'s precision."""
    if not dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.complex128 else torch.float32


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or a numpy type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def _weak_scalar(x, like: torch.Tensor):
    """A scalar that never widens ``like``'s dtype, as JAX's weakly-typed
    Python numbers do: numpy scalars become Python numbers
    (np.float64 * complex64 stays complex64), a 0-dim torch tensor takes
    ``like``'s precision (complex if it is complex) and device."""
    if isinstance(x, torch.Tensor):
        if x.ndim != 0:
            raise ValueError("scalar algebra takes 0-dim tensors only")
        dt = complex_of(like.dtype) if x.is_complex() else like.dtype
        return x.to(dtype=dt, device=like.device)
    if isinstance(x, (np.generic, np.ndarray)):
        return x.item()
    return x


def _same_device(a: "Tensor", b: "Tensor") -> None:
    if a.data.device != b.data.device:
        raise ValueError(
            f"tensors on different devices: {a.data.device} and "
            f"{b.data.device}; move one with .to(device) first")


class Tensor:
    """A dense tensor with named indices.

    ``data.shape[k] == inds[k].dim``. Index identity is ``(id, plev)``; two
    tensors sharing an index contract over it.
    """

    __slots__ = ("data", "inds")

    def __init__(self, data, inds: Sequence[Index]):
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data), device=resolve_device())
        inds = tuple(inds)
        if data.ndim != len(inds):
            raise ValueError(f"data ndim {data.ndim} != #inds {len(inds)}")
        for d, i in zip(data.shape, inds):
            if d != i.dim:
                raise ValueError(f"shape {tuple(data.shape)} mismatches inds {inds}")
        if len(set(inds)) != len(inds):
            raise ValueError(f"duplicate index in {inds}")
        self.data = data
        self.inds = inds

    # -- basic info ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.inds)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self):
        return f"Tensor(inds={list(self.inds)}, dtype={self.dtype}, device={self.device})"

    def scalar(self):
        """The value of a 0-index tensor as a Python number (mirrors the
        reference's ``t[]``); on CUDA this reads the device."""
        if self.ndim != 0:
            raise ValueError(f"scalar() on tensor with inds {self.inds}")
        return self.data.item()

    def array(self, inds_order: Sequence[Index] | None = None) -> torch.Tensor:
        """Dense data, optionally permuted to the given index order."""
        if inds_order is None:
            return self.data
        inds_order = tuple(inds_order)
        if set(inds_order) != set(self.inds):
            raise ValueError("inds_order must be a permutation of inds")
        perm = tuple(self.inds.index(i) for i in inds_order)
        return self.data.permute(perm)

    def numpy(self, inds_order: Sequence[Index] | None = None) -> np.ndarray:
        """Dense data on the host (a copy), optionally permuted."""
        return self.array(inds_order).detach().cpu().resolve_conj().numpy()

    def to(self, device) -> "Tensor":
        return Tensor(self.data.to(torch.device(device)), self.inds)

    # -- index transformations ---------------------------------------------
    def replaceinds(self, old, new) -> "Tensor":
        old, new = list(old), list(new)
        mapping = dict(zip(old, new))
        for o, n in zip(old, new):
            if o.dim != n.dim:
                raise ValueError(f"replaceinds dim mismatch {o} -> {n}")
        return Tensor(self.data, tuple(mapping.get(i, i) for i in self.inds))

    def replaceind(self, old: Index, new: Index) -> "Tensor":
        return self.replaceinds([old], [new])

    def prime(self, n: int = 1, which=None) -> "Tensor":
        which = set(self.inds if which is None else which)
        return Tensor(
            self.data, tuple(i.prime(n) if i in which else i for i in self.inds)
        )

    def noprime(self) -> "Tensor":
        new = tuple(i.noprime() for i in self.inds)
        if len(set(new)) != len(new):
            raise ValueError(f"noprime collides indices: {self.inds}")
        return Tensor(self.data, new)

    def dag(self) -> "Tensor":
        return Tensor(self.data.conj(), self.inds)

    def conj(self) -> "Tensor":
        return self.dag()

    # -- algebra -------------------------------------------------------------
    def _aligned_data(self, other: "Tensor"):
        if set(self.inds) != set(other.inds):
            raise ValueError(f"index mismatch: {self.inds} vs {other.inds}")
        _same_device(self, other)
        return self.data, other.array(self.inds)

    def __add__(self, other):
        if isinstance(other, Tensor):
            a, b = self._aligned_data(other)
            return Tensor(a + b, self.inds)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Tensor):
            a, b = self._aligned_data(other)
            return Tensor(a - b, self.inds)
        return NotImplemented

    def __neg__(self):
        return Tensor(-self.data, self.inds)

    def __mul__(self, other):
        if isinstance(other, Tensor):
            return contract_pair(self, other)
        return Tensor(self.data * _weak_scalar(other, self.data), self.inds)

    def __rmul__(self, other):
        if isinstance(other, Tensor):
            return contract_pair(other, self)
        return Tensor(self.data * _weak_scalar(other, self.data), self.inds)

    def __truediv__(self, other):
        if isinstance(other, Tensor):
            raise TypeError("use contraction with an inverted tensor")
        return Tensor(self.data / _weak_scalar(other, self.data), self.inds)

    def norm_tensor(self) -> torch.Tensor:
        """The Frobenius norm as a 0-dim tensor on the data's device."""
        return torch.linalg.vector_norm(self.data)

    def norm(self) -> float:
        return float(self.norm_tensor())

    def normalize(self) -> "Tensor":
        return Tensor(self.data / self.norm_tensor(), self.inds)

    def sum_entries(self):
        return self.data.sum().item()

    def isreal(self) -> bool:
        return not self.data.is_complex()

    def astype(self, dtype) -> "Tensor":
        dtype = as_torch_dtype(dtype)
        data = self.data
        if data.is_complex() and not dtype.is_complex:
            data = data.real
        return Tensor(data.to(dtype), self.inds)


# ---------------------------------------------------------------------------
# contraction
# ---------------------------------------------------------------------------

_EINSUM_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def contract_pair(a: Tensor, b: Tensor, keep=()) -> Tensor:
    """Contract two tensors over their common indices (ITensor ``*``), in
    one ``torch.einsum``; mixed dtypes promote as numpy's would.

    Indices listed in ``keep`` are not summed even if shared (useful for
    hyper-edges during sequenced contraction).
    """
    _same_device(a, b)
    keep = set(keep)
    common = [i for i in commoninds(a.inds, b.inds) if i not in keep]
    a_only = uniqueinds(a.inds, common)
    b_only = uniqueinds(b.inds, a.inds)
    letters = {}
    for i in list(a.inds) + list(b.inds):
        if i not in letters:
            letters[i] = _EINSUM_LETTERS[len(letters)]
    sub_a = "".join(letters[i] for i in a.inds)
    sub_b = "".join(letters[i] for i in b.inds)
    out_inds = tuple(a_only) + tuple(b_only)
    sub_out = "".join(letters[i] for i in out_inds)
    dt = torch.promote_types(a.dtype, b.dtype)
    data = torch.einsum(f"{sub_a},{sub_b}->{sub_out}", a.data.to(dt),
                        b.data.to(dt))
    return Tensor(data, out_inds)


def contract(tensors: Sequence[Tensor], sequence=None) -> Tensor:
    """Contract a list of tensors down to one.

    Assumes every index occurs in at most two tensors (the reference's
    implicit ITensor convention).  ``sequence`` is a pairwise path as
    produced by :func:`..paths.contraction_sequence`; if ``None`` a path is
    computed on the fly.
    """
    tensors = list(tensors)
    if not tensors:
        raise ValueError("empty contraction")
    if len(tensors) == 1:
        return tensors[0]
    if sequence is None:
        from .paths import contraction_sequence

        sequence = contraction_sequence(tensors)
    pool = list(tensors)
    for (i, j) in sequence:
        t = contract_pair(pool[i], pool[j])
        # ssa-style path: contracted operands are replaced by None, result appended
        pool[i] = None
        pool[j] = None
        pool.append(t)
    remaining = [t for t in pool if t is not None]
    out = remaining[0]
    for t in remaining[1:]:
        out = contract_pair(out, t)
    return out


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

_CONSTANTS: dict = {}
_MAX_CONSTANTS = 4096


def constant(key, make, dtype, device) -> torch.Tensor:
    """A device copy of the host array ``make()`` returns, as ``dtype``,
    made once per ``(key, dtype, device)`` and shared read-only after: a
    circuit that applies one gate matrix at every vertex, layer after layer,
    copies it to the device once.  ``key`` None (an unhashable parameter)
    copies every time."""
    dtype = as_torch_dtype(dtype)
    device = torch.device(device)
    if key is None:
        return _host_to(make(), dtype, device)
    full = (key, dtype, str(device))
    hit = _CONSTANTS.get(full)
    if hit is None:
        hit = _host_to(make(), dtype, device)
        if len(_CONSTANTS) < _MAX_CONSTANTS:
            _CONSTANTS[full] = hit
    return hit


def _host_to(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if np.iscomplexobj(arr) and not dtype.is_complex:
        raise ValueError(f"complex data cannot become {dtype}")
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # a JAX array's host view
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.to(dtype=dtype).to(device)


def delta(inds: Sequence[Index] | Index, dtype=torch.float64,
          device=None) -> Tensor:
    """Generalized Kronecker delta: 1 where all indices are equal.

    Mirrors ITensors ``delta``/``denseblocks(delta(...))`` used for default BP
    messages (`tensornetwork.jl:62-64`, `tensornetworkstate.jl:64-67`).
    Rectangular deltas run the diagonal up to the smallest dimension.  Made
    on ``device`` (None: the package default) with no host copy.
    """
    if isinstance(inds, Index):
        inds = (inds,)
    inds = tuple(inds)
    dtype = as_torch_dtype(dtype)
    device = resolve_device(device)
    if len(inds) == 0:
        return Tensor(torch.ones((), dtype=dtype, device=device), ())
    if len(inds) == 1:
        return Tensor(torch.ones(inds[0].dim, dtype=dtype, device=device), inds)
    shape = tuple(i.dim for i in inds)
    if len(inds) == 2:
        return Tensor(torch.eye(*shape, dtype=dtype, device=device), inds)
    data = torch.zeros(shape, dtype=dtype, device=device)
    diag = torch.arange(min(shape), device=device)
    data[(diag,) * len(shape)] = 1
    return Tensor(data, inds)


def onehot(ind: Index, pos: int, dtype=torch.float64, device=None) -> Tensor:
    """Basis vector e_pos on ``ind`` (0-based; ITensors ``onehot`` is 1-based)."""
    data = torch.zeros(ind.dim, dtype=as_torch_dtype(dtype),
                       device=resolve_device(device))
    data[pos] = 1
    return Tensor(data, (ind,))


def random_tensor(generator: torch.Generator, inds: Sequence[Index],
                  dtype=torch.float64, device=None) -> Tensor:
    """Gaussian random tensor (reference: ``random_itensor``).  Complex
    entries take a standard normal real part and imaginary part, as the JAX
    package's do.  The draw uses ``generator`` (a CPU generator) and is
    copied to ``device``, so one seed gives the same tensor on every
    device."""
    inds = tuple(inds)
    shape = tuple(i.dim for i in inds)
    dtype = as_torch_dtype(dtype)
    rdt = real_of(dtype)
    data = torch.randn(shape, generator=generator, dtype=rdt)
    if dtype.is_complex:
        im = torch.randn(shape, generator=generator, dtype=rdt)
        data = torch.complex(data, im)
    return Tensor(data.to(dtype).to(resolve_device(device)), inds)


def from_array(arr, inds: Sequence[Index], dtype=None, device=None) -> Tensor:
    """A tensor from a torch tensor or a host array.  A torch tensor keeps
    its device unless ``device`` is given; host data goes to ``device``
    (None: the package default)."""
    if isinstance(arr, torch.Tensor):
        if device is not None:
            arr = arr.to(torch.device(device))
        if dtype is not None:
            arr = arr.to(as_torch_dtype(dtype))
        return Tensor(arr, tuple(inds))
    arr = np.asarray(arr)
    dtype = as_torch_dtype(arr.dtype if dtype is None else dtype)
    return Tensor(_host_to(arr, dtype, resolve_device(device)), tuple(inds))


# ---------------------------------------------------------------------------
# tensor utilities used across the engines
# ---------------------------------------------------------------------------


def dot(a: Tensor, b: Tensor):
    """⟨a, b⟩ = Σ conj(a) b over the full (shared) index set."""
    return contract_pair(a.dag(), b).scalar()


def plev0_inds(t: Tensor):
    return [i for i in t.inds if i.plev == 0]


def trace(t: Tensor):
    """Full trace pairing each plev-0 index with its prime (rdm trace)."""
    out = t
    for i in plev0_inds(t):
        ip = i.prime()
        if ip in out.inds:
            out = contract_pair(out, delta((i, ip), dtype=out.dtype,
                                           device=out.device))
    return out.scalar()


def diagonal(t: Tensor) -> torch.Tensor:
    """Diagonal of a (i, i') two-index tensor as a 1-d tensor."""
    if t.ndim != 2:
        raise ValueError("diagonal expects a matrix tensor")
    return torch.diagonal(t.data)


def map_diag(f, t: Tensor) -> Tensor:
    """Apply f elementwise to the matrix diagonal, keep off-diagonals."""
    if t.ndim != 2:
        raise ValueError("map_diag expects a matrix tensor")
    d = torch.diagonal(t.data)
    return Tensor(t.data + torch.diag(f(d) - d), t.inds)


def combiner(inds: Sequence[Index], dtype=torch.float64, tags=("combined",),
             device=None):
    """Index-fusing tensor: contracting it with a tensor reshapes the given
    indices into one combined index (ITensors ``combiner``)."""
    inds = tuple(inds)
    dims = tuple(i.dim for i in inds)
    total = int(np.prod(dims))
    comb = Index(total, tags=tags)
    data = torch.eye(total, dtype=as_torch_dtype(dtype),
                     device=resolve_device(device)).reshape(dims + (total,))
    return Tensor(data, inds + (comb,)), comb


def apply_op(o: Tensor, psi: Tensor) -> Tensor:
    """ITensors.apply(o, ψ): contract o's unprimed legs with ψ, then unprime.

    o carries index pairs (s', s); the result replaces each s with s' and is
    then unprimed back to s (`simple_update.jl:43`).
    """
    out = contract_pair(o, psi)
    return out.noprime()


def make_hermitian(t: Tensor) -> Tensor:
    """(A + A†)/2 for a 2-index message (`beliefpropagationcache.jl:123-127`)."""
    if t.ndim != 2:
        raise ValueError("make_hermitian expects a matrix tensor")
    return Tensor((t.data + t.data.conj().T) / 2, t.inds)
