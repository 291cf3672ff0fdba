"""Named tensor indices.

A torch-free, jax-free copy of ``tensornetworkquantumsimulator_tpu.ops.
index``: the index system the reference gets from ITensors
(the reference's `src/imports.jl:1-61` imports `Index`, `prime`, `dag`,
`sim`, `commoninds`, ...).  An :class:`Index` is identified by
``(id, plev)``; its dimension and tags ride along.  ``dag`` is a no-op on
dense indices (no arrows), ``prime`` bumps the prime level, ``sim`` mints a
fresh id with the same dim.

The id counter is this package's own.  A state carried in from elsewhere
brings its ids along; :func:`reserve_ids` moves the counter past the
largest of them, so that later ``sim()`` indices never collide with them.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field, replace

_lock = threading.Lock()
_id_counter = itertools.count(1)
_last_id = 0  # the largest id minted or reserved


def _next_id() -> int:
    global _last_id
    with _lock:
        _last_id = next(_id_counter)
        return _last_id


def reserve_ids(largest: int) -> None:
    """Make every id minted from now on larger than ``largest``."""
    global _id_counter, _last_id
    with _lock:
        if largest > _last_id:
            _last_id = int(largest)
            _id_counter = itertools.count(_last_id + 1)


@dataclass(frozen=True)
class Index:
    """A named tensor index. Identity (hash/eq) is ``(id, plev)``."""

    dim: int
    tags: tuple = ()
    plev: int = 0
    id: int = field(default_factory=_next_id)

    def __post_init__(self):
        if isinstance(self.tags, str):
            object.__setattr__(self, "tags", (self.tags,) if self.tags else ())
        else:
            object.__setattr__(self, "tags", tuple(self.tags))

    def __hash__(self):
        return hash((self.id, self.plev))

    def __eq__(self, other):
        if not isinstance(other, Index):
            return NotImplemented
        return self.id == other.id and self.plev == other.plev

    def __repr__(self):
        tag_str = ",".join(map(str, self.tags))
        p = "'" * self.plev
        return f"(dim={self.dim}|id={self.id % 1000}|{tag_str}){p}"

    # -- transformations ---------------------------------------------------
    def prime(self, n: int = 1) -> "Index":
        return replace(self, plev=self.plev + n)

    def noprime(self) -> "Index":
        return replace(self, plev=0)

    def setprime(self, n: int) -> "Index":
        return replace(self, plev=n)

    def sim(self) -> "Index":
        """A fresh index with the same dimension/tags but a new id."""
        return replace(self, id=_next_id())

    def dag(self) -> "Index":
        return self  # dense indices carry no arrow

    def hastag(self, tag: str) -> bool:
        return tag in self.tags


# -- free-function forms (mirroring the reference's ITensors verbs) ---------
def prime(i: Index, n: int = 1) -> Index:
    return i.prime(n)


def noprime(i: Index) -> Index:
    return i.noprime()


def sim(i: Index) -> Index:
    return i.sim()


def dag(i: Index) -> Index:
    return i


def dim(i: Index) -> int:
    return i.dim


def plev(i: Index) -> int:
    return i.plev


def tags(i: Index) -> tuple:
    return i.tags


def hastags(i: Index, tag: str) -> bool:
    return i.hastag(tag)


def commoninds(inds_a, inds_b):
    """Indices present in both collections (order of ``inds_a``)."""
    sb = set(inds_b)
    return [i for i in inds_a if i in sb]


def uniqueinds(inds_a, inds_b):
    """Indices of ``inds_a`` not present in ``inds_b``."""
    sb = set(inds_b)
    return [i for i in inds_a if i not in sb]


def unioninds(inds_a, inds_b):
    out = list(inds_a)
    seen = set(out)
    for i in inds_b:
        if i not in seen:
            out.append(i)
            seen.add(i)
    return out


def index_to_plain(i: Index) -> tuple:
    """``(id, dim, tags, plev)``: an index as plain data."""
    return (int(i.id), int(i.dim), tuple(i.tags), int(i.plev))


def index_from_plain(p) -> Index:
    """The inverse of :func:`index_to_plain` (the caller reserves the id)."""
    i, d, t, pl = p
    return Index(int(d), tags=tuple(t), plev=int(pl), id=int(i))
