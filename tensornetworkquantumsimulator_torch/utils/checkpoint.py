"""Checkpoint / resume for long dynamics runs.

The counterpart of ``tensornetworkquantumsimulator_tpu.utils.checkpoint``,
in the same ``.npz`` formats, so that a file written by either package
loads in the other:

- :class:`~..parallel.engine.BatchedState`: :func:`save_batched_state` /
  :func:`load_batched_state`, the two padded arrays (``tensors``,
  ``messages``);
- the generic :class:`~..models.TensorNetworkState`: :func:`save_state` /
  :func:`load_state`, tensors + index metadata + graph structure.

The arrays are copied to the host to be written, and loaded onto
``device`` (None: the package default).

A sharded state (``parallel.sharding.ShardedState``) is written by
:func:`save_sharded_state` as a directory of one ``.npz`` per shard plus a
JSON manifest.  The JAX package writes orbax (zarr/OCDBT) directories
there; orbax and tensorstore are not dependencies of this package, so the
two packages' sharded checkpoint formats differ (a state crosses between
them through :func:`save_batched_state`).
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import torch

from ..devices import resolve_device
from ..models.tensornetwork import TensorNetwork, TensorNetworkState
from ..ops.index import Index
from ..ops.tensor import from_array
from ..utils.graphs import NamedEdge, NamedGraph


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize so the
    same path string round-trips through save and load."""
    return path if path.endswith(".npz") else path + ".npz"


def _host(x) -> np.ndarray:
    return x.detach().cpu().resolve_conj().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x)


def save_batched_state(path: str, state) -> None:
    np.savez(
        _npz_path(path),
        tensors=_host(state.tensors),
        messages=_host(state.messages),
    )


def load_batched_state(path: str, device=None):
    from ..parallel.engine import BatchedState

    dev = resolve_device(device)
    with np.load(_npz_path(path)) as data:
        return BatchedState(torch.from_numpy(data["tensors"]).to(dev),
                            torch.from_numpy(data["messages"]).to(dev))


_SHARDED_FORMAT = "tnqs-torch-sharded-1"
_MANIFEST = "manifest.json"


def save_sharded_state(path: str, state, mesh=None) -> None:
    """Write a sharded state as a directory: ``shard_<s>.npz`` (its
    ``tensors`` and ``messages`` rows) per shard, each copied to the host
    from its own device with no assembly of the whole state, and
    ``manifest.json`` (format, global shapes and dtypes, each shard's row
    range and file, and the mesh shape: ``mesh.shape`` when ``mesh`` is
    given, else [number of shards]).  ``path`` must not exist.

    The JAX package's ``save_sharded_state`` writes orbax (zarr/OCDBT)
    instead; this package does not depend on orbax or tensorstore, so the
    two formats differ."""
    shards = getattr(state, "shards", None)
    if shards is None:  # a single BatchedState: one shard
        shards = (state,)
    os.makedirs(path)
    rows, files, start = [], [], 0
    for s, st in enumerate(shards):
        name = f"shard_{s:05d}.npz"
        np.savez(os.path.join(path, name), tensors=_host(st.tensors),
                 messages=_host(st.messages))
        n = st.tensors.shape[0]
        rows.append([start, start + n])
        files.append(name)
        start += n
    t0, m0 = shards[0].tensors, shards[0].messages
    manifest = {
        "format": _SHARDED_FORMAT,
        "num_shards": len(shards),
        "mesh_shape": (list(mesh.shape.values()) if mesh is not None
                       else [len(shards)]),
        "tensors": {"shape": [start] + list(t0.shape[1:]),
                    "dtype": str(t0.dtype)},
        "messages": {"shape": [start] + list(m0.shape[1:]),
                     "dtype": str(m0.dtype)},
        "shards": [{"file": f, "rows": r} for f, r in zip(files, rows)],
    }
    with open(os.path.join(path, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)


def load_sharded_state(path: str, mesh=None, device=None):
    """Restore a :func:`save_sharded_state` directory.

    With ``mesh`` (a ``parallel.sharding.ShardMesh``) the vertex rows are
    split into the mesh's equal blocks and each block is read from the
    shard files that hold it straight onto its shard's device: a
    ``ShardedState``.  Without one, the whole state is returned as one
    ``BatchedState`` on ``device`` (None: the package default)."""
    from ..parallel.engine import BatchedState
    from ..parallel.sharding import ShardedState

    with open(os.path.join(path, _MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != _SHARDED_FORMAT:
        raise ValueError(f"{path} is not a {_SHARDED_FORMAT} checkpoint")
    parts = manifest["shards"]
    V = manifest["tensors"]["shape"][0]

    def rows(lo, hi, device):
        """Rows [lo, hi) of both arrays, read from the files holding them."""
        ts, ms = [], []
        for part in parts:
            a, b = part["rows"]
            if b <= lo or a >= hi:
                continue
            with np.load(os.path.join(path, part["file"])) as data:
                sl = slice(max(lo, a) - a, min(hi, b) - a)
                ts.append(data["tensors"][sl])
                ms.append(data["messages"][sl])
        return BatchedState(
            torch.from_numpy(np.concatenate(ts)).to(device),
            torch.from_numpy(np.concatenate(ms)).to(device))

    if mesh is None:
        return rows(0, V, resolve_device(device))
    S = mesh.num_shards
    if V % S:
        raise ValueError(f"{V} vertices not divisible by {S} shards")
    Vl = V // S
    return ShardedState(tuple(rows(s * Vl, (s + 1) * Vl, d)
                              for s, d in enumerate(mesh.devices)))


def save_state(path: str, tns: TensorNetworkState) -> None:
    """Serialize a TensorNetworkState (tensors + index wiring + graph)."""
    arrays = {}
    meta: dict = {"vertices": [], "edges": [], "inds": {}, "siteinds": []}
    index_ids: dict = {}

    def reg(i: Index) -> str:
        key = f"i{i.id}_{i.plev}"
        if key not in index_ids:
            index_ids[key] = {"dim": i.dim, "tags": list(map(str, i.tags)), "plev": i.plev, "id": i.id}
        return key

    for k, v in enumerate(tns.vertices()):
        meta["vertices"].append(repr(v))
        arrays[f"t{k}"] = tns[v].numpy()
        meta["inds"][f"t{k}"] = [reg(i) for i in tns[v].inds]
        meta["siteinds"].append([reg(i) for i in tns.siteinds(v)])
    vs = tns.vertices()
    pos = {v: i for i, v in enumerate(vs)}
    for e in tns.edges():
        meta["edges"].append([pos[e.src], pos[e.dst]])
    meta["index_table"] = index_ids
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez(_npz_path(path), **arrays)


def load_state(path: str, device=None) -> TensorNetworkState:
    """Load a :func:`save_state` file onto ``device``.  Every saved index
    gets a fresh id from this package's counter (its primed copies share
    it), so a loaded state never collides with one in memory."""
    dev = resolve_device(device)
    with np.load(_npz_path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        # One fresh base Index per *saved id*, plev variants derived via
        # setprime, so a saved index and its primed copy reload sharing a
        # single new id and prime/noprime still map between them.
        base_by_saved_id: dict = {}
        table = {}
        for key, info in meta["index_table"].items():
            base = base_by_saved_id.get(info["id"])
            if base is None:
                base = Index(dim=info["dim"], tags=tuple(info["tags"]))
                base_by_saved_id[info["id"]] = base
            table[key] = base.setprime(info["plev"])
        # Vertices are coordinate tuples / ints / strings; literal_eval only
        # (a checkpoint is data, not code).
        vertices = [ast.literal_eval(v) for v in meta["vertices"]]
        tensors = {}
        siteinds = {}
        for k, v in enumerate(vertices):
            inds = tuple(table[key] for key in meta["inds"][f"t{k}"])
            tensors[v] = from_array(data[f"t{k}"], inds, device=dev)
            siteinds[v] = [table[key] for key in meta["siteinds"][k]]
        g = NamedGraph(vertices)
        for (i, j) in meta["edges"]:
            g.add_edge_inplace(NamedEdge(vertices[i], vertices[j]))
        return TensorNetworkState(TensorNetwork(tensors, g), siteinds)
