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
``device`` (None: the package default).  The orbax per-shard checkpoints
of a mesh-sharded state (``save_sharded_state``) belong to the sharded
engine, which this package does not have yet.
"""

from __future__ import annotations

import ast
import json

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
