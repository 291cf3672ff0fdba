"""The benchmark's own lattices, as vertex names and edge lists.

Each builder returns ``(vertices, edges)`` with the vertex names and edge
order of the package's constructors of the same lattice (``named_grid``,
``ibm_eagle_lattice``), so the two can be compared name by name.  The
harness hands the package these edges and checks that its lattice has
exactly them; the reference builds its slot tables from them.

A configuration also states the circuit's gate order, its edge colour
groups, as data (``colour_groups``: indices into the edge list of
:func:`build`), which :func:`colouring` turns into edges; no string hash
and nothing of the package enters it."""

from __future__ import annotations

import itertools


def grid(dims):
    """Open grid with 1-based tuple vertices, edges to +1 along each axis."""
    dims = tuple(dims)
    vertices = list(itertools.product(*[range(1, n + 1) for n in dims]))
    edges = []
    for v in vertices:
        for axis, n in enumerate(dims):
            if v[axis] < n:
                w = list(v)
                w[axis] += 1
                edges.append((v, tuple(w)))
    return vertices, edges


def ibm_eagle():
    """IBM Eagle's 127-qubit heavy-hex lattice: 7 rows of 14 or 15 qubits
    on columns 0-14, bridged every 4 columns with alternating offset by
    qubits at (row + 0.5, col); 144 edges."""
    vertices, edges = [], []
    cols_of = {0: range(0, 14), 6: range(1, 15)}
    for r in range(7):
        prev = None
        for c in cols_of.get(r, range(0, 15)):
            vertices.append((r, c))
            if prev is not None:
                edges.append((prev, (r, c)))
            prev = (r, c)
    have = set(vertices)
    for r in range(6):
        for c in range(0 if r % 2 == 0 else 2, 15, 4):
            if (r, c) in have and (r + 1, c) in have:
                b = (r + 0.5, c)
                vertices.append(b)
                edges += [((r, c), b), (b, (r + 1, c))]
    return vertices, edges


def _name(v):
    return tuple(v) if isinstance(v, list) else v


def build(spec: dict):
    """``{"kind": "grid", "dims": [5, 5]}``, ``{"kind": "ibm_eagle"}``, or
    any lattice as data: ``{"kind": "edges", "vertices": [...], "edges":
    [[u, v], ...]}`` (a list as a name becomes a tuple)."""
    if spec["kind"] == "grid":
        return grid(spec["dims"])
    if spec["kind"] == "ibm_eagle":
        return ibm_eagle()
    if spec["kind"] == "edges":
        return ([_name(v) for v in spec["vertices"]],
                [(_name(u), _name(v)) for u, v in spec["edges"]])
    raise ValueError(f"unknown lattice {spec['kind']!r}")


def colouring(config: dict, edges) -> list:
    """The configuration's colour groups, in order, as lists of edges."""
    return [[edges[i] for i in group] for group in config["colour_groups"]]
