"""PyTorch port, the lattices of ``utils/lattices.py`` against the JAX
package, table for table as ``tests/test_torch_structure.py`` compares
them: the same vertex names in the same order, the same edges in the same
order, and the same slot tables compiled from them; and the graphs built
from adjacency lists and from circuits."""

import numpy as np
import pytest

from tensornetworkquantumsimulator_torch.parallel import structure as t_struct
from tensornetworkquantumsimulator_torch.utils import lattices as t_lat
from tensornetworkquantumsimulator_tpu.parallel import structure as j_struct
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

CASES = [
    ("lieb_lattice", (3, 3), {}),
    ("lieb_lattice", (5, 3), {}),
    ("lieb_lattice", (4, 4), dict(periodic=True)),
    ("triangular_lattice", (3, 4), {}),
    ("triangular_lattice", (3, 3), dict(periodic=True)),
    ("kagome_lattice", (2, 2), {}),
    ("kagome_lattice", (1, 3), {}),
    ("named_grid", ((3, 4),), {}),
    ("named_hexagonal_lattice_graph", (2, 3), {}),
    ("heavy_hexagonal_lattice", (2, 2), {}),
    ("named_comb_tree", ((3, 3),), {}),
    ("named_path_graph", (5,), {}),
]


def _table(g):
    return ([v for v in g.vertices()], [(e.src, e.dst) for e in g.edges()])


@pytest.mark.parametrize("name,args,kw", CASES)
def test_lattice_tables_equal(name, args, kw):
    gt = getattr(t_lat, name)(*args, **kw)
    gj = getattr(j_lat, name)(*args, **kw)
    assert _table(gt) == _table(gj)
    st, sj = t_struct.compile_graph(gt), j_struct.compile_graph(gj)
    for f in ("nbr_array", "nbr_slot_array", "mask_array"):
        np.testing.assert_array_equal(getattr(st, f)(), getattr(sj, f)())


def test_lattice_errors_and_degrees():
    for mod in (t_lat, j_lat):
        with pytest.raises(ValueError):
            mod.lieb_lattice(4, 4)
        with pytest.raises(ValueError):
            mod.triangular_lattice(2, 3, periodic=True)
    tri = t_lat.triangular_lattice(4, 4, periodic=True)
    assert all(tri.degree(v) == 6 for v in tri.vertices())
    kag = t_lat.kagome_lattice(2, 2)
    assert kag.max_degree() == 4 and kag.is_connected()
    assert (2, 2) not in t_lat.lieb_lattice(3, 3).vertices()


def test_topology_and_circuit_graphs():
    topo = [(1, 2), (2, 3), (3, 1), (3, 4)]
    assert _table(t_lat.topology_to_graph(topo)) == _table(
        j_lat.topology_to_graph(topo))
    circ = [("Rx", [1], 0.1), ("CZ", [1, 2]), ("CZ", [2, 3]),
            ("Rzz", [(1, 1), (1, 2)], 0.2)][:3]
    assert _table(t_lat.build_graph_from_circuit(circ)) == _table(
        j_lat.build_graph_from_gates(circ))
    grid = [("Rzz", [(1, 1), (1, 2)], 0.2), ("Rzz", ((1, 2), (2, 2)), 0.2),
            ("Rx", (1, 1), 0.3)]
    assert _table(t_lat.build_graph_from_gates(grid)) == _table(
        j_lat.build_graph_from_gates(grid))
    for mod in (t_lat, j_lat):
        with pytest.raises(ValueError, match="not connected"):
            mod.build_graph_from_gates([("CZ", [1, 2]), ("CZ", [3, 4])])
