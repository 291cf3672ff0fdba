"""Graphs, lattices, schedules, argument checks (numpy/networkx only);
checkpoints and profiling in the submodules ``checkpoint`` and
``profiling``."""

from .checks import algorithm_check, collect_vertices, default_alg
from .graphs import (
    NamedEdge,
    NamedGraph,
    cycle_to_path,
    edge_color,
    edgeinduced_subgraphs_no_leaves,
    forest_cover_edge_sequence,
    unique_simplecycles_limited_length,
)
from .lattices import (
    build_graph_from_circuit,
    build_graph_from_gates,
    heavy_hexagonal_lattice,
    ibm_eagle_lattice,
    kagome_lattice,
    lieb_lattice,
    named_comb_tree,
    named_grid,
    named_hexagonal_lattice_graph,
    named_path_graph,
    topology_to_graph,
    triangular_lattice,
)

__all__ = [
    "NamedEdge",
    "NamedGraph",
    "algorithm_check",
    "build_graph_from_circuit",
    "build_graph_from_gates",
    "collect_vertices",
    "cycle_to_path",
    "default_alg",
    "edge_color",
    "edgeinduced_subgraphs_no_leaves",
    "forest_cover_edge_sequence",
    "heavy_hexagonal_lattice",
    "ibm_eagle_lattice",
    "kagome_lattice",
    "lieb_lattice",
    "named_comb_tree",
    "named_grid",
    "named_hexagonal_lattice_graph",
    "named_path_graph",
    "topology_to_graph",
    "triangular_lattice",
    "unique_simplecycles_limited_length",
]
