"""Host-side graph and lattice helpers (numpy/networkx only)."""

from .graphs import NamedEdge, NamedGraph, edge_color
from .lattices import heavy_hexagonal_lattice, ibm_eagle_lattice, named_grid

__all__ = [
    "NamedEdge",
    "NamedGraph",
    "edge_color",
    "heavy_hexagonal_lattice",
    "ibm_eagle_lattice",
    "named_grid",
]
