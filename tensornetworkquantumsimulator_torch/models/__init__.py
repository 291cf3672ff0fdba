"""Gate matrices and local operators (numpy/scipy only)."""

from .gates import gate_matrix
from .sites import op_matrix, state_vector

__all__ = ["gate_matrix", "op_matrix", "state_vector"]
