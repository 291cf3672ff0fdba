"""The benchmark's plain reference: a BP-gauged simple-update simulator in
plain PyTorch, written apart from the package under test and importing
nothing of it.  It runs the same Trotter step (one composed rotation per
site, then per colour group a BP refresh and the simple update of every
edge, then a final refresh) and reads ⟨Z⟩ per site from the BP
environments, in complex128 by default, or with every contraction's
operands rounded to TF32 as the lower-precision control."""

from .tns import Lattice, Reference, tf32_round

__all__ = ["Lattice", "Reference", "tf32_round"]
