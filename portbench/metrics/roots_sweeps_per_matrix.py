"""Jacobi sweeps per matrix of K1 (``jacobi_pseudo_roots``), from the
kernel's own count of each matrix's sweeps, summed on the device over the
host pass (``jacobi.roots_sweeps`` over ``jacobi.roots_matrices``)."""

from portbench.program_trace import counter_ratio


def read(record):
    return counter_ratio(record, "jacobi.roots_sweeps",
                         "jacobi.roots_matrices")
