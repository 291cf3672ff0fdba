"""Jacobi sweeps per matrix of K2 (``jacobi_eigh``), from the kernel's own
count of each matrix's sweeps, summed on the device over the host pass
(``jacobi.eigh_sweeps`` over ``jacobi.eigh_matrices``)."""

from portbench.program_trace import counter_ratio


def read(record):
    return counter_ratio(record, "jacobi.eigh_sweeps", "jacobi.eigh_matrices")
