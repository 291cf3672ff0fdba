"""Of the Cholesky factors of the simple update's CholeskyQR passes, the
share that took a shifted factorization because the ridged one failed
(``qr.chol_shifted`` over ``qr.chol_factors``, the program's counters over
the host pass; ``engine._ridged_cholesky``)."""

from portbench.program_trace import counter_ratio


def read(record):
    return counter_ratio(record, "qr.chol_shifted", "qr.chol_factors")
