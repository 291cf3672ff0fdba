"""K2's cluster path (``jacobi_eigh`` at n = 256, a cluster of 8 CTAs a
matrix, and its polish): the batched Hermitian eigendecompositions of
order 256 handed to ``engine._eigh`` (the Gram split at χ = 64), their
least time on the TF32 peak or the memory bandwidth (``roofline.eigh_work``)
over the device time inside those spans, in %.  Other orders (the n = 64
environment roots, which run inside ``_pseudo_roots``' spans) are left
out."""

from portbench.roofline import eigh_work, least_seconds

ORDER = 256


def read(record):
    least, ms = 0.0, 0.0
    for span_ms, (n, batch, itemsize) in record.spans.get("eigh", ()):
        if n != ORDER:
            continue
        least += least_seconds(*eigh_work(n, batch, itemsize))
        ms += span_ms
    if ms <= 0:
        return None
    return 100.0 * least / (ms / 1e3)
