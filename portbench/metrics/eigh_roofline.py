"""The batched Hermitian eigendecompositions and environment roots handed
to ``engine._eigh`` and ``engine._pseudo_roots``: their least time on the
TF32 peak or the memory bandwidth (``roofline``), counted from the shapes
handed in, over the device time inside those spans, in %."""

from portbench.roofline import eigh_work, least_seconds, roots_work


def read(record):
    least, ms = 0.0, 0.0
    for kind, work in (("eigh", eigh_work), ("roots", roots_work)):
        for span_ms, (n, batch, itemsize) in record.spans.get(kind, ()):
            least += least_seconds(*work(n, batch, itemsize))
            ms += span_ms
    if ms <= 0:
        return None
    return 100.0 * least / (ms / 1e3)
