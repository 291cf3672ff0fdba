"""K3 (``cuda_bp.bp_outgoing_d3``), the degree-3 outgoing-message
contraction of BP: its least time on the TF32 peak or the memory bandwidth
(``roofline.message_work``, from the shapes handed to
``engine._outgoing_messages``) over the device time inside those spans, in
%.  Only degree-3 states count (D = 3, the shapes K3 takes); on a cell with
``TNQS_BP_KERNEL=1`` whose lattice has degree 3, those spans are K3 alone."""

from portbench.roofline import least_seconds, message_work


def read(record):
    least, ms = 0.0, 0.0
    for span_ms, (shape, itemsize) in record.spans.get("bp_message", ()):
        if len(shape) - 2 != 3:
            continue
        least += least_seconds(*message_work(shape, itemsize))
        ms += span_ms
    if ms <= 0:
        return None
    return 100.0 * least / (ms / 1e3)
