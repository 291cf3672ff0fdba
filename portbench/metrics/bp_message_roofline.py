"""The outgoing-message contraction of BP (``engine._outgoing_messages``;
K3 on Eagle, einsums on the grid): its least time on the TF32 peak or the
memory bandwidth (``roofline.message_work``, from the shapes handed in),
over the device time inside those spans, in %."""

from portbench.roofline import least_seconds, message_work


def read(record):
    least, ms = 0.0, 0.0
    for span_ms, (shape, itemsize) in record.spans.get("bp_message", ()):
        least += least_seconds(*message_work(shape, itemsize))
        ms += span_ms
    if ms <= 0:
        return None
    return 100.0 * least / (ms / 1e3)
