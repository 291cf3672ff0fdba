"""Device time inside the ``bp_update`` spans per wall step (CUDA event
pairs over the window)."""


def read(record):
    spans = record.spans.get("bp_update")
    if not spans or not record.steps:
        return None
    return sum(ms for ms, _ in spans) / record.steps
