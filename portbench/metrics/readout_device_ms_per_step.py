"""Device time inside the all-site ⟨Z⟩ readout span per wall step (CUDA
event pairs over the window; the copy to the host is outside it)."""


def read(record):
    spans = record.spans.get("readout")
    if not spans or not record.steps:
        return None
    return sum(ms for ms, _ in spans) / record.steps
