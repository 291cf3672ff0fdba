"""Device time inside the colour-group simple-update spans
(``apply_color_group``) per wall step (CUDA event pairs over the window)."""


def read(record):
    spans = record.spans.get("group_update")
    if not spans or not record.steps:
        return None
    return sum(ms for ms, _ in spans) / record.steps
