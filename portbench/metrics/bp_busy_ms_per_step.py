"""Device time of the kernels, copies and memsets launched inside the
program's ``bp.update`` spans (``engine.bp_update``) per wall step
(``program_trace.device_pass``: the profiler's launch correlation)."""

from portbench.program_trace import busy_ms_per_step


def read(record):
    return busy_ms_per_step(record, "bp.update")
