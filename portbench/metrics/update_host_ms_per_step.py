"""Host time inside the program's ``su.group`` spans
(``engine.apply_color_group``) per wall step: the tracer on, no profiler
(``program_trace.host_pass``)."""

from portbench.program_trace import host_ms_per_step


def read(record):
    return host_ms_per_step(record, "su.group")
