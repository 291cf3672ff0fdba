"""Host time inside the program's ``bp.converge_read`` spans (the blocking
read of whether BP goes on, once per sweep in ``engine._fixed_point``) per
wall step: the host waiting for the device (``program_trace.host_pass``)."""

from portbench.program_trace import host_ms_per_step


def read(record):
    return host_ms_per_step(record, "bp.converge_read")
