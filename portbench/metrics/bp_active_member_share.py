"""Of the member-sweeps BP computes in a folded ensemble, the share whose
member had not yet stopped (``bp.member_sweeps_active`` over
``bp.member_sweeps_computed``, the program's counters over the host
pass): the rest is work done and thrown away."""

from portbench.program_trace import counter_ratio


def read(record):
    return counter_ratio(record, "bp.member_sweeps_active",
                         "bp.member_sweeps_computed")
