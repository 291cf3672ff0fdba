"""Calls of ``engine.bp_iteration`` per wall step over the window: an
exact count; in a folded ensemble the slowest member sets it."""


def read(record):
    if not record.steps or "bp_sweep" not in record.counts:
        return None
    return record.counts["bp_sweep"] / record.steps
