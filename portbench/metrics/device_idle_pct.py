"""Share of the traced sub-window in which the device runs no kernel,
copy or memset, in % (torch.profiler, device events only)."""


def read(record):
    p = record.profile
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
