"""Kernels, copies and memsets per wall step (torch.profiler, device
events only, over the traced sub-window)."""


def read(record):
    p = record.profile
    if not p or not p["steps"] or not p["device_ops"]:
        return None
    return p["device_ops"] / p["steps"]
