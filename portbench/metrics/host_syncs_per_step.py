"""Host-device synchronizations per wall step (CUDA sync debug mode over
the sync sub-window; the step's own read of ⟨Z⟩ to the host counts)."""


def read(record):
    s = record.syncs
    if not s or not s["steps"]:
        return None
    return s["count"] / s["steps"]
