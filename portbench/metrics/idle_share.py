"""Device (H100): the share of the traced steps' window in which no
device activity ran (``torch.profiler``'s CUDA activity, merged)."""
UNIT = "%"


def read(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
