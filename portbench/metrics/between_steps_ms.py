"""Trainer (``train/loop.py::Trainer``): the window's time outside the
steps the Trainer times itself (data, the loss's readback, the hook), a
step: ``(window - sum of step_time) / steps``."""
UNIT = "ms"


def read(rec):
    if not rec["steps"]:
        return None
    return (rec["window_s"] - sum(rec["step_time_s"])) / rec["steps"] * 1e3
