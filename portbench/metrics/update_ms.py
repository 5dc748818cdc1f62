"""Optimizer (``train/optimizer.py`` through ``train/loop.py::
apply_update``): the AdamW update a step, to a synchronise, as the
benchmark's span around it measures it."""
UNIT = "ms"


def read(rec):
    s = rec["spans"].get("update")
    return sum(s) / len(s) * 1e3 if s else None
