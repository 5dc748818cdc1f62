"""Optimizer (``train/loop.py::apply_update``): the host's time issuing
AdamW a step, the Trainer's own ``train.update`` span (inside
``apply_update``, no synchronise); ``update_ms`` less this is the wait
for the card."""
from portbench import spans

UNIT = "ms"
probe = spans.snapshot


def read(rec):
    return spans.per_step(rec, "update_issue_ms", ("train.update",))
