"""Model step (``train/loop.py::make_grad_fn``): the host's time issuing
the forward and backward a step, the Trainer's own ``train.grad`` span
(inside ``grad_fn``, no synchronise); ``grad_ms`` less this is the wait
for the card."""
from portbench import spans

UNIT = "ms"
probe = spans.snapshot


def read(rec):
    return spans.per_step(rec, "grad_issue_ms", ("train.grad",))
