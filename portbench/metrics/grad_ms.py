"""Model step (``train/loop.py::make_grad_fn`` over the model): the
Trainer's ``grad_fn`` a step, to a synchronise, as the benchmark's span
around it measures it."""
UNIT = "ms"


def read(rec):
    s = rec["spans"].get("grad")
    return sum(s) / len(s) * 1e3 if s else None
