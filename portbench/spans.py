"""The Trainer's own spans (``repro_torch.train.loop.TRAIN_SPANS``, op
``"train"``, in the process flight recorder), as the per-layer metrics
that read them see them.

A metric's ``probe`` is :func:`snapshot`: the recorder's training spans
as plain data, or None without any (a program that records none).  Its
``read`` is :func:`per_step` or :func:`counter`: the mean a step over the
window's steps, ``FOLLOWED <= step < FOLLOWED + steps``, or None.  A
step is its latest ``train.step`` span, with the spans of the same step
that lie inside it, so spans left in the recorder by another Trainer
are not counted.  A window of which the recorder (a ring,
``REPRO_TRACE_RING`` spans) no longer holds every step reads None: a
mean over part of it would pass for the whole.
"""
from __future__ import annotations

#: seconds of slack on "inside": two clock reads in a row may be equal
EPS = 1e-6


def snapshot(live) -> list[dict] | None:
    """The recorder's spans of op ``"train"``: name, step, start, seconds
    and attributes."""
    from repro_torch import obs
    out = [{"name": s.name, "step": s.attrs["step"], "t0": s.t0,
            "dur": s.dur, "attrs": dict(s.attrs)}
           for s in obs.recorder().snapshot()
           if s.op == "train" and s.attrs and "step" in s.attrs]
    return out or None


def window_steps(spans: list[dict] | None,
                 steps: int) -> list[tuple[dict, list[dict]]] | None:
    """``(train.step span, the spans inside it)`` of each window step,
    or None unless every one of the ``steps`` is there."""
    from portbench.traffic.train import FOLLOWED
    lo, hi = FOLLOWED, FOLLOWED + steps
    whole = {}
    for s in spans or ():
        if s["name"] == "train.step" and lo <= s["step"] < hi:
            whole[s["step"]] = s  # the latest of a step wins
    if not steps or len(whole) != steps:
        return None
    out = []
    for n, w in sorted(whole.items()):
        end = w["t0"] + w["dur"]
        out.append((w, [s for s in spans if s["step"] == n and s is not w
                        and w["t0"] - EPS <= s["t0"]
                        and s["t0"] + s["dur"] <= end + EPS]))
    return out


def per_step(rec: dict, metric: str, names: tuple[str, ...]) -> float | None:
    """Milliseconds a window step spent in the spans ``names``, on mean."""
    found = window_steps(rec["probes"].get(metric), rec["steps"])
    if not found:
        return None
    total = sum(s["dur"] for _, inner in found for s in inner
                if s["name"] in names)
    return total / len(found) * 1e3


def counter(rec: dict, metric: str, key: str) -> float | None:
    """The mean a window step of ``train.step``'s attribute ``key``, or
    None unless every window step has it (off the card none has)."""
    found = window_steps(rec["probes"].get(metric), rec["steps"])
    if not found or any(key not in w["attrs"] for w, _ in found):
        return None
    return sum(w["attrs"][key] for w, _ in found) / len(found)
