"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's, and the profile it wrote against
the steps it ran.

Numbers compared, each a gap that must not pass its limit:

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  steps followed;
* ``grad_gap``: the worst leaf's ``|g - g_ref|``, ``g`` the norm of the
  first gradient as the optimizer gets it, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of each leaf's change over the steps followed,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move under Adam by round-off alone);
* ``grad_gap_median``: the median leaf's ``grad_gap``, steady where a
  few small leaves make the worst one noisy;
* ``grad_diff``: by the worst leaf, the norm of the difference of the
  two first gradients over a fixed sample of the leaf's elements
  (:func:`sample`), over the larger of the reference's norm of that
  sample and of the median leaf's: the norms above move only to second
  order under rounding noise, the difference to first;
* ``change_diff``: the same of each leaf's change, over the leaves that
  ``change_gap`` counts;
* ``final_norm_grad_diff``: ``grad_diff`` of the final norm's weights,
  the leaf next to the loss: steady from seed to seed, and first order
  in the forward pass's precision;
* ``profile_steps_gap``: trace samples in the profile less steps run;
* ``profile_time_gap``: the profile's total ``host.step_time`` less the
  sum of the steps' own times, relative: exact, since the sum is taken as
  the Profiler takes it, one step after another in the steps' order
  (Python's ``sum()`` of floats is compensated, and differs from that by
  a rounding on some runs).
"""
from __future__ import annotations

import math
import statistics

import torch

MOVED = 1e-3
SAMPLE = 65536
TRAINING = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap",
            "grad_diff", "change_diff", "final_norm_grad_diff")
LEAVES = ("grad_leaf", "change_leaf", "grad_diff_leaf", "change_diff_leaf")


def sample(t: torch.Tensor) -> torch.Tensor:
    """A fixed sample of ``t``'s elements, float32 on the host: every
    ``numel // SAMPLE``-th of the flattened tensor, at most ``SAMPLE``."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // SAMPLE)][:SAMPLE].float().cpu()


def _gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's ``|a - b| / max(b, median leaf's b)`` of two norms."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            if math.isfinite(prog[n]) else math.inf for n in names}


def _diffs(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's ``|a - b| / max(|b|, median leaf's |b|)`` over its
    sample."""
    norms = {n: float(torch.linalg.vector_norm(ref[n])) for n in names}
    med = statistics.median(norms.values())
    return {n: float(torch.linalg.vector_norm(prog[n] - ref[n]))
            / max(norms[n], med, 1e-30) for n in names}


def _top(d: dict) -> tuple[float, str]:
    at = max(d, key=lambda n: d[n] if math.isfinite(d[n]) else math.inf)
    return d[at], at


def gaps(prog: dict, ref: dict) -> dict:
    """The training gaps (module docstring) of two readings, the leaf each
    worst gap came from, and each leaf's differences."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["loss"], ref["loss"], strict=True)]
    gmed = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= MOVED * gmed]
    gg = _gaps(prog["grad"], ref["grad"], ref["grad"])
    cg = _gaps(prog["change"], ref["change"], moved)
    gd = _diffs(prog["grad_sample"], ref["grad_sample"], ref["grad"])
    cd = _diffs(prog["change_sample"], ref["change_sample"], moved)
    median = statistics.median(gg.values())
    return {"loss_gap": max(losses), "grad_gap": _top(gg)[0],
            "grad_gap_median": median if math.isfinite(median) else math.inf,
            "change_gap": _top(cg)[0], "grad_diff": _top(gd)[0],
            "change_diff": _top(cd)[0], "final_norm_grad_diff": gd["final_norm"],
            "grad_leaf": _top(gg)[1], "change_leaf": _top(cg)[1],
            "grad_diff_leaf": _top(gd)[1], "change_diff_leaf": _top(cd)[1],
            "leaf_grad_diff": gd, "leaf_change_diff": cd}


def profile_gaps(profile: dict, steps: int, step_times: list[float]) -> dict:
    total = profile["totals"].get("host.step_time", 0.0)
    want = 0.0
    for t in step_times:
        want += float(t)
    return {"profile_steps_gap": abs(profile["samples"] - steps),
            "profile_time_gap": abs(total - want) / want}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over every limit, each
    number within its limit (a NaN is not)."""
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared
