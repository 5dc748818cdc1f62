"""Analyzers: pure functions ``Database -> list[Finding]``.

Every analyzer here is **scatter-clean**: it reads only the summary-stats
section and the trace table of contents (plus, for occupancy gaps, the
trace segments of the profiles it is asked about) — data every shard of a
sharded server holds in full.  Each finding depends only on its own
context or profile plus *global* aggregates (metric totals, the fleet
median sample count) that are identical on every shard, so partitioning
the ctx/pid space across shards and concatenating the partial finding
lists reproduces the single-process answer exactly.

The exception is :func:`regression_findings`, which needs a baseline
fleet (a set of other databases) — that runs in the watch service and the
offline CLI, where the baselines live, not inside the serve op.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.loadbalance import imbalance_ratio
from repro_torch.diagnose.findings import Finding, severity_for, sort_findings
from repro_torch.query.database import Database
from repro_torch.query.diff import metric_stats_by_path
from repro_torch.query.timeline import samples_in_window

DEFAULT_ANALYZERS = ("imbalance", "straggler", "occupancy_gap")

# flat threshold knobs, overridable per request via the ``thresholds`` dict
DEFAULT_THRESHOLDS = {
    "imbalance": 2.0,     # flag ctx where max/mean >= this
    "min_share": 0.01,    # ...and the ctx carries >= 1% of the metric total
    "straggler": 1.5,     # flag ranks with >= 1.5x the median sample count
    "min_samples": 8,     # ignore ranks with fewer trace samples than this
    "gap_frac": 0.25,     # flag ranks idle for >= 25% of their active span
}


def _metric_label(metric, inclusive: bool) -> str:
    lab = metric if isinstance(metric, str) else str(int(metric))
    return f"{lab}:I" if inclusive and not lab.endswith(":I") else lab


def imbalance_findings(db: Database, metric=0, *, inclusive: bool = False,
                       threshold: float = 2.0, min_share: float = 0.01,
                       within_ctx: np.ndarray | None = None
                       ) -> list[Finding]:
    """Per-context load imbalance λ = max/mean from summary stats alone.

    The hot gate (``min_share`` of the *global* metric total) keeps noise
    contexts out; the total is computed before any ownership mask so every
    shard applies the identical gate.
    """
    try:
        ctx_ids, rows = db.metric_entries(metric, inclusive=inclusive)
    except (KeyError, ValueError, IndexError):
        return []
    if rows.size == 0:
        return []
    s = db.stats["sum"][rows].astype(np.float64)
    cnt = db.stats["count"][rows]
    vmax = db.stats["max"][rows]
    mean = db.stats["mean"][rows]
    total = float(s.sum())  # global — before masking, shard-invariant
    lam = imbalance_ratio(vmax, mean)
    share = s / total if total > 0 else np.zeros_like(s)
    elig = (cnt >= 2) & (share >= min_share) & (lam >= threshold)
    if within_ctx is not None:
        elig &= within_ctx[ctx_ids.astype(np.int64)]
    label = _metric_label(metric, inclusive)
    out: list[Finding] = []
    for i in np.flatnonzero(elig):
        c, l = int(ctx_ids[i]), float(lam[i])
        score = l / threshold
        out.append(Finding(
            kind="load_imbalance", severity=severity_for(score), score=score,
            ctx=c, path=db.path_of(c), metric=label, value=l,
            expected=threshold,
            message=(f"context {c} is {l:.2f}x imbalanced across "
                     f"{int(cnt[i])} profiles ({share[i]:.1%} of metric "
                     f"{label} total)"),
            evidence={"max": float(vmax[i]), "mean": float(mean[i]),
                      "count": int(cnt[i]), "share": float(share[i])}))
    return out


def straggler_findings(db: Database, *, threshold: float = 1.5,
                       min_samples: int = 8,
                       within_pid: np.ndarray | None = None
                       ) -> list[Finding]:
    """Ranks whose trace sample count dwarfs the fleet median.

    Under uniform sampling, sample count is proportional to active time,
    so a rank with 2x the median samples worked (or waited inside
    instrumented code) twice as long — the classic straggler signature.
    Reads only the trace toc: zero segment decodes.
    """
    counts = db.trace_lengths()
    if counts.size == 0:
        return []
    med = float(np.median(counts))  # global, identical on every shard
    ref = max(med, 1.0)
    ratio = counts / ref
    elig = (ratio >= threshold) & (counts >= min_samples)
    if within_pid is not None:
        elig &= within_pid[:counts.size]
    out: list[Finding] = []
    for p in np.flatnonzero(elig):
        p = int(p)
        score = float(ratio[p]) / threshold
        out.append(Finding(
            kind="straggler", severity=severity_for(score), score=score,
            pid=p, value=float(counts[p]), expected=ref * threshold,
            message=(f"rank {p} logged {int(counts[p])} trace samples, "
                     f"{ratio[p]:.2f}x the fleet median of {med:.0f}"),
            evidence={"samples": int(counts[p]), "median": med,
                      "ranks": int(counts.size)}))
    return out


def occupancy_gap_findings(db: Database, *, gap_frac: float = 0.25,
                           min_samples: int = 8,
                           within_pid: np.ndarray | None = None
                           ) -> list[Finding]:
    """Ranks with a large internal idle hole in their own activity.

    For each rank: the biggest gap between consecutive trace samples,
    relative to that rank's active span.  A 25% hole means the device sat
    idle (or uninstrumented) for a quarter of its run — the occupancy-gap
    shape GPU timelines surface visually, computed here from the samples.
    Decodes only the asked-about ranks' segments, so a shard pays for its
    own profiles only.
    """
    counts = db.trace_lengths()
    out: list[Finding] = []
    for p in range(counts.size):
        if counts[p] < min_samples:
            continue
        if within_pid is not None and not within_pid[p]:
            continue
        tr = samples_in_window(db, p, -np.inf, np.inf)
        t = np.asarray(tr.time, dtype=np.float64)
        if t.size < 2:
            continue
        span = float(t[-1] - t[0])
        if span <= 0.0:
            continue
        gaps = np.diff(t)
        gi = int(np.argmax(gaps))
        frac = float(gaps[gi]) / span
        score = frac / gap_frac
        if score < 1.0:
            continue
        out.append(Finding(
            kind="occupancy_gap", severity=severity_for(score), score=score,
            pid=p, value=frac, expected=gap_frac,
            t0=float(t[gi]), t1=float(t[gi + 1]),
            message=(f"rank {p} idle {float(gaps[gi]):.4f}s "
                     f"({frac:.0%} of its {span:.4f}s active span)"),
            evidence={"gap_s": float(gaps[gi]), "span_s": span,
                      "samples": int(counts[p])}))
    return out


def compute_findings(db: Database, *, analyzers=None, metric=None,
                     inclusive: bool = False, limit: int = 0,
                     thresholds: dict | None = None,
                     within_ctx: np.ndarray | None = None,
                     within_pid: np.ndarray | None = None) -> list[Finding]:
    """Run the scatter-clean analyzers and return one sorted finding list.

    This is the body of the serve-tier ``findings`` op: ``within_ctx`` /
    ``within_pid`` are the shard's ownership masks (None: everything), and
    the output ordering is the canonical :func:`sort_findings` order so a
    concat-and-resort merge is byte-identical to the unsharded answer.
    """
    chosen = tuple(analyzers) if analyzers else DEFAULT_ANALYZERS
    th = dict(DEFAULT_THRESHOLDS)
    for k, v in (thresholds or {}).items():
        if k not in th:
            raise ValueError(f"unknown threshold {k!r}; "
                             f"known: {sorted(th)}")
        th[k] = float(v)
    metric = 0 if metric is None else metric
    out: list[Finding] = []
    for name in chosen:
        if name == "imbalance":
            out += imbalance_findings(
                db, metric, inclusive=inclusive, threshold=th["imbalance"],
                min_share=th["min_share"], within_ctx=within_ctx)
        elif name == "straggler":
            out += straggler_findings(
                db, threshold=th["straggler"],
                min_samples=int(th["min_samples"]), within_pid=within_pid)
        elif name == "occupancy_gap":
            out += occupancy_gap_findings(
                db, gap_frac=th["gap_frac"],
                min_samples=int(th["min_samples"]), within_pid=within_pid)
        else:
            raise ValueError(f"unknown analyzer {name!r}; "
                             f"known: {list(DEFAULT_ANALYZERS)}")
    return sort_findings(out, limit or None)


def regression_findings(db: Database, baseline, metric=0, *,
                        stat: str = "sum", inclusive: bool = True,
                        z: float = 3.0, rel_margin: float = 0.05,
                        abs_margin: float = 0.0, min_value: float = 0.0,
                        flag_new_paths: bool = False, limit: int = 0
                        ) -> list[Finding]:
    """Diff one run against a baseline fleet's per-path noise bands.

    A path is flagged when its cost exceeds ``mean + max(z*std,
    rel_margin*mean, abs_margin)`` over the fleet — the band widens with
    observed baseline variance, so noisy paths need a bigger excursion to
    fire while a fleet of identical runs (std 0) flags any bump past the
    relative margin.  ``baseline`` is a :class:`~repro_torch.diagnose.baseline.
    BaselineFleet``.
    """
    bands = baseline.bands(metric, stat=stat, inclusive=inclusive)
    run = metric_stats_by_path(db, metric, stat, inclusive)
    label = _metric_label(metric, inclusive)
    out: list[Finding] = []
    for path, (ctx, v, _std) in run.items():
        band = bands.get(path)
        if band is None:
            if flag_new_paths and v > max(abs_margin, min_value):
                out.append(Finding(
                    kind="new_path", severity="info", score=0.0,
                    ctx=ctx, path=path, metric=label, value=v,
                    message=f"path absent from all {baseline.n_runs} "
                            f"baseline runs now costs {v:.4g}"))
            continue
        hi = band.hi(z=z, rel_margin=rel_margin, abs_margin=abs_margin)
        if v <= hi or v < min_value:
            continue
        width = max(hi - band.mean, 1e-12)
        score = (v - band.mean) / width
        ratio = v / band.mean if band.mean else float("inf")
        out.append(Finding(
            kind="regression", severity=severity_for(score), score=score,
            ctx=ctx, path=path, metric=label, value=v, expected=hi,
            message=(f"{path} costs {v:.4g}, {ratio:.2f}x its baseline "
                     f"mean {band.mean:.4g} (band limit {hi:.4g}, "
                     f"n={band.n})"),
            evidence={"baseline_mean": band.mean, "baseline_std": band.std,
                      "n_baseline": band.n, "ratio": ratio}))
    return sort_findings(out, limit or None)
