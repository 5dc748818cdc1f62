"""Render analysis tables: dry-run/roofline JSONs and database reports.

Dry-run mode (EXPERIMENTS.md §Dry-run / §Roofline)::

    PYTHONPATH=src python -m repro_torch.analysis.report runs/dryrun

Database mode — every table is emitted through the :mod:`repro_torch.query`
engine (summary statistics + routed plane reads), never by hand-rolled
reader loops::

    PYTHONPATH=src python -m repro_torch.analysis.report --db runs/db \
        [--metric 3] [--topk 15] [--diff runs/db_b]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirpath: str) -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_bytes(b) -> str:
    return f"{b/2**30:.2f}"


def roofline_table(cells: list[dict], mesh: str) -> str:
    rows = [
        "| arch | shape | comp s | mem s | coll s | dominant | MODEL_TF | "
        "useful | MFU bound | mem GiB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("skipped") or c["mesh"] != mesh:
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} "
            f"| {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | **{r['dominant']}** "
            f"| {r['model_flops']/1e12:.1f} "
            f"| {r['useful_fraction']:.3f} | {r['mfu_bound']:.4f} "
            f"| {fmt_bytes(c['memory']['peak_per_device_bytes'])} "
            f"| {'Y' if c['memory']['fits_16GiB'] else 'N'} |")
    return "\n".join(rows)


def skip_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    seen = set()
    for c in cells:
        if c.get("skipped") and (c["arch"], c["shape"]) not in seen:
            seen.add((c["arch"], c["shape"]))
            rows.append(f"| {c['arch']} | {c['shape']} | {c['skipped']} |")
    return "\n".join(rows)


def dryrun_table(cells: list[dict]) -> str:
    rows = [
        "| arch | shape | mesh | HLO TF/chip | HBM GB/chip | coll GB/chip "
        "| collective mix | compile s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("skipped"):
            continue
        r = c["roofline"]
        mix = ", ".join(f"{k.replace('collective-','c-')}:{v/1e9:.1f}"
                        for k, v in sorted(c["collectives"].items(),
                                           key=lambda kv: -kv[1])[:3])
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {r['flops_per_chip']/1e12:.2f} "
            f"| {r['hbm_bytes_per_chip']/1e9:.1f} "
            f"| {r['collective_bytes_per_chip']/1e9:.2f} | {mix} "
            f"| {c['timings']['compile_s']:.0f} |")
    return "\n".join(rows)


def summary(cells: list[dict]) -> dict:
    live = [c for c in cells if not c.get("skipped")]
    doms = {}
    for c in live:
        doms[c["roofline"]["dominant"]] = doms.get(c["roofline"]["dominant"], 0) + 1
    fits = sum(c["memory"]["fits_16GiB"] for c in live)
    return {"cells": len(live), "skipped": len(cells) - len(live),
            "dominant": doms, "fits": fits}


# ---------------------------------------------------------------------------
# database reports — every row produced by the query engine
# ---------------------------------------------------------------------------

def _metric_label(db, mid: int) -> str:
    if db.registry is not None:
        try:
            return db.registry.name_of(mid)
        except KeyError:
            pass
    return str(mid)


def hot_paths_table(db, metric, k: int = 10, *, stat: str = "sum") -> str:
    """Top-k call paths by inclusive cost, with exclusive alongside."""
    from repro_torch.query import topk_hot_paths
    rows = [f"| rank | inclusive {stat} | exclusive {stat} | call path |",
            "|---|---|---|---|"]
    for r, hp in enumerate(topk_hot_paths(db, metric, k=k, inclusive=True,
                                          stat=stat), 1):
        rows.append(f"| {r} | {hp.value:.4g} | {hp.exclusive:.4g} "
                    f"| `{hp.path}` |")
    return "\n".join(rows)


def profile_table(db, metric=None) -> str:
    """Per-profile totals: one PMS plane read per row, no densification."""
    from repro_torch.core.metrics import INCLUSIVE_BIT
    from repro_torch.query import profile_aggregate
    mid = db.resolve_metric(metric) if metric is not None else None
    rows = ["| profile | identity | metrics | total |", "|---|---|---|---|"]
    for pid in range(db.n_profiles):
        mids, vals = profile_aggregate(db, pid)
        if mid is not None and mid & INCLUSIVE_BIT:
            # summing an inclusive metric over contexts double-counts every
            # subtree; the per-profile total of an inclusive metric is its
            # value at the root context
            total = float(db.profile_metrics(pid).lookup(0, mid))
        elif mid is not None:
            sel = vals[mids == mid]
            total = float(sel[0]) if sel.size else 0.0
        else:
            total = float(vals.sum())
        ident = db.identity(pid) or {}
        ident_s = ",".join(f"{k}={v}" for k, v in sorted(ident.items()))
        rows.append(f"| {pid} | {ident_s} | {mids.size} | {total:.4g} |")
    return "\n".join(rows)


def findings_table(findings) -> str:
    """Diagnosis findings as a markdown table, most severe first.

    Takes the :class:`~repro_torch.diagnose.Finding` list produced by
    :func:`~repro_torch.diagnose.compute_findings` /
    :func:`~repro_torch.diagnose.regression_findings` (already sorted)."""
    if not findings:
        return "No findings: everything within thresholds and noise bands."
    rows = ["| severity | kind | score | where | message |",
            "|---|---|---|---|---|"]
    for f in findings:
        where = f.path or (f"pid {f.pid}" if f.pid >= 0 else f"ctx {f.ctx}")
        rows.append(f"| {f.severity} | {f.kind} | {f.score:.2f} "
                    f"| `{where}` | {f.message} |")
    return "\n".join(rows)


def diff_table(db_a, db_b, metric, top: int = 10, *, stat: str = "sum") -> str:
    """Cross-run regression table aligned on the unified CCT."""
    from repro_torch.query import diff
    rows = [f"| delta {stat} | A | B | call path |", "|---|---|---|---|"]
    for e in diff(db_a, db_b, metric, stat=stat, top=top):
        rows.append(f"| {e.delta:+.4g} | {e.a:.4g} | {e.b:.4g} "
                    f"| `{e.path}` |")
    return "\n".join(rows)


def database_report(db_dir: str, *, metric=None, k: int = 10,
                    diff_dir: str | None = None) -> str:
    """Full markdown report for one database (optionally diffed vs another)."""
    from repro_torch.core.metrics import INCLUSIVE_BIT
    from repro_torch.query import Database
    sections = []
    with Database(db_dir) as db:
        mids = sorted(set(int(m) for m in db.stats.get("mid", [])
                          if not int(m) & INCLUSIVE_BIT))
        metric = mids[0] if metric is None and mids else metric
        sections.append(f"## Database {db_dir}\n")
        sections.append(json.dumps({
            "profiles": db.n_profiles, "contexts": db.n_contexts,
            "metrics": len(mids), "has_cms": db.has_cms,
            "has_traces": db.has_traces}))
        if metric is not None:
            label = _metric_label(db, db.resolve_metric(metric))
            sections.append(f"\n### Hot paths (metric {label})\n")
            sections.append(hot_paths_table(db, metric, k))
            sections.append("\n### Profiles\n")
            sections.append(profile_table(db, metric))
            if diff_dir is not None:
                with Database(diff_dir) as db_b:
                    sections.append(f"\n### Diff vs {diff_dir}\n")
                    sections.append(diff_table(db, db_b, metric, top=k))
    return "\n".join(sections)


def main():
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.report")
    ap.add_argument("dryrun_dir", nargs="?", default="runs/dryrun")
    ap.add_argument("--db", default=None,
                    help="render a database report instead of dry-run tables")
    ap.add_argument("--metric", default=None)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--diff", default=None,
                    help="second database directory for a cross-run diff")
    args = ap.parse_args()

    if args.db is not None:
        metric = args.metric
        if metric is not None:
            try:
                metric = int(metric)
            except ValueError:
                pass
        print(database_report(args.db, metric=metric, k=args.topk,
                              diff_dir=args.diff))
        return

    cells = load(args.dryrun_dir)
    print("## Summary\n", json.dumps(summary(cells)))
    print("\n## Roofline (single-pod 16x16, 256 chips)\n")
    print(roofline_table(cells, "16x16"))
    print("\n## Roofline (multi-pod 2x16x16, 512 chips)\n")
    print(roofline_table(cells, "2x16x16"))
    print("\n## Skips\n")
    print(skip_table(cells))
    print("\n## Dry-run detail\n")
    print(dryrun_table(cells))


if __name__ == "__main__":
    main()
