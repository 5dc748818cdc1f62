"""Post-mortem analysis CLI on the port's kernels, plus the query engine.

Aggregate profiles into the PMS/CMS/trace databases::

    PYTHONPATH=src python -m repro_torch.launch.analyze runs/profiles/*.rprf \\
        --out runs/db [--executor threads|serial|processes|ranks] \\
        [--workers 4] [--ranks R] [--compute device|cpu] \\
        [--device cuda|cpu] [--heap] [--static-lb]

``--compute device`` (the default) runs phase 2's combine and propagation
and the CMS census and offsets on the kernels: on the CUDA card with
``--device cuda`` (the default; a host without one raises), or on their
plain PyTorch versions with ``--device cpu``.  ``--compute cpu`` is the
reference's numpy path.  Under ``--executor processes`` each worker
process runs the combine and propagation on its own device context, and
the pools start with ``spawn``.  ``--executor ranks`` (or ``--ranks R``)
is the multi-rank driver, which runs the numpy path only and so needs
``--compute cpu``.  The summary is the reference's, plus ``device`` and,
under ``timings``, ``device_launches`` — the launches of each kernel in
the run, in this process and its workers — and, under ``processes``,
``device_launches_workers``, the workers' share.

Query a completed database (``repro_torch.query`` front end; it reads
files only, so it runs on a host without a card)::

    PYTHONPATH=src python -m repro_torch.launch.analyze query runs/db \\
        topk --metric 3 -k 10 [--exclusive]
    ... query runs/db select --path-regex 'attn' --metric 3 --min 1.5
    ... query runs/db stripe --ctx 7 --metric 3
    ... query runs/db diff runs/db_b --metric 3 --top 20
    ... query runs/db window --pid 0 --t0 0.0 --t1 1.0

Diagnose a database (trace-derived findings, optionally regressions vs a
baseline fleet)::

    PYTHONPATH=src python -m repro_torch.launch.analyze diagnose runs/db \\
        [--baseline runs/baselines] [--metric 3] [--analyzers imbalance] \\
        [--markdown]

Every query subcommand prints one JSON document to stdout; ``diagnose
--markdown`` prints the findings table instead.  Databases open in Python
with :class:`repro_torch.query.Database`.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.runtime import available_executors


def _aggregate_main(argv):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.analyze")
    ap.add_argument("profiles", nargs="+")
    ap.add_argument("--out", default="runs/db")
    ap.add_argument("--executor", default=None,
                    choices=available_executors(),
                    help="aggregation runtime backend (default: threads); "
                         "'ranks' is the multi-rank MPI-analog driver and "
                         "needs --compute cpu")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker count (rank count for --executor ranks); "
                         "default: --threads")
    ap.add_argument("--threads", type=int, default=4,
                    help="legacy worker knob; threads-per-rank under ranks")
    ap.add_argument("--ranks", type=int, default=1,
                    help="legacy spelling of '--executor ranks --workers R'")
    ap.add_argument("--sink-window", type=int, default=None,
                    help="ordered-sink out-of-order plane bound "
                         "(default: 2 x workers; 0 = unbounded)")
    ap.add_argument("--heap", action="store_true",
                    help="paper-faithful heap-merge CMS gather")
    ap.add_argument("--static-lb", action="store_true",
                    help="static context groups instead of GLB")
    ap.add_argument("--no-cms", action="store_true")
    ap.add_argument("--no-traces", action="store_true")
    ap.add_argument("--compute", default="device", choices=["device", "cpu"],
                    help="phase-2 hot-loop backend: the kernels, or numpy "
                         "(the only one under ranks)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --compute device runs: the CUDA kernels, or "
                         "their plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    executor = args.executor or "threads"
    workers = args.workers
    if args.ranks > 1:
        if args.executor not in (None, "ranks"):
            ap.error("--ranks selects the rank driver; it cannot combine "
                     "with a different --executor")
        executor = "ranks"
        workers = args.ranks if workers is None else workers
    cfg = AggregationConfig(
        n_threads=args.threads,
        executor=executor,
        n_workers=workers,
        sink_window=args.sink_window,
        cms_strategy="heap" if args.heap else "vectorized",
        cms_balance="static" if args.static_lb else "dynamic",
        write_cms=not args.no_cms,
        write_traces=not args.no_traces,
        compute=args.compute,
        device=args.device,
    )
    res = StreamingAggregator(args.out, cfg).run(args.profiles)
    runtime = (f"ranks={cfg.workers}x{args.threads}t"
               if executor == "ranks" else executor)
    print(json.dumps({
        "pms": res.pms_path, "cms": res.cms_path, "traces": res.trace_path,
        "executor": runtime, "workers": cfg.workers,
        "compute": cfg.compute,
        "device": cfg.device if cfg.compute == "device" else None,
        "profiles": res.n_profiles, "contexts": res.n_contexts,
        "values": res.n_values, "sizes": res.sizes,
        "timings": {k: round(v, 4) if isinstance(v, float) else v
                    for k, v in res.timings.items()},
    }, indent=2))


# ---------------------------------------------------------------------------
# query front end
# ---------------------------------------------------------------------------

def _metric_arg(ap):
    ap.add_argument("--metric", required=True,
                    help="metric id (int) or registry name; ':I' suffix or "
                         "--inclusive selects the propagated variant")
    ap.add_argument("--inclusive", action="store_true")
    ap.add_argument("--stat", default="sum",
                    choices=["sum", "mean", "min", "max", "count", "std"])


def _parse_metric(v: str):
    try:
        return int(v)
    except ValueError:
        return v


def _query_main(argv):
    from repro_torch.query import (Database, diff, occupancy,
                                   samples_in_window, select_contexts,
                                   threshold_contexts, topk_hot_paths)

    ap = argparse.ArgumentParser(prog="repro_torch.launch.analyze query")
    ap.add_argument("db", help="database directory (db.pms [+ db.cms/db.trc])")
    sub = ap.add_subparsers(dest="op", required=True)

    p = sub.add_parser("topk", help="k hottest call paths")
    _metric_arg(p)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--exclusive", action="store_true",
                   help="rank by exclusive instead of inclusive cost")

    p = sub.add_parser("select", help="contexts by path predicate / threshold")
    _metric_arg(p)
    p.add_argument("--path-regex", default=None)
    p.add_argument("--min", type=float, default=0.0,
                   help="summary-stat threshold (default 0: all non-zeros)")

    p = sub.add_parser("stripe", help="one metric of one context, all profiles")
    _metric_arg(p)
    p.add_argument("--ctx", type=int, required=True)

    p = sub.add_parser("diff", help="cross-run regression diff")
    p.add_argument("db_b", help="second database directory")
    _metric_arg(p)
    p.add_argument("--top", type=int, default=20)

    p = sub.add_parser("window", help="trace samples + occupancy in a window")
    p.add_argument("--pid", type=int, default=None,
                   help="restrict to one profile (default: all, occupancy only)")
    p.add_argument("--t0", type=float, required=True)
    p.add_argument("--t1", type=float, required=True)
    p.add_argument("--top", type=int, default=10)

    args = ap.parse_args(argv)
    with Database(args.db) as db:
        if args.op == "topk":
            rows = topk_hot_paths(db, _parse_metric(args.metric), k=args.k,
                                  inclusive=not args.exclusive, stat=args.stat)
            out = {"op": "topk", "rows": [h.as_dict() for h in rows]}
        elif args.op == "select":
            within = (select_contexts(db, path_regex=args.path_regex)
                      if args.path_regex else None)
            ctx, vals = threshold_contexts(
                db, _parse_metric(args.metric), min_value=args.min,
                stat=args.stat, inclusive=args.inclusive, within=within)
            out = {"op": "select",
                   "rows": [{"ctx": int(c), "path": db.path_of(int(c)),
                             args.stat: float(v)}
                            for c, v in zip(ctx, vals)]}
        elif args.op == "stripe":
            prof, vals = db.stripe(args.ctx, _parse_metric(args.metric),
                                   inclusive=args.inclusive)
            out = {"op": "stripe", "ctx": args.ctx,
                   "path": db.path_of(args.ctx),
                   "profiles": [int(p) for p in prof],
                   "values": [float(v) for v in vals]}
        elif args.op == "diff":
            with Database(args.db_b) as db_b:
                rows = diff(db, db_b, _parse_metric(args.metric),
                            stat=args.stat, inclusive=args.inclusive,
                            top=args.top)
                out = {"op": "diff", "rows": [e.as_dict() for e in rows]}
        elif args.op == "window":
            ctx, counts = occupancy(
                db, args.t0, args.t1,
                pids=None if args.pid is None else [args.pid])
            order = (-counts).argsort(kind="stable")[:args.top]
            out = {"op": "window", "t0": args.t0, "t1": args.t1,
                   "n_samples": int(counts.sum()),
                   "occupancy": [{"ctx": int(ctx[i]),
                                  "path": db.path_of(int(ctx[i])),
                                  "samples": int(counts[i])}
                                 for i in order]}
            if args.pid is not None:
                win = samples_in_window(db, args.pid, args.t0, args.t1)
                out["pid"] = args.pid
                out["times"] = [float(t) for t in win.time[:1000]]
        print(json.dumps(out, indent=2))


def _diagnose_main(argv):
    from repro_torch.analysis.report import findings_table
    from repro_torch.diagnose import (DEFAULT_ANALYZERS, BaselineFleet,
                                      compute_findings, regression_findings,
                                      sort_findings)
    from repro_torch.query import Database

    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.analyze diagnose",
        description="Run the diagnosis analyzers over a database: "
                    "trace-derived findings (load imbalance, stragglers, "
                    "occupancy gaps) plus, with --baseline, regressions "
                    "against a baseline fleet's noise bands.")
    ap.add_argument("db", help="database directory (db.pms [+ db.trc])")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="baseline fleet: a database dir, or a dir of "
                         "database dirs")
    ap.add_argument("--metric", default="0",
                    help="metric id (int) or registry name")
    ap.add_argument("--stat", default="sum",
                    choices=["sum", "mean", "min", "max", "count"])
    ap.add_argument("--inclusive", action="store_true")
    ap.add_argument("--analyzers", default=",".join(DEFAULT_ANALYZERS),
                    help="comma-separated trace analyzers "
                         "('' = regression-only)")
    ap.add_argument("--z", type=float, default=3.0,
                    help="noise-band width in baseline stddevs")
    ap.add_argument("--rel-margin", type=float, default=0.05,
                    help="relative margin floor under the z-band")
    ap.add_argument("--min-value", type=float, default=0.0,
                    help="ignore paths below this absolute value")
    ap.add_argument("--limit", type=int, default=0,
                    help="keep only the N most severe findings")
    ap.add_argument("--markdown", action="store_true",
                    help="print a findings table instead of JSON")
    args = ap.parse_args(argv)

    metric = _parse_metric(args.metric)
    analyzers = tuple(a for a in args.analyzers.split(",") if a)
    findings = []
    with Database(args.db) as db:
        if args.baseline:
            with BaselineFleet.from_dir(args.baseline) as fleet:
                findings += regression_findings(
                    db, fleet, metric, stat=args.stat,
                    inclusive=args.inclusive, z=args.z,
                    rel_margin=args.rel_margin, min_value=args.min_value)
        if analyzers:
            findings += compute_findings(db, analyzers=analyzers,
                                         metric=metric,
                                         inclusive=args.inclusive)
    findings = sort_findings(findings, args.limit or None)
    if args.markdown:
        print(findings_table(findings))
    else:
        print(json.dumps({"op": "diagnose", "db": args.db,
                          "baseline": args.baseline,
                          "count": len(findings),
                          "findings": [f.as_dict() for f in findings]},
                         indent=2))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "query":
        _query_main(argv[1:])
    elif argv and argv[0] == "diagnose":
        _diagnose_main(argv[1:])
    else:
        _aggregate_main(argv)


if __name__ == "__main__":
    main()
