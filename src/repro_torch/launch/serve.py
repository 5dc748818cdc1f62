"""Serving launcher: batched LLM generation, the query service over HTTP,
live ingest and the regression watch.

Batched generation (no mode word) serves ``--requests`` random prompts of
``--prompt-len`` tokens, ``--new-tokens`` greedy tokens each, coalesced
into batches of ``--max-batch``, with parameters drawn from a seed in
``cfg.dtype``.  It runs on the card by default (``--device cuda``; a host
without one raises) and on the CPU with ``--device cpu``, for every model
family (the SSM and hybrid ones carry their recurrent states)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        [--reduced] [--requests 6] [--prompt-len 16] [--new-tokens 8] \
        [--max-batch 4] [--device cuda|cpu]

Query service over a completed analysis database::

    PYTHONPATH=src python -m repro_torch.launch.serve query-server runs/db \
        --port 8422 --max-batch 16 --max-wait-ms 2 --max-queue 256 \
        --cache-mb 64 [--warm-mb 32 | --no-warm] [--no-batching] \
        [--shards 4]

Query service *following* a live snapshot root (``db`` is the ingest
tier's output directory; the server picks up each published epoch without
restart)::

    PYTHONPATH=src python -m repro_torch.launch.serve query-server runs/live \
        --follow [--poll-ms 250] [--shards 4]

Multi-tenant front (many named databases behind one listener, per-tenant
admission budgets)::

    PYTHONPATH=src python -m repro_torch.launch.serve query-server \
        --tenant teamA=runs/a --tenant teamB=runs/b,queue=64 [--follow]

Live ingest endpoint (continuous uploads -> incremental aggregation ->
versioned snapshots under the root).  Each append's phase 2 and each
publish's CMS run on the card's kernels by default (``--compute device
--device cuda``, as ``repro_torch.launch.analyze`` does); a host without a
card raises, and ``--device cpu`` runs the kernels' plain versions,
``--compute cpu`` the numpy path::

    PYTHONPATH=src python -m repro_torch.launch.serve ingest runs/live \
        --port 8423 [--publish-every 64] [--retain 2] [--max-pending 256] \
        [--compute device|cpu] [--device cuda|cpu]

Regression watch (follow live roots, print one JSON findings report per
published epoch)::

    PYTHONPATH=src python -m repro_torch.launch.serve watch nightly=runs/live \
        --baseline runs/baselines [--metric 0] [--poll-ms 250]

Each server prints one JSON line with its URL, then blocks until SIGINT
or SIGTERM.  SIGTERM drains gracefully: the endpoint stops accepting new
work (new calls get a structured ``503 Draining``), in-flight work gets
``--drain-timeout-s`` to finish, recorded spans are exported if
``--obs-export`` asked for them, and the process exits 0 — the contract
an orchestrator's rolling restart relies on.

``query-server`` and ``watch`` only read databases: they import no torch
and need no card.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time


class _SignalWatch:
    """Two-phase signal wait: handlers are installed at construction —
    *before* the ready line is printed, because an orchestrator may
    SIGTERM the instant it sees it — and :meth:`wait` blocks until one
    arrives, restoring the previous handlers on the way out."""

    def __init__(self):
        self._got: dict = {}
        self._evt = threading.Event()
        self._old = {
            sig: signal.signal(sig, self._on)
            for sig in (signal.SIGTERM, signal.SIGINT)
        }

    def _on(self, signum, frame):
        self._got.setdefault("sig", signum)
        self._evt.set()

    def wait(self) -> str:
        try:
            while not self._evt.wait(0.5):
                pass
        finally:
            for sig, old in self._old.items():
                signal.signal(sig, old)
        return ("sigterm" if self._got.get("sig") == signal.SIGTERM
                else "sigint")


def _query_server_main(argv):
    from repro_torch.query import Database
    from repro_torch.serve.http import QueryHTTPServer

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve query-server")
    ap.add_argument("db", nargs="?", default=None,
                    help="database directory (db.pms [+ db.cms/db.trc]); "
                         "omit when using --tenant")
    ap.add_argument("--tenant", action="append", default=None,
                    metavar="NAME=PATH[,queue=N]",
                    help="serve a named database behind this front "
                         "(repeatable -> multi-tenant: per-tenant "
                         "admission queues and metric labels; queue=N "
                         "overrides --max-queue for that tenant). "
                         "PATH is a database dir, or a snapshot root "
                         "under --follow")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8422,
                    help="0 picks a free port (printed on startup)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="micro-batch window size cap")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="max stall collecting a window after its first "
                         "request arrives (default 0: opportunistic — "
                         "serve what is queued, never stall an idle "
                         "worker; small positive values trade latency "
                         "for fuller windows under sparse bursty traffic)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission queue bound (per shard when sharded); "
                         "overflow answers 429")
    ap.add_argument("--shards", type=int, default=0,
                    help="N > 0 serves from N worker processes (one "
                         "Database + plane cache each, consistent-hash "
                         "routed by plane, supervisor respawns dead "
                         "workers); 0 = single-process")
    ap.add_argument("--shard-slab-mb", type=int, default=4,
                    help="shm slab size for sharded plane payloads")
    ap.add_argument("--replicas", type=int, default=2,
                    help="R-way plane ownership when sharded: each plane "
                         "has R successor-distinct owner shards; reads "
                         "fail over (and optionally hedge) across them")
    ap.add_argument("--transport", default="shm", choices=["shm", "tcp"],
                    help="parent<->shard-worker peer link: shm queues + "
                         "slab payloads (same host, default) or "
                         "length-prefixed TCP framing")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="arm hedged reads: fire a duplicate at a live "
                         "replica after max(this, observed p99) and take "
                         "the first reply (default: off)")
    ap.add_argument("--max-connections", type=int, default=0,
                    help="cap concurrent keep-alive connections; beyond "
                         "it new connections get 429 + Retry-After "
                         "(0 = unlimited)")
    ap.add_argument("--drain-timeout-s", type=float, default=10.0,
                    help="SIGTERM grace: how long in-flight requests get "
                         "to finish before teardown")
    ap.add_argument("--no-adaptive-wait", action="store_true",
                    help="always hold batch windows for --max-wait-ms "
                         "instead of flushing when a worker idles")
    ap.add_argument("--workers", type=int, default=4,
                    help="window-serving workers on the runtime executor")
    ap.add_argument("--executor", default="threads",
                    choices=["threads", "serial"],
                    help="runtime backend for the serving loops")
    ap.add_argument("--cache-mb", type=int, default=64,
                    help="decoded-plane LRU budget")
    ap.add_argument("--warm-mb", type=int, default=None,
                    help="startup warming budget (default: 90%% of cache)")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip startup cache warming")
    ap.add_argument("--no-batching", action="store_true",
                    help="serve each HTTP call directly (baseline mode)")
    ap.add_argument("--timeout-s", type=float, default=30.0,
                    help="default per-request deadline")
    ap.add_argument("--follow", action="store_true",
                    help="treat the db argument as a live snapshot ROOT "
                         "(ingest output dir): open whatever CURRENT "
                         "points at and pick up new epochs without "
                         "restart")
    ap.add_argument("--poll-ms", type=float, default=250.0,
                    help="CURRENT-pointer poll interval under --follow")
    ap.add_argument("--follow-wait-s", type=float, default=60.0,
                    help="how long to wait for the first snapshot epoch "
                         "under --follow before giving up")
    ap.add_argument("--trace-ring", type=int, default=None,
                    help="flight-recorder ring capacity per process "
                         "(spans); 0 disables tracing, default: "
                         "REPRO_TRACE_RING or 2048")
    ap.add_argument("--obs-export", default=None, metavar="DIR",
                    help="on shutdown, export the recorded spans as a "
                         "trace-plane database under DIR (self-profiling: "
                         "analyze it with repro_torch.launch.analyze query)")
    args = ap.parse_args(argv)

    warm_bytes = (0 if args.no_warm
                  else None if args.warm_mb is None else args.warm_mb << 20)
    kwargs = dict(host=args.host, port=args.port,
                  batching=not args.no_batching,
                  max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                  max_queue=args.max_queue,
                  executor=args.executor, n_workers=args.workers,
                  default_timeout_s=args.timeout_s,
                  adaptive_wait=not args.no_adaptive_wait,
                  warm_bytes=warm_bytes, shards=args.shards,
                  shard_slab_bytes=args.shard_slab_mb << 20,
                  replicas=args.replicas, shard_transport=args.transport,
                  hedge_ms=args.hedge_ms,
                  max_connections=args.max_connections,
                  trace_ring=args.trace_ring)

    def _serve(srv, db):
        watch = _SignalWatch()
        info = {"url": srv.url, "batching": srv.batching,
                "shards": srv.shards, "replicas": args.replicas,
                "transport": args.transport, "profiles": db.n_profiles,
                "contexts": db.n_contexts, "warm": srv.warm_report}
        if srv.switcher is not None:
            info["epoch"] = srv.switcher.epoch
        if srv.multi_tenant:
            info["tenants"] = sorted(srv.tenants)
        print(json.dumps(info), flush=True)
        sig = watch.wait()
        if sig == "sigterm":
            report = srv.drain(timeout_s=args.drain_timeout_s)
            print(json.dumps({"drain": report}), file=sys.stderr, flush=True)
        print("shutting down", file=sys.stderr)
        if args.obs_export:
            from repro_torch.obs import recorder
            from repro_torch.obs.export import export_spans
            spans = recorder().snapshot()
            if spans:
                summary = export_spans(spans, args.obs_export)
                print(json.dumps({"obs_export": summary}),
                      file=sys.stderr, flush=True)
            else:
                print("obs-export: no spans recorded", file=sys.stderr)

    if bool(args.db) == bool(args.tenant):
        ap.error("pass a db directory or --tenant name=path (not both)")

    if args.tenant:
        from contextlib import ExitStack

        from repro_torch.serve.tenant import parse_tenant_arg
        specs = [parse_tenant_arg(s) for s in args.tenant]
        queues = {name: q for name, _, q in specs if q is not None}
        with ExitStack() as stack:
            if args.follow:
                # each tenant follows its own snapshot root
                tenants = {name: path for name, path, _ in specs}
            else:
                tenants = {
                    name: stack.enter_context(
                        Database(path, cache_bytes=args.cache_mb << 20))
                    for name, path, _ in specs}
            srv = stack.enter_context(QueryHTTPServer(
                tenants=tenants, tenant_queues=queues or None,
                follow=args.follow, poll_ms=args.poll_ms,
                follow_wait_s=args.follow_wait_s,
                follow_cache_bytes=args.cache_mb << 20, **kwargs))
            _serve(srv, srv.db)
    elif args.follow:
        with QueryHTTPServer(args.db, follow=True, poll_ms=args.poll_ms,
                             follow_wait_s=args.follow_wait_s,
                             follow_cache_bytes=args.cache_mb << 20,
                             **kwargs) as srv:
            _serve(srv, srv.db)
    else:
        with Database(args.db, cache_bytes=args.cache_mb << 20) as db, \
                QueryHTTPServer(db, **kwargs) as srv:
            _serve(srv, db)


def _ingest_main(argv):
    from repro_torch.core.aggregate import AggregationConfig
    from repro_torch.ingest import IngestHTTPServer

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve ingest")
    ap.add_argument("root", help="snapshot root (spool/ + epoch dirs + "
                                 "CURRENT live here)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8423,
                    help="0 picks a free port (printed on startup)")
    ap.add_argument("--executor", default="threads",
                    choices=["serial", "threads", "processes"],
                    help="runtime backend for incremental aggregation")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--max-pending", type=int, default=256,
                    help="spool backlog bound; overflow answers 429")
    ap.add_argument("--merge-batch", type=int, default=32,
                    help="max profiles folded into the state per merge")
    ap.add_argument("--publish-every", type=int, default=0,
                    help="auto-publish a snapshot each time this many new "
                         "profiles have merged (0 = only on /v1/publish)")
    ap.add_argument("--retain", type=int, default=2,
                    help="published epochs kept by GC (current and pinned "
                         "epochs always survive)")
    ap.add_argument("--max-body-mb", type=int, default=64,
                    help="largest accepted upload body")
    ap.add_argument("--no-traces", action="store_true",
                    help="skip the trace database in published snapshots")
    ap.add_argument("--drain-timeout-s", type=float, default=10.0,
                    help="SIGTERM grace: how long the merger gets to fold "
                         "the spooled backlog before teardown (anything "
                         "left is durable and recovered on restart)")
    ap.add_argument("--compute", default="device", choices=["device", "cpu"],
                    help="phase-2 and CMS hot-loop backend: the kernels, or "
                         "numpy")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --compute device runs: the CUDA kernels, or "
                         "their plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    cfg = AggregationConfig(executor=args.executor, n_workers=args.workers,
                            write_traces=not args.no_traces,
                            compute=args.compute, device=args.device)
    with IngestHTTPServer(args.root, host=args.host, port=args.port,
                          config=cfg, max_pending=args.max_pending,
                          merge_batch=args.merge_batch,
                          publish_every=args.publish_every,
                          retain=args.retain,
                          max_body_bytes=args.max_body_mb << 20) as srv:
        watch = _SignalWatch()
        cur = srv.store.current()
        print(json.dumps({"url": srv.url, "root": srv.root,
                          "epoch": cur[0] if cur else None,
                          "publish_every": srv.publish_every,
                          "retain": srv.retain}), flush=True)
        sig = watch.wait()
        if sig == "sigterm":
            report = srv.drain(timeout_s=args.drain_timeout_s)
            print(json.dumps({"drain": report}), file=sys.stderr, flush=True)
        print("shutting down", file=sys.stderr)


def _watch_main(argv):
    from repro_torch.diagnose import RegressionWatch, WatchTarget

    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve watch",
        description="Regression watch: follow live snapshot roots and "
                    "print one JSON report line per published epoch — "
                    "regressions vs a baseline fleet plus trace-derived "
                    "findings (imbalance, stragglers, occupancy gaps).")
    ap.add_argument("targets", nargs="+", metavar="NAME=ROOT",
                    help="snapshot roots to follow, e.g. nightly=runs/live")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="baseline fleet: a database dir, or a dir of "
                         "database dirs; per-context noise bands come "
                         "from its variance")
    ap.add_argument("--metric", default="0",
                    help="metric id or name to compare (default 0)")
    ap.add_argument("--stat", default="sum",
                    choices=["sum", "mean", "max", "min", "count"])
    ap.add_argument("--analyzers", default="imbalance,straggler,"
                                           "occupancy_gap",
                    help="comma-separated trace analyzers per epoch "
                         "('' = regression-only)")
    ap.add_argument("--poll-ms", type=float, default=250.0)
    ap.add_argument("--z", type=float, default=3.0,
                    help="noise-band width in baseline stddevs")
    ap.add_argument("--rel-margin", type=float, default=0.05,
                    help="relative margin floor under the z-band")
    ap.add_argument("--min-value", type=float, default=0.0,
                    help="ignore paths below this absolute value")
    ap.add_argument("--wait-s", type=float, default=60.0,
                    help="how long to wait for each target's first epoch")
    args = ap.parse_args(argv)

    metric = int(args.metric) if args.metric.lstrip("-").isdigit() \
        else args.metric
    analyzers = tuple(a for a in args.analyzers.split(",") if a)
    targets = []
    for spec in args.targets:
        name, sep, root = spec.partition("=")
        if not sep or not root:
            ap.error(f"targets must be NAME=ROOT, got {spec!r}")
        targets.append(WatchTarget(
            name=name, root=root, baseline=args.baseline, metric=metric,
            stat=args.stat, analyzers=analyzers, z=args.z,
            rel_margin=args.rel_margin, min_value=args.min_value))

    def on_report(report):
        print(json.dumps(report.as_dict()), flush=True)

    with RegressionWatch(targets, poll_ms=args.poll_ms, wait_s=args.wait_s,
                         on_report=on_report) as watch:
        watcher = _SignalWatch()
        print(json.dumps({"watching": sorted(t.name for t in targets),
                          "baseline": args.baseline,
                          "poll_ms": args.poll_ms}), file=sys.stderr,
              flush=True)
        watcher.wait()
        print(json.dumps({"status": watch.status()}), file=sys.stderr,
              flush=True)
    print("shutting down", file=sys.stderr)


def _generate_main(argv):
    from repro_torch.configs.base import get_arch, reduced

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where generation runs: the card (a host without "
                         "one raises), or the CPU")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    import numpy as np
    import torch

    from repro_torch.launch.train import resolve_device
    from repro_torch.models import params as P
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    device = resolve_device(args.device)
    model = build_model(cfg, device=device)
    P.from_reference(model, P.init_params(
        model.param_defs(), torch.Generator(device=device).manual_seed(0),
        cfg.dtype, device))
    eng = ServeEngine(model, max_len=args.prompt_len + args.new_tokens + 1,
                      max_batch=args.max_batch)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 args.prompt_len).astype(np.int32),
                    args.new_tokens) for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(o) for o in outs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s incl. first-call "
          f"set-up, on {device.type})")
    for i, o in enumerate(outs[:3]):
        print(f"req{i}: {o.tolist()}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "query-server":
        _query_server_main(argv[1:])
    elif argv and argv[0] == "ingest":
        _ingest_main(argv[1:])
    elif argv and argv[0] == "watch":
        _watch_main(argv[1:])
    else:
        _generate_main(argv)


if __name__ == "__main__":
    main()
