"""Post-mortem analysis CLI: aggregate profiles into the PMS/CMS/trace
databases on the port's kernels::

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
``--compute cpu``.  The databases open with ``repro.query.Database``.

Prints one JSON summary: the reference's, plus ``device`` and, under
``timings``, ``device_launches`` — the launches of each kernel in the run,
in this process and its workers — and, under ``processes``,
``device_launches_workers``, the workers' share.
The reference's ``query`` and ``diagnose`` subcommands are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.runtime import available_executors


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
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


if __name__ == "__main__":
    main()
