"""The harness: finds a cell's files by name, checks the card, runs the
cell's traffic, reads the per-layer metrics, checks the imports and
prints the result.

A cell ``<cell>`` is ``portbench/workloads/<cell>.json``: its
configuration's name, its traffic kind, its chips and its parameters.  The
configuration is ``portbench/configs/<config>.json``; the traffic kind is
the module ``portbench/traffic/<traffic>.py`` (``run(ctx) -> result``);
each per-layer metric is ``portbench/metrics/<metric>.py`` (``read(record)
-> value or None``, and optionally ``probe(live) -> data or None``, run in
a traced run once the window has closed).  Adding any of them is adding a
file and an entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    """What a traffic kind is given."""
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    metrics: dict = field(default_factory=dict)


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def metric_modules() -> dict:
    """``{metric name: module}`` of every file under portbench/metrics."""
    pkg = importlib.import_module("portbench.metrics")
    return {m.name: importlib.import_module(f"portbench.metrics.{m.name}")
            for m in pkgutil.iter_modules(pkg.__path__)}


def foreign_modules() -> list[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FOREIGN)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args, t0: float, device: str = "cuda") -> Context:
    wl = load_json("workloads", args.workload)
    cfg = load_json("configs", wl["config"])
    return Context(wl, cfg, args.seed, args.seconds, bool(args.trace), device,
                   t0, metric_modules())


def report(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        ctx = context(args, t0)
        import repro_torch  # noqa: F401  the program under test
        import torch
    except ImportError as e:
        print(f"portbench: cannot import what a run needs: {e}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < ctx.workload["chips"]:
        print(f"portbench: {ctx.workload['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available; no run on the CPU", file=sys.stderr)
        return 2
    traffic = importlib.import_module(f"portbench.traffic.{ctx.workload['traffic']}")
    result = traffic.run(ctx)
    found = foreign_modules()
    if found:
        print(f"portbench: the run loaded {found[:10]}", file=sys.stderr)
        return 3
    report(result)
    return 0
