"""Export flight-recorder spans into the repo's own trace-plane format.

The profiler profiles itself: the spans a serving fleet records (see
:mod:`repro_torch.obs.trace`) become ordinary :class:`MeasurementProfile`
files — one per recording process, identity ``kind="obs"`` — and run
through the standard :class:`StreamingAggregator` into a byte-compatible
analysis database.  After that, everything built for application
profiles works on the server's own execution:

* ``repro_torch.launch.analyze query --db <out>/db window --t0 ... --t1 ...``
  returns the server's occupancy and hot phases over wall time;
* :func:`repro_torch.query.timeline.samples_in_window` / ``occupancy`` give a
  per-process timeline of serve phases;
* ``topk`` over ``obs.time`` ranks ``/serve/<op>/<phase>`` call paths by
  where the seconds went (queue-wait vs dispatch vs decode vs encode).

Span-to-profile mapping:

* each (pid, shard) that recorded spans becomes one profile (rank =
  enumeration order, ``identity={"kind": "obs", "os_pid": ..,
  "shard": ..}``);
* a span becomes context ``/serve/<op>/<phase>`` — phase kind for the
  root, module kind for the op, op kind for the phase, mirroring the
  phase→module→op shape of application CCTs;
* metrics ``obs.time`` (summed seconds) and ``obs.count`` (spans) on
  that context;
* the trace section is the span sequence itself: one sample per span at
  its start time, normalized to the earliest span across *all*
  processes (``time.monotonic`` shares an epoch across processes on one
  host, so parent and worker spans interleave correctly on one axis).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.aggregate import AggregationConfig, StreamingAggregator
from repro_torch.core.cct import KIND_MODULE, KIND_OP, KIND_PHASE, ContextTree
from repro_torch.core.metrics import MetricRegistry
from repro_torch.core.sparse import MeasurementProfile, SparseMetrics, Trace


def spans_to_profiles(spans) -> list[MeasurementProfile]:
    """Convert spans (from :meth:`FlightRecorder.snapshot`) into one
    measurement profile per recording process."""
    if not spans:
        raise ValueError("no spans to export — is the trace ring enabled?")
    t_base = min(s.t0 for s in spans)
    by_proc: dict[tuple[int, int], list] = {}
    for s in spans:
        by_proc.setdefault((s.shard, s.pid), []).append(s)

    profiles = []
    for rank, key in enumerate(sorted(by_proc)):
        shard, pid = key
        group = sorted(by_proc[key], key=lambda s: s.t0)
        reg = MetricRegistry()
        m_time = reg.register("obs.time", "s", side="host")
        m_count = reg.register("obs.count", "", side="host")
        tree = ContextTree()
        ctx_ids, mids, vals = [], [], []
        trace_t, trace_c = [], []
        for s in group:
            cid = tree.path([(KIND_PHASE, "serve"),
                             (KIND_MODULE, s.op or "?"),
                             (KIND_OP, s.name)])
            ctx_ids += [cid, cid]
            mids += [m_time.mid, m_count.mid]
            vals += [s.dur, 1.0]
            trace_t.append(s.t0 - t_base)
            trace_c.append(cid)
        prof = MeasurementProfile(
            environment={"app": "repro-obs", "registry": reg.to_json(),
                         "obs": {"t_base": t_base}},
            identity={"rank": rank, "stream": 0, "kind": "obs",
                      "os_pid": pid, "shard": shard},
            file_paths=[],
            tree=tree,
            trace=Trace(np.asarray(trace_t, dtype=np.float64),
                        np.asarray(trace_c, dtype=np.uint32)),
            metrics=SparseMetrics.from_triplets(ctx_ids, mids, vals))
        profiles.append(prof)
    return profiles


def export_spans(spans, out_dir: str, *,
                 executor: str = "serial") -> dict:
    """Write span profiles under ``out_dir/profiles`` and aggregate them
    into a queryable database at ``out_dir/db``.  Returns a summary.

    The aggregation runs on numpy (``compute="cpu"``), as the reference's
    does: the port's :class:`AggregationConfig` defaults to the card, but
    the span database is a few small profiles written when a query server
    shuts down, and the query server runs with no card.
    """
    profiles = spans_to_profiles(spans)
    prof_dir = os.path.join(out_dir, "profiles")
    os.makedirs(prof_dir, exist_ok=True)
    paths = []
    for prof in profiles:
        path = os.path.join(prof_dir, f"obs-{prof.identity['rank']:04d}.rprf")
        prof.save(path)
        paths.append(path)
    db_dir = os.path.join(out_dir, "db")
    StreamingAggregator(db_dir, AggregationConfig(
        executor=executor, compute="cpu")).run(paths)
    return {"db_dir": db_dir, "profiles": len(paths),
            "spans": len(spans),
            "t_base": min(s.t0 for s in spans),
            "t_span_s": round(max(s.t0 + s.dur for s in spans)
                              - min(s.t0 for s in spans), 6)}
