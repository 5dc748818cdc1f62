"""Startup cache warming: preload the hottest planes before traffic lands.

A cold query server pays one plane decode per first touch — exactly the
p99 spike an interactive browser notices.  The completed database already
knows where the heat is without reading a single plane: the summary
statistics section says how many values every context carries, the store
indexes say what each plane costs in bytes, and the trace table of
contents says how many samples each timeline segment holds.
:func:`warm_cache` turns that into a greedy knapsack over the
byte-budgeted LRU:

* a CMS context plane's *heat* is its total value population (the
  ``count`` summary stat summed over the context's metrics — i.e. how much
  of the database lives there, a direct proxy for stripe/point traffic);
* a PMS profile plane's heat is the uniform share of total population
  (profile-major queries are uniform across profiles by shape);
* a trace plane's priority is a fixed density (the toc only knows
  lengths, and trace bytes are proportional to samples, so traces cannot
  be differentiated from index data alone — they slot in below
  moderately hot data planes, above the cold tail);
* planes are admitted hottest-per-byte first until the budget is spent.

Everything here runs from summary statistics and index arrays alone; the
only plane I/O is the warming itself.

``owned`` restricts the plan to planes a predicate claims — how a shard
worker of :class:`repro_torch.serve.shard.ShardedQueryServer` warms only the
planes the consistent-hash router will ever send it.  The predicate may
return a *weight* instead of a bool: replica-owned planes report a
fractional weight (``ConsistentHashRing.warm_priority``), scaling their
heat density down so primary-owned planes warm **hot** (first, as
before) and replica-owned planes warm behind every primary plane of
equal density — the replica tier fills whatever budget the primary tier
leaves.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.obs import monotime
from repro_torch.query.database import Database

#: plan/ownership keys: ``(store, id)`` with store in _STORES
_STORES = ("cms", "pms", "trc")


def plan_warm(db: Database, byte_budget: int,
              owned: Callable[[str, int], bool] | None = None
              ) -> list[tuple[str, int, int]]:
    """Choose planes to preload: ``[(store, id, est_bytes), ...]``.

    Ranked by heat density (population per on-disk byte), computed from
    summary stats + store/trace indexes only — zero plane reads.
    ``est_bytes`` is the on-disk plane size, a stand-in for the decoded
    footprint.  ``owned(store, id)`` (optional) drops planes another shard
    is responsible for; a falsy return drops the plane, and a fractional
    weight (replica ownership) scales its density so it ranks behind
    primary-owned planes of equal heat.
    """
    stat = "count" if "count" in db.stats else "sum"
    ctx_heat = np.zeros(db.n_contexts, dtype=np.float64)
    if db.stats:
        np.add.at(ctx_heat, np.asarray(db.stats["ctx"], dtype=np.int64),
                  np.abs(np.asarray(db.stats[stat], dtype=np.float64)))
    total_heat = float(ctx_heat.sum())

    candidates: list[tuple[float, int, str, int, int]] = []
    if db._cms is not None:
        sizes = np.diff(db._cms.offsets.astype(np.int64))
        for ctx in np.flatnonzero(sizes > 0):
            heat = float(ctx_heat[ctx]) if ctx < ctx_heat.size else 0.0
            if heat > 0.0:
                candidates.append((heat / float(sizes[ctx]), 0, "cms",
                                   int(ctx), int(sizes[ctx])))
    pms_heat = total_heat / max(db.n_profiles, 1)
    for pid in range(db.n_profiles):
        sz = int(db._pms.index[pid, 1])
        if sz > 0 and pms_heat > 0.0:
            candidates.append((pms_heat / sz, 1, "pms", pid, sz))
    if db._trc is not None:
        from repro_torch.core.traces import segment_nbytes
        # the toc only knows lengths, and segment bytes are proportional
        # to samples (12 B/sample) — so every trace plane has the *same*
        # heat density by construction.  Rank them at a deliberate
        # cross-store priority instead of pretending to differentiate:
        # half a sample-per-byte's worth (1/24) places traces below
        # moderately hot data planes but above the cold tail, and the
        # (store, pid) tiebreak keeps the order deterministic.
        trc_density = 1.0 / (2 * segment_nbytes(1))
        for pid in range(db._trc.n):
            n_samples = int(db._trc.toc[pid, 1])
            if n_samples > 0:
                candidates.append((trc_density, 2, "trc", pid,
                                   segment_nbytes(n_samples)))

    if owned is not None:
        weighted = []
        for dens, rank, store, oid, sz in candidates:
            w = owned(store, oid)
            if not w:
                continue
            weighted.append((dens * float(w), rank, store, oid, sz))
        candidates = weighted

    # hottest-per-byte first; (store, id) tiebreak keeps plans deterministic
    candidates.sort(key=lambda t: (-t[0], t[1], t[3]))
    plan, budget = [], int(byte_budget)
    for _, _, store, oid, sz in candidates:
        if sz > budget:
            continue
        plan.append((store, oid, sz))
        budget -= sz
    return plan


def warm_cache(db: Database, byte_budget: int | None = None, *,
               owned: Callable[[str, int], bool] | None = None) -> dict:
    """Execute :func:`plan_warm` against the Database's LRU; returns a
    report.  The budget is clamped to 90% of the cache capacity (leaving
    room for the live working set): warming past capacity would evict the
    hottest-per-byte planes it loaded first — worse than not warming."""
    cap = int(db.cache.capacity_bytes * 0.9)
    byte_budget = cap if byte_budget is None else min(int(byte_budget), cap)
    # monotime (not perf_counter): one clock for every duration the
    # serve stack reports, so warm timings compare against span timings
    t0 = monotime()
    plan = plan_warm(db, byte_budget, owned)
    loaded = {"cms": 0, "pms": 0, "trc": 0}
    evictions0 = db.cache.evictions
    for store, oid, _ in plan:
        if db.cache.nbytes >= byte_budget:
            break  # decoded footprints ran ahead of the on-disk estimate
        if db.cache.evictions != evictions0:
            break  # never trade already-warmed planes for colder ones
        if store == "cms":
            db.context_plane(oid)
        elif store == "pms":
            db.profile_metrics(oid)
        else:
            db.trace(oid)
        loaded[store] += 1
    return {"planned": len(plan), "loaded": sum(loaded.values()),
            "cms_planes": loaded["cms"], "pms_planes": loaded["pms"],
            "trc_planes": loaded["trc"],
            "cache_bytes": db.cache.nbytes, "budget_bytes": int(byte_budget),
            "seconds": round(monotime() - t0, 4)}
