"""Process-level parallelism: the two-phase reduction trees of paper §4.4.

Rank layout mirrors the paper: profiles are statically partitioned across
ranks; each rank streams its shard with the thread engine; communication
happens only at the two phase boundaries:

* **phase 1 reduction** — per-rank CCTs merge up a tree of branching
  factor *t* (one merge per available thread per round -> ``log_t n``
  rounds), then the final context ids broadcast back;
* **phase 2 reduction** — per-rank statistic accumulators merge up a
  second tree; per-rank PMS plane segments are stitched into the single
  output file by a prefix sum over segment sizes (the one-sided /
  server-thread offset allocation of §4.4, resolved here at assembly).

Implemented over ``multiprocessing`` (fork) as the MPI analog, or spawn
when CUDA is already live in this process (a forked child cannot use it).
The driver runs the numpy path only: every rank, and the CMS builder, run
with ``compute="cpu"`` whatever the caller's config says, so no rank
touches a card (``StreamingAggregator`` refuses ``compute="device"`` under
the ``ranks`` executor).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time

import numpy as np

from repro_torch.core import cms as cms_mod
from repro_torch.core.aggregate import (AggregationConfig, AnalysisResult,
                                        StreamingAggregator, _PhaseTimer,
                                        _renumber)
from repro_torch.core.cct import ContextTree
from repro_torch.core.pipeline import transform_plane
from repro_torch.core.pms import PMSWriter
from repro_torch.core.sparse import MeasurementProfile
from repro_torch.core.stats import StatsAccumulator
from repro_torch.core.traces import TraceDBWriter
# the generic reduction machinery is shared with the executor runtime
# (re-exported here, as the reference does)
from repro_torch.runtime.reduce import (TreeWithMaps as _TreeWithMaps,
                                        merge_tree_with_maps as _merge_trees,
                                        tree_reduce)

__all__ = ["aggregate_multiprocess", "tree_reduce"]


# ---------------------------------------------------------------------------
# worker bodies (module-level for multiprocessing)
# ---------------------------------------------------------------------------

def _phase1_worker(args):
    rank, paths, n_threads = args
    agg = StreamingAggregator(out_dir=os.curdir, config=AggregationConfig(
        n_threads=n_threads, compute="cpu"))
    timer = _PhaseTimer()
    unified, remaps, routes, identities, trace_lens, registries = (
        agg.parse_contexts(paths, timer))
    return {
        "rank": rank,
        "tree": unified.to_arrays(),
        "remaps": remaps,
        "routes": routes,
        "identities": identities,
        "trace_lens": trace_lens,
        "registries": registries,
    }


def _phase2_worker(args):
    (rank, paths, remaps_final, routes_final, seg_path, trc_path,
     end_arr, parent_arr, keep_exclusive, pipeline) = args
    acc = StatsAccumulator()
    records = []
    trace_blobs = []
    with open(seg_path, "wb") as seg:
        off = 0
        for i, path in enumerate(paths):
            prof = MeasurementProfile.load(path)
            sm = transform_plane(prof.metrics, remaps_final[i],
                                 routes_final[i], parent_arr, end_arr,
                                 pipeline=pipeline,
                                 keep_exclusive=keep_exclusive)
            acc.update(sm)
            payload = sm.encode()
            seg.write(payload)
            records.append((i, off, len(payload), sm.n_contexts, sm.n_values))
            off += len(payload)
            if prof.trace.time.size:
                tr = prof.trace.remap_contexts(remaps_final[i])
                trace_blobs.append((i, tr.time, tr.ctx))
    return {"rank": rank, "records": records, "stats": acc.to_arrays(),
            "seg_path": seg_path, "traces": trace_blobs}


# ---------------------------------------------------------------------------
# the hybrid MPI+threads analog driver
# ---------------------------------------------------------------------------

def aggregate_multiprocess(
    profile_paths: list[str],
    out_dir: str,
    *,
    n_ranks: int = 2,
    threads_per_rank: int = 2,
    config: AggregationConfig | None = None,
) -> AnalysisResult:
    cfg = config or AggregationConfig()
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()
    n = len(profile_paths)
    shards = [profile_paths[r::n_ranks] for r in range(n_ranks)]
    # global profile id of shard[r][k] is r + k * n_ranks
    gids = [list(range(r, n, n_ranks)) for r in range(n_ranks)]

    import torch
    ctx = mp.get_context("spawn" if torch.cuda.is_initialized() else "fork")
    with ctx.Pool(n_ranks) as pool:
        # ---- phase 1: parse + reduce CCTs (branching factor = threads) ----
        results1 = pool.map(_phase1_worker,
                            [(r, shards[r], threads_per_rank) for r in range(n_ranks)])
        items = [_TreeWithMaps(ContextTree.from_arrays(res["tree"]),
                               {res["rank"]: np.arange(len(res["tree"]["parent"]))})
                 for res in results1]
        merged, rounds = tree_reduce(items, _merge_trees, max(threads_per_rank, 2))
        pos, order, end = merged.tree.preorder()
        final_tree = _renumber(merged.tree, pos, order)
        n_ctx = len(final_tree)
        parent_pre = np.asarray(final_tree.parent, dtype=np.int64)

        # ---- broadcast final ids; compose per-profile remaps ----
        phase2_args = []
        trace_lens = np.zeros(n, dtype=np.int64)
        identities: list[dict | None] = [None] * n
        registry_json: list = []
        for res in results1:
            r = res["rank"]
            rank_map = pos[merged.maps[r]]  # local ctx -> final preorder id
            remaps_final = [rank_map[np.asarray(m, np.int64)] for m in res["remaps"]]
            routes_final = [
                {int(rank_map[ph]): (rank_map[np.asarray(t_, np.int64)], w)
                 for ph, (t_, w) in rt.items()}
                for rt in res["routes"]
            ]
            for k, g in enumerate(gids[r]):
                trace_lens[g] = res["trace_lens"][k]
                identities[g] = res["identities"][k]
            registry_json = registry_json or next((x for x in res["registries"] if x), [])
            seg_path = os.path.join(out_dir, f"seg{r}.bin")
            phase2_args.append((r, shards[r], remaps_final, routes_final,
                                seg_path, None, end, parent_pre,
                                cfg.keep_exclusive, cfg.pipeline))

        # ---- phase 2: stream metrics per rank ----
        results2 = pool.map(_phase2_worker, phase2_args)

    # ---- assemble final PMS: prefix sum over segment sizes = region alloc --
    pms_path = os.path.join(out_dir, "db.pms")
    pms = PMSWriter(pms_path, n)
    n_values = 0
    for res in sorted(results2, key=lambda d: d["rank"]):
        r = res["rank"]
        with open(res["seg_path"], "rb") as f:
            blob = f.read()
        region = pms.alloc(len(blob))
        pms.write_at(region, blob)
        for k, off, nb, nctx, nvals in res["records"]:
            g = gids[r][k]
            pms.record_plane(g, region + off, nb, nctx, nvals, identities[g])
            n_values += int(nvals)
        os.unlink(res["seg_path"])

    # ---- stats reduction tree ----
    accs = [StatsAccumulator.from_arrays(res["stats"]) for res in results2]
    root_acc, stat_rounds = tree_reduce(accs, lambda a, b: (a.merge(b), a)[1],
                                        max(threads_per_rank, 2))
    stats = root_acc.finalize() if root_acc is not None else {}
    pms_bytes = pms.finalize(tree=final_tree, registry_json=registry_json,
                             stats={k: np.asarray(v, np.float64)
                                    for k, v in stats.items()})

    # ---- traces ----
    trace_path = None
    if cfg.write_traces and trace_lens.sum() > 0:
        trace_path = os.path.join(out_dir, "db.trc")
        tw = TraceDBWriter(trace_path, [int(x) for x in trace_lens])
        from repro_torch.core.sparse import Trace
        for res in results2:
            for k, ttime, tctx in res["traces"]:
                tw.write_trace(gids[res["rank"]][k], Trace(ttime, tctx))
        tw.close()

    # ---- CMS (root rank, GLB across its threads) ----
    cms_path = None
    cms_bytes = 0
    if cfg.write_cms:
        cms_path = os.path.join(out_dir, "db.cms")
        cms_bytes = cms_mod.build_cms(pms_path, cms_path,
                                      n_workers=cfg.cms_workers,
                                      strategy=cfg.cms_strategy,
                                      balance=cfg.cms_balance,
                                      group_target_bytes=cfg.group_target_bytes,
                                      compute="cpu")

    sizes = {"pms": pms_bytes, "cms": cms_bytes}
    if trace_path:
        sizes["traces"] = os.path.getsize(trace_path)
    return AnalysisResult(
        pms_path=pms_path, cms_path=cms_path, trace_path=trace_path,
        n_profiles=n, n_contexts=n_ctx, n_values=n_values,
        timings={"total": time.perf_counter() - t_start,
                 "tree_rounds": rounds, "stat_rounds": stat_rounds},
        sizes=sizes,
    )
