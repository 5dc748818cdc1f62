"""Incremental aggregation state: the phase boundary as an *append*.

A one-shot :class:`~repro_torch.core.aggregate.StreamingAggregator` run sees every
profile before it renumbers the unified CCT and streams phase 2.  The live
ingest tier cannot — profiles arrive forever — so :class:`IngestState` keeps
the aggregation *resident* and lets new batches merge into it:

* the unified tree is grown in place by phase 1
  (:func:`~repro_torch.core.aggregate.phase1_unify_inprocess` with ``unified=``);
  node ids are **creation-order** ids, which are stable under later appends
  — the coordinate system everything resident is stored in;
* each batch streams through the same fused phase-2 engines as a one-shot
  run (:func:`~repro_torch.core.aggregate.phase2_stream_inprocess` /
  :func:`~repro_torch.core.aggregate.phase2_stream_sharded`, shm slab arena and
  all), transformed in the *batch's* canonical preorder (the fused kernel
  needs contiguous subtree intervals), then relabeled to stable ids by the
  consume hook and retained: encoded planes, remapped traces, per-profile
  statistics pushed into a persistent carry-chain reducer;
* :meth:`write_database` renumbers to the *current* canonical preorder and
  writes a complete PMS/CMS/trace database for a snapshot epoch.

**Byte parity with a one-shot run** (proven by ``tests/test_ingest.py``):
a database published after N appends is byte-identical to one ``analyze``
over the same profiles in the same order.  The argument:

* canonical preorder keeps the *relative* order of pre-existing nodes when
  new nodes are inserted (children sort by content, and new subtrees only
  shift positions), so batch-preorder -> final-preorder is order-preserving
  on the nodes a batch could reference;
* the fused phase-2 kernel's FP op order depends only on the relative order
  of a profile's own triplets and subtree intervals — invariant under an
  order-preserving relabel; contexts created by later batches carry zeros
  for earlier profiles and are absent from their triplets entirely;
* :func:`relabel_plane` is a pure permutation (values move by fancy
  indexing; no arithmetic, no combining — unlike ``from_triplets``), so a
  stored plane re-labeled at publish time is the same floats the one-shot
  transform would have produced;
* statistics segments group by key; a bijective key relabel permutes
  segments without reordering *within* any segment (equal-key rows keep
  concatenation = profile order), so per-key reductions see identical
  operand sequences; the carry chain's merge shape is a pure function of
  the total profile count, which appends preserve by construction.

**On the card.**  The resident state runs on whatever its
:class:`~repro_torch.core.aggregate.AggregationConfig` says, and the port's
config defaults to ``compute="device", device="cuda"``, as every entry point
of the port does: each append's phase 2 then runs its duplicate-key combine
(``segstats``) and inclusive propagation (the f32 ``blockscan``) through a
:class:`~repro_torch.kernels.batch.DeviceAggregator`, and each publish
builds its CMS with ``compute``/``device`` from the same config (the census
``histogram`` and the int64 ``blockscan`` offsets), exactly as a one-shot
run does.  That is a deviation from the reference, whose ingest always
builds its CMS on numpy; the census counts and offsets are integers, so the
CMS bytes are the numpy ones either way.  A host without a card raises at
construction (nothing falls back), which is also when the kernel libraries
are built, once, before any pool starts; a ``processes`` pool spawns
(:func:`~repro_torch.runtime.executor_for`).  ``timings`` carries the
funnel's ``funnel_launches`` and ``device_*`` seconds from every append,
and ``device_launches`` counts each kernel's launches over the appends and
publishes, worker processes included.
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.core import cms as cms_mod
from repro_torch.core.aggregate import (AggregationConfig, _merge_stats,
                                        _PhaseTimer, _renumber,
                                        phase1_unify_inprocess,
                                        phase2_stream_inprocess,
                                        phase2_stream_sharded,
                                        validate_config)
from repro_torch.core.cct import ContextTree
from repro_torch.core.pms import PMSWriter
from repro_torch.core.sparse import CTX_DTYPE, IDX_DTYPE, SparseMetrics, Trace
from repro_torch.core.stats import StatsAccumulator
from repro_torch.core.traces import TraceDBWriter
from repro_torch.kernels._build import launch_counts
from repro_torch.runtime import executor_for, get_executor
from repro_torch.runtime.reduce import StreamingReducer


def relabel_plane(sm: SparseMetrics, mapping: np.ndarray) -> SparseMetrics:
    """Rebuild a canonical CSR plane under a bijective context relabel.

    Values and metric ids move by fancy indexing only — no summation, no
    zero-dropping (``from_triplets`` would do both) — so the result is the
    exact permutation of the input floats, which is what the byte-parity
    contract requires.  (ctx, mid) keys are unique in a canonical plane, so
    the lexsort permutation is unique regardless of sort stability.
    """
    if sm.ctx.size == 0:
        return SparseMetrics.empty()
    rows = np.repeat(sm.ctx.astype(np.int64),
                     np.diff(sm.start.astype(np.int64)))
    new_rows = np.asarray(mapping, dtype=np.int64)[rows]
    order = np.lexsort((sm.mid, new_rows))
    r = new_rows[order]
    bounds = np.flatnonzero(np.diff(r, prepend=-1))
    starts = np.concatenate([bounds, [r.size]]).astype(IDX_DTYPE)
    return SparseMetrics(r[bounds].astype(CTX_DTYPE), starts,
                         np.ascontiguousarray(sm.mid[order]),
                         np.ascontiguousarray(sm.val[order]))


def _relabel_stat_arrays(arrs: dict, mapping: np.ndarray) -> dict:
    """Relabel the packed (ctx << 16 | mid) keys of compacted statistics
    arrays; all value columns are carried as-is (row order untouched —
    the next merge's stable sort regroups by key)."""
    keys = np.asarray(arrs["keys"], np.uint64)
    ctx = (keys >> np.uint64(16)).astype(np.int64)
    new_keys = ((np.asarray(mapping, np.int64)[ctx].astype(np.uint64)
                 << np.uint64(16)) | (keys & np.uint64(0xFFFF)))
    out = dict(arrs)
    out["keys"] = new_keys
    return out


def _snapshot_reduce(reducer: StreamingReducer) -> StatsAccumulator | None:
    """Non-destructive :meth:`StreamingReducer.result`: fold *copies* of the
    live slots in the same order, leaving the carry chain intact so later
    appends keep extending the same deterministic merge shape."""
    acc = None
    for slot in reversed(reducer._slots):
        if slot is None:
            continue
        clone = StatsAccumulator.from_arrays(
            {k: np.array(v, copy=True) for k, v in slot.to_arrays().items()})
        acc = clone if acc is None else _merge_stats(acc, clone)
    return acc


class IngestState:
    """Resident aggregation: append profile batches, publish databases.

    Single-owner by design — the ingest server drives one instance from its
    merger thread; :meth:`append` and :meth:`write_database` are not
    thread-safe against each other.  ``config`` defaults to the port's
    :class:`AggregationConfig`, which runs on the card (module docstring).
    """

    def __init__(self, config: AggregationConfig | None = None):
        self.cfg = config or AggregationConfig()
        if self.cfg.executor not in ("serial", "threads", "processes"):
            raise ValueError(
                f"ingest supports serial/threads/processes executors, got "
                f"{self.cfg.executor!r} (the ranks driver is a whole-run "
                f"backend)")
        validate_config(self.cfg)
        self.tree = ContextTree()          # creation-order (stable) ids
        self.planes: list[bytes] = []      # encoded canonical CSR, stable ids
        self.traces: list[tuple[np.ndarray, np.ndarray] | None] = []
        self.trace_lens: list[int] = []
        self.identities: list[dict | None] = []
        self.registries: list[list] = []
        self.nvals: list[int] = []
        self.stats_chain = StreamingReducer(_merge_stats)
        self.n_profiles = 0
        self.timings: dict[str, float | dict] = {"device_launches": {}}

    @property
    def n_contexts(self) -> int:
        return len(self.tree)

    # -- the append (phase boundary) -----------------------------------------
    def append(self, profile_paths: list[str]) -> dict:
        """Merge one batch of profiles into the resident state.

        All-or-nothing: results are buffered per batch and committed only
        after the whole stream succeeds; on failure the unified tree is
        rolled back to its pre-batch length, so a poison profile rejects
        its batch without corrupting the state or future parity.
        """
        cfg = self.cfg
        n = len(profile_paths)
        if n == 0:
            return {"appended": 0, "n_contexts": self.n_contexts}
        timer = _PhaseTimer()
        t_start = time.perf_counter()
        n0_nodes = len(self.tree)
        before = launch_counts.snapshot()
        try:
            with executor_for(cfg.executor, cfg.workers, cfg.compute) as ex:
                batch = self._append_stream(profile_paths, timer, ex)
        except BaseException:
            self._rollback_tree(n0_nodes)
            raise
        self._add_launches(before, timer.worker_launches)
        # commit — stable-id results only reference nodes that now exist
        planes, traces, accs, idents, regs, tlens, nvals = batch
        self.planes.extend(planes)
        self.traces.extend(traces)
        self.identities.extend(idents)
        self.registries.extend(regs)
        self.trace_lens.extend(int(x) for x in tlens)
        self.nvals.extend(nvals)
        for acc in accs:  # global push order = profile arrival order
            self.stats_chain.push(acc)
        self.n_profiles += n
        for k, v in timer.acc.items():
            self.timings[k] = (max(self.timings.get(k, v), v)
                               if k == "worker_peak_bytes"
                               else self.timings.get(k, 0.0) + v)
        return {"appended": n, "n_profiles": self.n_profiles,
                "n_contexts": self.n_contexts,
                "append_s": time.perf_counter() - t_start,
                "timings": dict(timer.acc)}

    def _add_launches(self, before: dict, workers: dict) -> None:
        """Add the kernel launches made in this process since ``before``,
        and ``workers``' (a ``processes`` pool's), to
        ``timings["device_launches"]``."""
        total = self.timings["device_launches"]
        after = launch_counts.snapshot()
        for k in {*after, *workers}:
            n = after.get(k, 0) - before.get(k, 0) + workers.get(k, 0)
            if n:
                total[k] = total.get(k, 0) + n

    def _append_stream(self, profile_paths: list[str], timer: _PhaseTimer,
                       ex) -> tuple:
        cfg = self.cfg
        n = len(profile_paths)
        # phase 1 grows the shared tree in place; the sharded backend still
        # unifies in-process (the resident tree cannot live in pool workers)
        phase1_ex = ex if ex.in_process else get_executor(
            "threads", cfg.workers)
        t0 = time.perf_counter()
        _, remaps, routes, identities, trace_lens, registries = (
            phase1_unify_inprocess(profile_paths, timer, unified=self.tree,
                                   executor=phase1_ex))
        timer.add("phase1", time.perf_counter() - t0)
        t0 = time.perf_counter()
        # this batch's canonical preorder — the coordinate system the fused
        # kernel runs in; order_a maps it back to stable creation ids
        pos_a, order_a, end_a = self.tree.preorder()
        arr_tree = _renumber(self.tree, pos_a, order_a)
        parent_pre = np.asarray(arr_tree.parent, dtype=np.int64)
        order_a = np.asarray(order_a, dtype=np.int64)

        planes: list[bytes | None] = [None] * n
        traces: list[tuple[np.ndarray, np.ndarray] | None] = [None] * n
        accs: list[StatsAccumulator | None] = [None] * n
        nvals: list[int] = [0] * n

        def consume(i: int, payload, p_ctx: int, p_vals: int, acc) -> None:
            # the slab payload is recycled when we return: decode, relabel
            # batch-preorder -> stable, and keep our own encoded copy
            sm, _ = SparseMetrics.decode(payload)
            planes[i] = relabel_plane(sm, order_a).encode()
            accs[i] = StatsAccumulator.from_arrays(
                _relabel_stat_arrays(acc.to_arrays(), order_a))
            nvals[i] = int(p_vals)

        trace_sink = None
        if cfg.write_traces:
            def trace_sink(i: int, tr: Trace) -> None:
                traces[i] = (np.array(tr.time, np.float64, copy=True),
                             order_a[tr.ctx.astype(np.int64)]
                             .astype(CTX_DTYPE))

        if ex.in_process:
            phase2_stream_inprocess(
                profile_paths,
                lambda i: pos_a[np.asarray(remaps[i], dtype=np.int64)],
                lambda i: {int(pos_a[ph]): (pos_a[t_], w)
                           for ph, (t_, w) in routes[i].items()},
                cfg, ex, parent_pre, end_a, timer, consume, trace_sink)
        else:
            remaps_final = [pos_a[np.asarray(remaps[i], dtype=np.int64)]
                            for i in range(n)]
            routes_final = [
                {int(pos_a[ph]): (pos_a[np.asarray(t_, np.int64)], w)
                 for ph, (t_, w) in routes[i].items()}
                for i in range(n)
            ]
            phase2_stream_sharded(profile_paths, remaps_final, routes_final,
                                  cfg, ex, parent_pre, end_a, timer, consume,
                                  trace_sink)
        timer.add("phase2", time.perf_counter() - t0)
        return planes, traces, accs, identities, registries, trace_lens, nvals

    def _rollback_tree(self, n0: int) -> None:
        """Drop nodes a failed batch added.  Interned names may linger in
        the tree's name table — harmless: publication re-interns only the
        names reachable from surviving nodes."""
        del self.tree.parent[n0:]
        del self.tree.kind[n0:]
        del self.tree.name_id[n0:]
        self.tree._children = {
            k: c for k, c in self.tree._children.items() if c < n0}

    # -- publication ---------------------------------------------------------
    def write_database(self, out_dir) -> dict:
        """Write a complete PMS (+CMS, +traces) database of everything
        appended so far into ``out_dir`` — the payload of one snapshot
        epoch.  Resident state is untouched; appends may continue after.
        """
        cfg = self.cfg
        out_dir = str(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        n = self.n_profiles
        pos, order, _end = self.tree.preorder()
        final_tree = _renumber(self.tree, pos, order)
        pos = np.asarray(pos, dtype=np.int64)

        # planes: relabel stable -> final preorder; sequential profile-order
        # add_plane reproduces the one-shot two-buffer layout byte for byte
        # (both allocate contiguously from the same atomic cursor)
        pms_path = os.path.join(out_dir, "db.pms")
        pms = PMSWriter(pms_path, n)
        try:
            for i in range(n):
                sm, _ = SparseMetrics.decode(self.planes[i])
                pms.add_plane(i, relabel_plane(sm, pos), self.identities[i])

            trace_path = None
            if cfg.write_traces and sum(self.trace_lens) > 0:
                trace_path = os.path.join(out_dir, "db.trc")
                tw = TraceDBWriter(trace_path, list(self.trace_lens))
                try:
                    for i, stored in enumerate(self.traces):
                        if stored is not None:
                            ttime, sctx = stored
                            tw.write_trace(i, Trace(
                                ttime,
                                pos[sctx.astype(np.int64)].astype(CTX_DTYPE)))
                finally:
                    tw.close()

            snap = _snapshot_reduce(self.stats_chain) or StatsAccumulator()
            final_acc = StatsAccumulator()
            final_acc.merge(StatsAccumulator.from_arrays(
                _relabel_stat_arrays(snap.to_arrays(), pos)))
            stats = final_acc.finalize()
            registry_json = next((r for r in self.registries if r), [])
            pms_bytes = pms.finalize(
                tree=final_tree, registry_json=registry_json,
                stats={k: np.asarray(v, np.float64)
                       for k, v in stats.items()})
        except BaseException:
            pms.abort()
            raise

        t_cms = time.perf_counter()
        cms_bytes = 0
        if cfg.write_cms:
            before = launch_counts.snapshot()
            cms_bytes = cms_mod.build_cms(
                pms_path, os.path.join(out_dir, "db.cms"),
                n_workers=cfg.cms_workers, strategy=cfg.cms_strategy,
                balance=cfg.cms_balance,
                group_target_bytes=cfg.group_target_bytes,
                executor=cfg.executor, compute=cfg.compute,
                device=cfg.device)
            self._add_launches(before, {})
        t_end = time.perf_counter()
        for k, v in (("publish_pms", t_cms - t0),
                     ("publish_cms", t_end - t_cms)):
            self.timings[k] = self.timings.get(k, 0.0) + v
        return {"n_profiles": n, "n_contexts": len(final_tree),
                "n_values": int(sum(self.nvals)),
                "pms_bytes": pms_bytes, "cms_bytes": cms_bytes,
                "pms_s": t_cms - t0, "cms_s": t_end - t_cms,
                "write_s": t_end - t0}
