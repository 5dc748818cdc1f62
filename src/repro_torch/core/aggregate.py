"""The streaming aggregation engine (paper §4), ported to PyTorch/CUDA.

Dataflow (Fig. 3 of the paper): profile *sources* are streamed in parallel
by a pool of workers; contexts are unified and lexically expanded
("edit" + U), metric values are redistributed across reconstructed routes,
propagated to inclusive costs, accumulated into cross-profile statistics
(+), and written *as soon as they are computed* to the PMS database through
a two-buffer out-of-order writer; traces are remapped and written in
parallel at offsets precomputed by a prefix sum.  A final "completion"
writes metadata + summary statistics and generates the CMS file.

Two phases, exactly as §4.4:

* **phase 1** — parse context/identity sections, unify CCTs (the reduction
  payload in multi-rank mode);
* **phase 2** — parse metrics/traces, remap onto final context ids,
  propagate, accumulate, write.

``compute="device"`` (the default) sends phase 2's duplicate-key combine
and inclusive propagation, and the CMS census and offsets, through the
kernels of :mod:`repro_torch.kernels` on ``device``: the CUDA card by
default, or the kernels' plain PyTorch versions with ``device="cpu"``.
``compute="cpu"`` is the reference's numpy path, unchanged.  A missing card
raises; nothing falls back.

Execution substrate — the :mod:`repro_torch.runtime` backends (paper §4.2 /
§4.4):

* ``serial`` / ``threads`` run both phases in-process; phase-1 uniquing
  serializes through one lock while everything downstream runs without
  shared mutable state;
* ``processes`` shards profiles across worker processes: each worker
  unifies a *local* CCT over its shard and the shard trees merge up a
  reduction tree (§4.4 phase 1); phase-2 propagate/encode runs in workers,
  which ship encoded planes back to the parent — a single writer feeding
  :class:`TwoBufferWriter`.  With ``compute="device"`` every phase-2 worker
  builds its own :class:`~repro_torch.kernels.batch.DeviceAggregator` (its
  own CUDA context on ``device="cuda"``), and every pool starts with
  ``spawn``; the kernel libraries are built once, in the parent, before
  any pool starts, and each task's launch counts and funnel timings travel
  back with its plane;
* ``ranks`` hands the whole run to the §4.4 rank driver
  (:mod:`repro_torch.core.reduction`), which runs the numpy path only.

**Determinism contract:** every backend produces byte-identical PMS and CMS
databases for the same inputs and config (``ranks`` differs in the PMS
plane layout only).  Three mechanisms pin this down:
(1) ``ContextTree.preorder`` orders children canonically so final context
ids are a function of tree *content*, not insertion schedule; (2) plane
appends pass through :class:`repro_torch.runtime.OrderedSink`, pinning
region allocation to profile order; (3) summary statistics are accumulated
per profile and folded in profile order by a streaming carry-chain reducer
whose merge shape is a pure function of the profile count.  On the device
path, (4) every kernel result depends only on its own profile's data.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import cms as cms_mod
from repro_torch.core.cct import ContextTree
from repro_torch.core.lexical import StructureInfo, expand_profile_tree
from repro_torch.core.pipeline import transform_plane
from repro_torch.core.pms import PMSWriter
from repro_torch.core.sparse import MeasurementProfile, Trace
from repro_torch.core.stats import StatsAccumulator
from repro_torch.core.traces import TraceDBWriter
from repro_torch.runtime import OrderedSink, executor_for, get_executor
from repro_torch.runtime import shm as shm_mod
from repro_torch.runtime.reduce import (AsyncStreamingReducer, StreamingReducer,
                                        TreeWithMaps, merge_tree_with_maps,
                                        tree_reduce)


@dataclass
class AggregationConfig:
    n_threads: int = 4                   # legacy knob; used when n_workers unset
    executor: str = "threads"            # serial | threads | processes |
                                         # ranks (compute="cpu" only)
    n_workers: int | None = None         # worker count / rank count per backend
    buffer_bytes: int = 1 << 20          # PMS double-buffer flush threshold
    sink_window: int | None = None       # ordered-sink out-of-order bound;
                                         # None = auto (2 x workers),
                                         # 0 = unbounded
    cms_workers: int = 4
    cms_strategy: str = "vectorized"     # or "heap" (paper-faithful merge)
    cms_balance: str = "dynamic"         # GLB (paper §4.4) or "static"
    group_target_bytes: int = 1 << 20
    write_cms: bool = True
    write_traces: bool = True
    keep_exclusive: bool = True
    pipeline: str = "fused"              # fused single-sort phase-2 kernel,
                                         # or "legacy" (the three-pass
                                         # numpy chain, compute="cpu" only);
                                         # byte-identical outputs
    plane_transport: str = "shm"         # processes backend: "shm" slab
                                         # arena or "pickle" through the
                                         # pool pipe; byte-identical outputs
    shm_slab_bytes: int = 1 << 20        # slab size; bigger planes fall
                                         # back to one-shot segments
    compute: str = "device"              # "device": the kernels on `device`;
                                         # "cpu": the numpy hot loops
    device: str = "cuda"                 # "cuda": the CUDA kernels (raises
                                         # without a card); "cpu": their
                                         # plain PyTorch versions
    stats_merge: str = "auto"            # cross-profile stats carry-chain:
                                         # "inline" on the consume thread,
                                         # "workers" on a small merge pool
                                         # (byte-identical fold shape), or
                                         # "auto" = workers iff workers > 1

    @property
    def workers(self) -> int:
        return max(1, self.n_threads if self.n_workers is None else self.n_workers)

    def resolved_stats_merge(self) -> str:
        if self.stats_merge != "auto":
            return self.stats_merge
        return "workers" if self.workers > 1 else "inline"

    @property
    def effective_sink_window(self) -> int | None:
        """Out-of-order plane budget for the in-process ordered sink.

        ``None`` (unbounded) only when explicitly requested with 0; the
        default bounds residency at 2x the worker count — enough slack that
        workers rarely stall, small enough that a slow profile 0 cannot
        force O(n_profiles) encoded planes to buffer.
        """
        if self.sink_window is None:
            return max(2 * self.workers, 2)
        return self.sink_window if self.sink_window > 0 else None


@dataclass
class AnalysisResult:
    pms_path: str
    cms_path: str | None
    trace_path: str | None
    n_profiles: int
    n_contexts: int
    n_values: int
    timings: dict[str, float] = field(default_factory=dict)
    sizes: dict[str, int] = field(default_factory=dict)


class _PhaseTimer:
    """Accumulates io/compute seconds across threads (Fig. 6 breakdown),
    and the kernel launches made in worker processes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.acc: dict[str, float] = {}
        self.worker_launches: dict[str, int] = {}

    def add(self, key: str, dt: float) -> None:
        with self._lock:
            self.acc[key] = self.acc.get(key, 0.0) + dt

    def maximum(self, key: str, value: float) -> None:
        with self._lock:
            self.acc[key] = max(self.acc.get(key, value), value)

    def add_launches(self, counts: dict[str, int]) -> None:
        with self._lock:
            for k, n in counts.items():
                self.worker_launches[k] = self.worker_launches.get(k, 0) + n


class TwoBufferWriter:
    """The two-buffer PMS output scheme of paper §4.3.1.

    Threads append encoded planes to the active buffer; whoever crosses the
    threshold swaps buffers (fetch-and-add allocates the file region) and
    performs the write while other threads keep appending to the twin.
    """

    def __init__(self, pms: PMSWriter, threshold: int, timer: _PhaseTimer):
        self._pms = pms
        self._threshold = threshold
        self._timer = timer
        self._pool: queue.Queue = queue.Queue()
        self._pool.put(bytearray())
        self._pool.put(bytearray())
        self._buf: bytearray = self._pool.get()
        self._recs: list[tuple[int, int, int, int, int, dict | None]] = []
        self._lock = threading.Lock()

    def append(self, pid: int, payload: bytes, n_ctx: int, n_vals: int,
               identity: dict | None = None) -> None:
        to_write = None
        with self._lock:
            off = len(self._buf)
            self._buf += payload
            self._recs.append((pid, off, len(payload), n_ctx, n_vals, identity))
            if len(self._buf) >= self._threshold:
                to_write = (self._buf, self._recs)
                # blocks only if both buffers are mid-write (backpressure)
                self._buf = self._pool.get()
                self._recs = []
        if to_write is not None:
            self._flush(*to_write)

    def _flush(self, buf: bytearray, recs) -> None:
        if not buf:
            self._recycle(buf)
            return
        region = self._pms.alloc(len(buf))
        t0 = time.perf_counter()
        self._pms.write_at(region, bytes(buf))
        self._timer.add("io_write", time.perf_counter() - t0)
        for pid, off, nb, n_ctx, n_vals, ident in recs:
            self._pms.record_plane(pid, region + off, nb, n_ctx, n_vals, ident)
        self._recycle(buf)

    def _recycle(self, buf: bytearray) -> None:
        buf.clear()
        self._pool.put(buf)

    def close(self) -> None:
        with self._lock:
            to_write = (self._buf, self._recs)
            self._buf = self._pool.get()
            self._recs = []
        self._flush(*to_write)


def _load_structures(prof: MeasurementProfile,
                     cache: dict[str, StructureInfo],
                     lock: threading.Lock | None = None
                     ) -> dict[str, StructureInfo]:
    """Eagerly acquire lexical info for the profile's binaries (paper §4.2.3)
    and return the subset visible to this profile: exactly the structure
    files named in its file-paths section.  Restricting visibility per
    profile (instead of handing every profile the whole shared cache) keeps
    the expansion a pure function of the profile — required for
    cross-executor determinism, so every phase-1 path must go through this
    one helper.

    With ``lock``, the cache is shared between threads: disk I/O happens
    *outside* the lock and only cache lookups/publication run under it —
    holding a lock across file reads would serialize every thread's phase 1
    behind the slowest disk access.  Two threads may race to load the same
    file; ``setdefault`` keeps the first copy (the loads are pure functions
    of the file, so either copy is equivalent).
    """
    want = [sp for sp in prof.file_paths
            if sp.endswith(".struct.json") and os.path.exists(sp)]
    if lock is None:
        for sp in want:
            if sp not in cache:
                cache[sp] = StructureInfo.load(sp)
        return {sp: cache[sp] for sp in prof.file_paths if sp in cache}
    with lock:
        missing = [sp for sp in want if sp not in cache]
    loaded = [(sp, StructureInfo.load(sp)) for sp in missing]  # I/O unlocked
    with lock:
        for sp, si in loaded:
            cache.setdefault(sp, si)
        return {sp: cache[sp] for sp in prof.file_paths if sp in cache}


def _merge_stats(a: StatsAccumulator, b: StatsAccumulator) -> StatsAccumulator:
    a.merge(b)
    return a


def _make_stats_reducer(cfg: AggregationConfig):
    """The cross-profile statistics fold: same carry-chain shape either way
    (byte-identical results), ``"workers"`` just runs the merges on a small
    pool instead of the consume thread."""
    if cfg.resolved_stats_merge() == "workers":
        return AsyncStreamingReducer(_merge_stats, n_threads=2)
    return StreamingReducer(_merge_stats)


def validate_config(cfg: AggregationConfig) -> None:
    """Refuse a config the engine cannot run, and build the kernel libraries
    when it runs on the card: once, here, before any pool starts, so worker
    processes only load them.  Every engine that takes an
    :class:`AggregationConfig` (a one-shot run, the ingest tier's resident
    state) calls this first."""
    if cfg.pipeline not in ("fused", "legacy"):
        raise ValueError(f"unknown pipeline {cfg.pipeline!r}; "
                         f"expected 'fused' or 'legacy'")
    if cfg.plane_transport not in ("shm", "pickle"):
        raise ValueError(f"unknown plane_transport "
                         f"{cfg.plane_transport!r}; expected 'shm' "
                         f"or 'pickle'")
    if cfg.compute not in ("cpu", "device"):
        raise ValueError(f"unknown compute {cfg.compute!r}; "
                         f"expected 'cpu' or 'device'")
    if cfg.stats_merge not in ("auto", "inline", "workers"):
        raise ValueError(f"unknown stats_merge {cfg.stats_merge!r}; "
                         f"expected 'auto', 'inline' or 'workers'")
    if cfg.compute == "device" and cfg.pipeline == "legacy":
        raise ValueError("compute='device' requires pipeline='fused'; "
                         "the legacy three-pass chain has no device path")
    if cfg.compute == "device" and cfg.executor == "ranks":
        raise ValueError("compute='device' is not supported under the "
                         "ranks driver; use serial/threads/processes")
    if cfg.compute == "device":
        from repro_torch.kernels.batch import resolve_device
        if resolve_device(cfg.device).type == "cuda":  # no card raises
            # once, here: worker processes only load the libraries
            from repro_torch.kernels import _build
            _build.build_all()


class StreamingAggregator:
    """Single-rank engine; :mod:`repro_torch.core.reduction` composes ranks."""

    def __init__(self, out_dir, config: AggregationConfig | None = None):
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.cfg = config or AggregationConfig()

    def _executor(self):
        return executor_for(self.cfg.executor, self.cfg.workers,
                            self.cfg.compute)

    # -- phase 1: contexts ---------------------------------------------------
    def parse_contexts(self, profile_paths: list[str], timer: _PhaseTimer,
                       unified: ContextTree | None = None, executor=None):
        """Parallel parse + unify; returns (unified, remaps, routes, meta).

        In-process only (the body closes over the shared tree); the
        ``processes`` backend goes through :func:`_phase1_shard_worker`.
        """
        ex = executor or get_executor(self.cfg.executor, self.cfg.workers)
        return phase1_unify_inprocess(profile_paths, timer, unified=unified,
                                      executor=ex)

    # -- full run --------------------------------------------------------------
    def run(self, profile_paths: list[str]) -> AnalysisResult:
        """Aggregate ``profile_paths``.  ``timings["device_launches"]``
        counts each kernel's launches in the run, in this process and in
        its worker processes; a ``processes`` run also reports the workers'
        share as ``timings["device_launches_workers"]``."""
        validate_config(self.cfg)
        from repro_torch.kernels._build import launch_counts
        before = launch_counts.snapshot()
        with self._executor() as ex:
            if ex.driver == "ranks":
                # whole-run driver backend (paper §4.4): n_workers ranks,
                # n_threads threads per rank; imported lazily — the rank
                # driver composes *this* engine, so the import must not be
                # circular at module load
                from repro_torch.core.reduction import aggregate_multiprocess
                res = aggregate_multiprocess(
                    profile_paths, self.out_dir, n_ranks=ex.n_workers,
                    threads_per_rank=self.cfg.n_threads, config=self.cfg)
            elif ex.in_process:
                res = self._run_inprocess(profile_paths, ex)
            else:
                res = self._run_sharded(profile_paths, ex)
        after = launch_counts.snapshot()
        workers = res.timings.get("device_launches_workers", {})
        res.timings["device_launches"] = {
            k: after.get(k, 0) - before.get(k, 0) + workers.get(k, 0)
            for k in sorted({*after, *workers})}
        return res

    # -- in-process path (serial / threads) ------------------------------------
    def _run_inprocess(self, profile_paths: list[str], ex) -> AnalysisResult:
        cfg = self.cfg
        timer = _PhaseTimer()
        t_start = time.perf_counter()
        n = len(profile_paths)

        # ---- phase 1
        t0 = time.perf_counter()
        unified, remaps, routes, identities, trace_lens, registries = (
            self.parse_contexts(profile_paths, timer, executor=ex))
        # renumber contexts to canonical preorder ids: subtree intervals
        # become contiguous and CMS context order matches tree order
        pos, order, end = unified.preorder()
        final_tree = _renumber(unified, pos, order)
        n_ctx = len(final_tree)
        timer.add("phase1", time.perf_counter() - t0)

        # ---- phase 2
        t0 = time.perf_counter()
        pms_path = os.path.join(self.out_dir, "db.pms")
        pms = PMSWriter(pms_path, n)
        writer = TwoBufferWriter(pms, cfg.buffer_bytes, timer)
        # stats fold inside the ordered sink: in profile order with a shape
        # that is a pure function of n, and only O(log n) accumulators live
        stats_reducer = _make_stats_reducer(cfg)
        trace_path = None
        trace_writer = None
        if cfg.write_traces and trace_lens.sum() > 0:
            trace_path = os.path.join(self.out_dir, "db.trc")
            trace_writer = TraceDBWriter(trace_path, [int(x) for x in trace_lens])
        nvals = np.zeros(n, dtype=np.int64)
        parent_pre = np.asarray(final_tree.parent, dtype=np.int64)

        def consume(i: int, payload, p_ctx: int, p_vals: int, acc) -> None:
            # in-order append: pins region allocation to profile order
            writer.append(i, payload, p_ctx, p_vals, identities[i])
            stats_reducer.push(acc)
            nvals[i] = p_vals

        trace_sink = None
        if trace_writer is not None:
            def trace_sink(i: int, tr: Trace) -> None:
                t2 = time.perf_counter()
                trace_writer.write_trace(i, tr)
                timer.add("io_write", time.perf_counter() - t2)

        try:
            phase2_stream_inprocess(
                profile_paths,
                lambda i: pos[np.asarray(remaps[i], dtype=np.int64)],
                lambda i: {int(pos[ph]): (pos[t_], w)
                           for ph, (t_, w) in routes[i].items()},
                cfg, ex, parent_pre, end, timer, consume, trace_sink)
            writer.close()
        except BaseException:
            stats_reducer.close()
            pms.abort()
            if trace_writer is not None:
                trace_writer.close()
            raise
        if trace_writer is not None:
            trace_writer.close()
        timer.add("phase2", time.perf_counter() - t0)

        return self._complete(pms, final_tree, stats_reducer.result(),
                              registries, trace_path, timer, t_start, n,
                              n_ctx, int(nvals.sum()))

    # -- sharded path (processes) ----------------------------------------------
    def _run_sharded(self, profile_paths: list[str], ex) -> AnalysisResult:
        cfg = self.cfg
        timer = _PhaseTimer()
        t_start = time.perf_counter()
        n = len(profile_paths)
        shards = ex.shards(n)

        # ---- phase 1: per-shard local CCTs, merged by a reduction tree ----
        t0 = time.perf_counter()
        shard_paths = [[profile_paths[i] for i in sh] for sh in shards]
        results1: dict[int, dict] = dict(
            ex.map_unordered(_phase1_shard_worker, shard_paths))
        items = [
            TreeWithMaps(ContextTree.from_arrays(results1[k]["tree"]),
                         {k: np.arange(len(results1[k]["tree"]["parent"]))})
            for k in range(len(shards))
        ]
        if items:
            merged, _ = tree_reduce(items, merge_tree_with_maps, 2)
        else:
            merged = TreeWithMaps(ContextTree(), {})
        pos, order, end = merged.tree.preorder()
        final_tree = _renumber(merged.tree, pos, order)
        n_ctx = len(final_tree)

        # broadcast final ids back: compose per-profile remaps and routes
        # (fresh containers per index — never `[{}] * n` aliases)
        remaps_final: list[np.ndarray | None] = [None] * n
        routes_final: list[dict] = [{} for _ in range(n)]
        identities: list[dict | None] = [None] * n
        registries: list[list] = [[] for _ in range(n)]
        trace_lens = np.zeros(n, dtype=np.int64)
        for k, sh in enumerate(shards):
            res = results1[k]
            shard_map = pos[merged.maps[k]]  # local ctx -> final preorder id
            for j, g in enumerate(sh):
                remaps_final[g] = shard_map[np.asarray(res["remaps"][j], np.int64)]
                routes_final[g] = {
                    int(shard_map[ph]): (shard_map[np.asarray(t_, np.int64)], w)
                    for ph, (t_, w) in res["routes"][j].items()
                }
                identities[g] = res["identities"][j]
                registries[g] = res["registries"][j]
                trace_lens[g] = res["trace_lens"][j]
        timer.add("phase1", time.perf_counter() - t0)

        # ---- phase 2: propagate/encode in workers, single writer here ----
        t0 = time.perf_counter()
        pms_path = os.path.join(self.out_dir, "db.pms")
        pms = PMSWriter(pms_path, n)
        writer = TwoBufferWriter(pms, cfg.buffer_bytes, timer)
        trace_path = None
        trace_writer = None
        if cfg.write_traces and trace_lens.sum() > 0:
            trace_path = os.path.join(self.out_dir, "db.trc")
            trace_writer = TraceDBWriter(trace_path, [int(x) for x in trace_lens])
        stats_reducer = _make_stats_reducer(cfg)
        nvals = np.zeros(n, dtype=np.int64)
        parent_pre = np.asarray(final_tree.parent, dtype=np.int64)

        def consume(i: int, payload, p_ctx: int, p_vals: int, acc) -> None:
            writer.append(i, payload, p_ctx, p_vals, identities[i])
            stats_reducer.push(acc)
            nvals[i] = p_vals

        trace_sink = None
        if trace_writer is not None:
            def trace_sink(i: int, tr: Trace) -> None:
                t2 = time.perf_counter()
                trace_writer.write_trace(i, tr)
                timer.add("io_write", time.perf_counter() - t2)

        try:
            phase2_stream_sharded(profile_paths, remaps_final, routes_final,
                                  cfg, ex, parent_pre, end, timer, consume,
                                  trace_sink)
            writer.close()
        except BaseException:
            stats_reducer.close()
            pms.abort()
            if trace_writer is not None:
                trace_writer.close()
            raise
        if trace_writer is not None:
            trace_writer.close()
        timer.add("phase2", time.perf_counter() - t0)

        res = self._complete(pms, final_tree, stats_reducer.result(),
                             registries, trace_path, timer, t_start, n,
                             n_ctx, int(nvals.sum()))
        res.timings["device_launches_workers"] = dict(
            sorted(timer.worker_launches.items()))
        return res

    # -- completion (paper: overlapped with CMS generation) --------------------
    def _complete(self, pms, final_tree, root_acc, registries,
                  trace_path, timer, t_start, n, n_ctx, n_values) -> AnalysisResult:
        cfg = self.cfg
        t0 = time.perf_counter()
        if root_acc is None:
            root_acc = StatsAccumulator()
        stats = root_acc.finalize()
        registry_json = next((r for r in registries if r), [])
        pms_bytes = pms.finalize(tree=final_tree, registry_json=registry_json,
                                 stats={k: np.asarray(v, np.float64)
                                        for k, v in stats.items()})
        cms_path = None
        cms_bytes = 0
        if cfg.write_cms:
            cms_path = os.path.join(self.out_dir, "db.cms")
            t2 = time.perf_counter()
            cms_bytes = cms_mod.build_cms(
                pms.path, cms_path, n_workers=cfg.cms_workers,
                strategy=cfg.cms_strategy, balance=cfg.cms_balance,
                group_target_bytes=cfg.group_target_bytes,
                executor=cfg.executor, compute=cfg.compute,
                device=cfg.device)
            timer.add("cms", time.perf_counter() - t2)
        timer.add("completion", time.perf_counter() - t0)
        timer.add("total", time.perf_counter() - t_start)

        sizes = {"pms": pms_bytes, "cms": cms_bytes}
        if trace_path:
            sizes["traces"] = os.path.getsize(trace_path)
        return AnalysisResult(
            pms_path=pms.path, cms_path=cms_path, trace_path=trace_path,
            n_profiles=n, n_contexts=n_ctx, n_values=n_values,
            timings=dict(timer.acc), sizes=sizes,
        )


# ---------------------------------------------------------------------------
# phase-1 / phase-2 streaming engines (shared by one-shot runs and live
# ingest appends)
# ---------------------------------------------------------------------------

def phase1_unify_inprocess(profile_paths: list[str], timer: _PhaseTimer,
                           unified: ContextTree | None = None, executor=None):
    """Parallel parse + unify into ``unified`` (grown in place when given —
    the live-ingest append path; a one-shot run starts from an empty tree).
    Returns ``(unified, remaps, routes, identities, trace_lens,
    registry_jsons)`` with remaps/routes in *creation-order* ids of the
    unified tree: stable under later appends, renumbered to canonical
    preorder only when a database is written.

    In-process only (the body closes over the shared tree); the
    ``processes`` backend goes through :func:`_phase1_shard_worker`.
    """
    ex = executor or get_executor("serial", 1)
    if not ex.in_process:
        raise ValueError(
            f"phase1_unify_inprocess requires an in-process executor, got "
            f"{ex.name!r}; use StreamingAggregator.run for the sharded "
            f"path, or pass executor= explicitly")
    unified = unified if unified is not None else ContextTree()
    structures: dict[str, StructureInfo] = {}
    struct_lock = threading.Lock()
    uniq_lock = threading.Lock()
    n = len(profile_paths)
    # one fresh container per index — a shared `[{}] * n` alias would let
    # any in-place mutation silently corrupt every profile's entry
    remaps: list[np.ndarray | None] = [None] * n
    routes: list[dict] = [{} for _ in range(n)]
    identities: list[dict] = [{} for _ in range(n)]
    trace_lens = np.zeros(n, dtype=np.int64)
    registry_jsons: list[list] = [[] for _ in range(n)]

    def body(i: int):
        t0 = time.perf_counter()
        prof = MeasurementProfile.load(profile_paths[i])
        timer.add("io_read", time.perf_counter() - t0)
        t1 = time.perf_counter()
        own = _load_structures(prof, structures, struct_lock)
        with uniq_lock:  # uniquing (U) — see module docstring on locking
            remap, rts = expand_profile_tree(unified, prof.tree, own)
        remaps[i] = remap
        routes[i] = rts
        identities[i] = prof.identity
        trace_lens[i] = prof.trace.time.size
        registry_jsons[i] = prof.environment.get("registry", [])
        timer.add("compute", time.perf_counter() - t1)

    ex.parallel_for(n, body)
    return unified, remaps, routes, identities, trace_lens, registry_jsons

def transform_profile(prof: MeasurementProfile, remap_final, routes_final,
                      parent_pre: np.ndarray, end_arr: np.ndarray, *,
                      pipeline: str, keep_exclusive: bool, want_trace: bool,
                      device=None):
    """Phase-2 compute for one loaded profile: remap + redistribute +
    propagate (the paper's edit/redistribute/propagate chain) plus the
    per-profile statistics leaf.  Returns ``(sm, acc, trace_or_None)``.

    This is *the* unit of work every executor runs, so the
    byte-determinism contract only has to be argued once.
    ``device`` is a :class:`repro_torch.kernels.batch.DeviceAggregator`
    routing the combine/propagate hot loops through the kernels, or None for
    the pure-numpy path.
    """
    remap_arr = np.asarray(remap_final, dtype=np.int64)
    sm = transform_plane(prof.metrics, remap_arr, routes_final, parent_pre,
                         end_arr, pipeline=pipeline,
                         keep_exclusive=keep_exclusive, device=device)
    acc = StatsAccumulator()
    acc.update(sm)
    tr = (prof.trace.remap_contexts(remap_arr)
          if want_trace and prof.trace.time.size else None)
    return sm, acc, tr


def phase2_stream_inprocess(profile_paths: list[str], remap_of, route_of,
                            cfg: AggregationConfig, ex, parent_pre: np.ndarray,
                            end_arr: np.ndarray, timer: _PhaseTimer, consume,
                            trace_sink=None, device=None):
    """Stream phase 2 through an in-process executor with pluggable output
    hooks — the engine behind :meth:`StreamingAggregator._run_inprocess`
    (hooks feed the PMS/trace writers) and the live ingest tier's
    incremental append (hooks retain relabeled planes in memory).

    ``remap_of(i)`` / ``route_of(i)`` produce profile ``i``'s final context
    remap and route table (composed lazily, on the worker).  ``consume(i,
    payload, n_ctx, n_vals, acc)`` runs in profile order under an
    :class:`OrderedSink` — the determinism pin for region allocation and
    the stats carry chain; a bounded window blocks producers of far-ahead
    profiles instead of stacking encoded planes.  ``trace_sink(i, trace)``
    runs on worker threads as soon as a profile's trace is remapped.
    Returns the sink (``max_pending`` observability).

    ``device=None`` with ``cfg.compute == "device"`` builds a
    :class:`repro_torch.kernels.batch.DeviceAggregator` on ``cfg.device``
    for this run; worker threads then coalesce their propagation work into
    shared launches (kernel launches and copies release the GIL).
    """
    n = len(profile_paths)
    if device is None and cfg.compute == "device":
        from repro_torch.kernels.batch import DeviceAggregator
        device = DeviceAggregator(end_arr, device=cfg.device)
    sink = OrderedSink(lambda i, item: consume(i, *item),
                       window=cfg.effective_sink_window)

    def body(i: int):
        try:
            t0 = time.perf_counter()
            prof = MeasurementProfile.load(profile_paths[i])
            timer.add("io_read", time.perf_counter() - t0)
            t1 = time.perf_counter()
            sm, acc, tr = transform_profile(
                prof, remap_of(i), route_of(i), parent_pre, end_arr,
                pipeline=cfg.pipeline, keep_exclusive=cfg.keep_exclusive,
                want_trace=trace_sink is not None, device=device)
            payload = sm.encode()
            timer.add("compute", time.perf_counter() - t1)
            sink.put(i, (payload, sm.n_contexts, sm.n_values, acc))
            if tr is not None:
                trace_sink(i, tr)
        except BaseException as e:
            sink.fail(e)  # wake producers blocked on the bounded window
            raise

    ex.parallel_for(n, body)
    sink.close()
    timer.add("sink_peak", float(sink.max_pending))
    if device is not None:
        timer.add("funnel_launches", float(device.launches))
        timer.add("funnel_requests", float(device.requests))
        for k, ms in device.device_ms.items():
            timer.add(f"device_{k}", ms / 1e3)
    return sink


def phase2_stream_sharded(profile_paths: list[str], remaps_final,
                          routes_final, cfg: AggregationConfig, ex,
                          parent_pre: np.ndarray, end_arr: np.ndarray,
                          timer: _PhaseTimer, consume, trace_sink=None):
    """Phase-2 streaming over a ``processes`` executor with pluggable
    output hooks: propagate/encode runs in pool workers (shm slab arena or
    pickle transport), then ``consume(i, payload, n_ctx, n_vals, acc)``
    and ``trace_sink(i, trace)`` run in profile order on the consuming
    thread.  ``payload`` and the trace arrays may be views into a shm slab
    that is recycled when the hook returns — hooks must copy anything they
    retain (the PMS writer copies into its buffer).

    Submission credits bound in-flight profiles (worker-resident or
    buffered out of order in the sink) to the sink window; with the shm
    transport the window doubles as the slab count, so slab recycling *is*
    the submission throttle and the single-producer feed below can never
    block on its own bounded sink (the next-expected profile is always
    already submitted).  An explicit ``sink_window=0`` ("unbounded") stays
    unthrottled on the pickle transport, where no slab scarcity requires a
    bound.

    With ``cfg.compute == "device"`` each worker runs the kernels on its
    own :class:`~repro_torch.kernels.batch.DeviceAggregator`; every result
    carries its task's launch counts and funnel timings, which are added
    to ``timer`` here (``timer.worker_launches``, ``funnel_*``,
    ``device_*``, and the largest ``worker_peak_bytes`` a worker reported).
    """
    n = len(profile_paths)
    window = cfg.effective_sink_window
    n_slabs = window if window is not None else max(2 * cfg.workers, 2)
    arena = None
    transport = cfg.plane_transport
    if transport == "shm" and n > 0:
        try:
            arena = shm_mod.SlabArena(n_slabs, cfg.shm_slab_bytes)
        except Exception:
            transport = "pickle"  # no usable /dev/shm: fall back
    n_credits = (window if window is not None
                 else n_slabs if arena is not None else None)

    def _consume(i: int, item):
        try:
            payload, p_ctx, p_vals, stat_arrays, ttime, tctx, cleanup = (
                _open_plane_result(item, arena))
        except BaseException:
            _discard_plane_result(item)
            raise
        try:
            consume(i, payload, p_ctx, p_vals,
                    StatsAccumulator.from_arrays(stat_arrays))
            if trace_sink is not None and len(ttime):
                trace_sink(i, Trace(ttime, tctx))
        finally:
            # on success *and* failure: release slab views, then
            # recycle the slab / unlink the one-shot segment — a
            # consume error must not strand its own descriptor (the
            # sink popped it, so the abort sweep can't see it)
            del payload, ttime, tctx
            cleanup()

    sink = OrderedSink(_consume, window=window)
    initargs = (end_arr, parent_pre, cfg.keep_exclusive, cfg.write_traces,
                cfg.pipeline, cfg.shm_slab_bytes, cfg.compute, cfg.device,
                arena.prefix if arena is not None else shm_mod.segment_prefix())

    def task_source():
        # pulled lazily by map_throttled, one task per credit: with the
        # shm transport a free slab is guaranteed at every pull
        for i in range(n):
            slab = arena.acquire() if arena is not None else None
            yield (profile_paths[i], remaps_final[i], routes_final[i], slab)

    credits = ((lambda: sink.consumed + n_credits)
               if n_credits is not None else (lambda: float("inf")))
    t0 = time.perf_counter()
    try:
        for i, result in ex.map_throttled(
                _phase2_profile_worker, task_source(), credits=credits,
                initializer=_phase2_init, initargs=initargs,
                on_discard=lambda res: _discard_plane_result(res[1])):
            if t0 is not None:  # pool start-up plus the first task
                timer.add("phase2_first_result", time.perf_counter() - t0)
                t0 = None
            _add_tally(timer, result[-1])
            sink.put(i, result)
        sink.close()
    except BaseException:
        # unlink one-shot segments stranded in the sink's buffer (slabs
        # themselves die with the arena below)
        for item in sink.pending_items():
            _discard_plane_result(item)
        raise
    finally:
        if arena is not None:
            arena.close()
    timer.add("sink_peak", float(sink.max_pending))
    return sink


# ---------------------------------------------------------------------------
# process-backend worker bodies (module-level: must pickle across processes)
# ---------------------------------------------------------------------------

def _phase1_shard_worker(shard_paths: list[str]) -> dict:
    """Unify one shard's profiles into a worker-local CCT — no uniquing lock;
    the shard trees meet in the parent's reduction tree (paper §4.4)."""
    structures: dict[str, StructureInfo] = {}
    tree = ContextTree()
    remaps, routes, identities, trace_lens, registries = [], [], [], [], []
    for path in shard_paths:
        prof = MeasurementProfile.load(path)
        own = _load_structures(prof, structures)
        remap, rts = expand_profile_tree(tree, prof.tree, own)
        remaps.append(remap)
        routes.append(rts)
        identities.append(prof.identity)
        trace_lens.append(int(prof.trace.time.size))
        registries.append(prof.environment.get("registry", []))
    return {"tree": tree.to_arrays(), "remaps": remaps, "routes": routes,
            "identities": identities, "trace_lens": trace_lens,
            "registries": registries}


_PHASE2_STATE: tuple | None = None
_PHASE2_INIT_S: float | None = None  # the initializer's seconds, told once

_STAT_FIELDS = ("keys", "sum", "cnt", "vmin", "vmax", "sumsq")


def _phase2_init(end: np.ndarray, parent: np.ndarray, keep_exclusive: bool,
                 write_traces: bool, pipeline: str, slab_bytes: int,
                 compute: str, device: str, shm_prefix: str) -> None:
    """Pool initializer: ship the (large) preorder-interval arrays once per
    worker instead of once per profile task.  With ``compute="device"``
    each worker builds its own :class:`DeviceAggregator` on ``device`` —
    workers are single-threaded, so batches degenerate to size 1, but
    batch-composition independence makes the arithmetic (and the bytes)
    identical.  A worker on a host without a card raises here, and the
    pool delivers that error to the parent at the first task.
    ``shm_prefix`` names the one-shot segments the worker creates."""
    global _PHASE2_STATE, _PHASE2_INIT_S
    t0 = time.perf_counter()
    aggregator = None
    if compute == "device":
        from repro_torch.kernels.batch import DeviceAggregator
        aggregator = DeviceAggregator(np.asarray(end, dtype=np.int64),
                                      device=device)
    _PHASE2_STATE = (np.asarray(end, dtype=np.int64),
                     np.asarray(parent, dtype=np.int64),
                     bool(keep_exclusive), bool(write_traces), pipeline,
                     int(slab_bytes), aggregator, shm_prefix)
    _PHASE2_INIT_S = time.perf_counter() - t0


def _device_tally(aggregator) -> dict | None:
    """This worker's kernel launches by name, its funnel's counters and its
    card's peak allocation so far (None without a device): a result
    carries the difference its task made, since the counters live in the
    worker's process.  :func:`_phase2_profile_worker` adds the task's
    seconds and, on a worker's first task, its initializer's seconds."""
    if aggregator is None:
        return None
    from repro_torch.kernels._build import launch_counts
    out = {"launches": launch_counts.snapshot(),
           "funnel_launches": aggregator.launches,
           "funnel_requests": aggregator.requests,
           **{f"device_{k}": ms / 1e3
              for k, ms in aggregator.device_ms.items()}}
    if aggregator.device.type == "cuda":
        import torch
        out["worker_peak_bytes"] = torch.cuda.max_memory_allocated(
            aggregator.device)
    return out


def _tally_delta(after: dict | None, before: dict | None) -> dict | None:
    if after is None:
        return None
    out = {k: v - before[k] for k, v in after.items()
           if k not in ("launches", "worker_peak_bytes")}
    out["launches"] = {k: v - before["launches"].get(k, 0)
                       for k, v in after["launches"].items()
                       if v != before["launches"].get(k, 0)}
    if "worker_peak_bytes" in after:
        out["worker_peak_bytes"] = after["worker_peak_bytes"]
    return out


def _add_tally(timer: _PhaseTimer, tally: dict | None) -> None:
    """Fold one phase-2 result's device tally into the run's timings:
    launches by kernel, the largest ``worker_peak_bytes``, and sums of the
    rest (``worker_task_s`` and ``worker_init_s`` over all workers,
    ``workers_used`` counts the workers that ran a task)."""
    if tally is None:
        return
    timer.add_launches(tally["launches"])
    for k, v in tally.items():
        if k == "worker_peak_bytes":
            timer.maximum(k, float(v))
        elif k != "launches":
            timer.add(k, float(v))


def _plane_section_lengths(nb_payload: int, n_trace: int,
                           n_stats: int) -> list[int]:
    """Byte lengths of a slab's sections: encoded plane, trace time (f64),
    trace ctx (u32), then the six statistics arrays (u64 keys + 5 x f64)."""
    return [nb_payload, 8 * n_trace, 4 * n_trace,
            8 * n_stats, 8 * n_stats, 8 * n_stats,
            8 * n_stats, 8 * n_stats, 8 * n_stats]


def _phase2_profile_worker(task) -> tuple:
    """Remap + redistribute + propagate + encode one profile; ship the
    encoded plane (and per-profile trace/statistics payload) back to the
    writer — through the assigned shared-memory slab when one is given
    (``("shm", ...)`` descriptor), else pickled inline (``("raw", ...)``).
    The last element of either is the task's device tally
    (:func:`_device_tally`), or None on the numpy path.
    """
    global _PHASE2_INIT_S
    path, remap_final, routes_final, slab_name = task
    # Chaos hook: the worker-death liveness tests SIGKILL a worker
    # mid-batch via the environment, which — unlike a monkeypatched worker
    # body — reaches spawn-context children (the pool context for
    # compute="device").
    _marker = os.environ.get("REPRO_CHAOS_KILL_MARKER")
    if _marker and _marker in str(path):
        import signal
        os.kill(os.getpid(), signal.SIGKILL)
    assert _PHASE2_STATE is not None, "phase-2 worker used without initializer"
    (end, parent, keep_exclusive, write_traces, pipeline,
     slab_bytes, aggregator, shm_prefix) = _PHASE2_STATE
    t0 = time.perf_counter()
    before = _device_tally(aggregator)
    prof = MeasurementProfile.load(path)
    sm, acc, tr = transform_profile(prof, remap_final, routes_final, parent,
                                    end, pipeline=pipeline,
                                    keep_exclusive=keep_exclusive,
                                    want_trace=write_traces,
                                    device=aggregator)
    tally = _tally_delta(_device_tally(aggregator), before)
    if tally is not None:  # seconds to load and transform the profile
        tally["worker_task_s"] = time.perf_counter() - t0
        if _PHASE2_INIT_S is not None:  # this worker's first task
            tally["worker_init_s"] = _PHASE2_INIT_S
            tally["workers_used"] = 1
            _PHASE2_INIT_S = None
    if tr is not None:
        ttime, tctx = tr.time, tr.ctx
    else:
        ttime, tctx = np.empty(0, np.float64), np.empty(0, np.uint32)

    if slab_name is None:
        return ("raw", sm.encode(), sm.n_contexts, sm.n_values,
                acc.to_arrays(), ttime, tctx, tally)

    stats = acc.to_arrays()
    nb_payload = sm.encoded_nbytes()
    n_stats = int(stats["keys"].size)
    offs, total = shm_mod.sections_layout(
        _plane_section_lengths(nb_payload, int(ttime.size), n_stats))
    own = None
    if total <= slab_bytes:
        seg = shm_mod.worker_slab(slab_name)
    else:
        seg = shm_mod.create_segment(total, shm_prefix)  # oversize: one-shot
        own = seg.name
    buf = seg.buf
    sm.encode_into(buf, offs[0])
    shm_mod.write_section(buf, offs[1], ttime)
    shm_mod.write_section(buf, offs[2], tctx)
    for off, field_name in zip(offs[3:], _STAT_FIELDS):
        shm_mod.write_section(buf, off, stats[field_name])
    if own is not None:
        del buf
        seg.close()  # parent attaches by name and unlinks after consuming
    return ("shm", slab_name, own, nb_payload, int(ttime.size), n_stats,
            sm.n_contexts, sm.n_values, tally)


def _open_plane_result(item: tuple, arena):
    """Resolve a phase-2 result descriptor into (payload, n_ctx, n_vals,
    stat_arrays, ttime, tctx, cleanup).

    ``raw`` items are self-contained.  ``shm`` items resolve to zero-copy
    views over the slab (or one-shot segment); statistics arrays are copied
    out because the stats reducer holds them past slab recycling, while the
    payload/trace views are consumed (written to disk) before ``cleanup()``
    recycles the slab.
    """
    if item[0] == "raw":
        _, payload, p_ctx, p_vals, stat_arrays, ttime, tctx, _ = item
        return payload, p_ctx, p_vals, stat_arrays, ttime, tctx, lambda: None
    _, slab_name, own, nb_payload, n_trace, n_stats, p_ctx, p_vals, _ = item
    offs, _ = shm_mod.sections_layout(
        _plane_section_lengths(nb_payload, n_trace, n_stats))
    seg = shm_mod.attach(own) if own is not None else None
    buf = seg.buf if seg is not None else arena.view(slab_name)
    payload = buf[offs[0]:offs[0] + nb_payload]
    ttime = shm_mod.read_section(buf, offs[1], np.float64, n_trace)
    tctx = shm_mod.read_section(buf, offs[2], np.uint32, n_trace)
    stat_arrays = {
        f: shm_mod.read_section(buf, off, np.uint64 if f == "keys"
                                else np.float64, n_stats, copy=True)
        for off, f in zip(offs[3:], _STAT_FIELDS)
    }

    def cleanup():
        if seg is not None:
            shm_mod.destroy_segment(seg)
        arena.release(slab_name)

    return payload, p_ctx, p_vals, stat_arrays, ttime, tctx, cleanup


def _discard_plane_result(item) -> None:
    """Abort-path disposal of an unconsumed descriptor: unlink its one-shot
    segment if it has one (arena slabs are unlinked wholesale)."""
    if isinstance(item, tuple) and len(item) > 2 and item[0] == "shm" \
            and item[2] is not None:
        try:
            shm_mod.destroy_segment(shm_mod.attach(item[2]))
        except Exception:
            pass


# ---------------------------------------------------------------------------
# completion helpers
# ---------------------------------------------------------------------------

def _renumber(tree: ContextTree, pos: np.ndarray, order: np.ndarray) -> ContextTree:
    """Rebuild the tree with ids equal to canonical preorder positions.

    Names are re-interned in preorder encounter order so the serialized
    name table — like the ids — is a pure function of tree content, not of
    the (scheduling-dependent) order names were first seen during unification.
    """
    out = ContextTree.__new__(ContextTree)
    n = len(tree)
    out.names = []
    out._name_ids = {}
    out.parent = [-1] * n
    out.kind = [0] * n
    out.name_id = [0] * n
    for new in range(n):
        old = int(order[new])
        out.kind[new] = tree.kind[old]
        out.name_id[new] = out._intern(tree.names[tree.name_id[old]])
        out.parent[new] = -1 if old == 0 else int(pos[tree.parent[old]])
    out._children = {
        (out.parent[c], out.kind[c], out.name_id[c]): c for c in range(1, n)
    }
    return out
