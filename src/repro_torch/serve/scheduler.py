"""Cross-request micro-batch scheduler with admission control.

The query engine's economics reward batching: a window of concurrent
requests sorted by :meth:`QueryServer._locality_key` decodes every hot
plane once (the rest are LRU hits), and one worker wake-up is amortized
over the whole window instead of paid per request.  This module supplies
the missing piece between "a Database that can batch" and "a service under
open-loop load":

* **admission control** — a bounded queue; when it is full, :meth:`submit`
  raises :class:`Overloaded` *immediately* (the HTTP layer maps it to
  ``429 Retry-After``), so overload degrades to fast rejections instead of
  unbounded queueing and collapse;
* **micro-batch windows** — workers collect up to ``max_batch`` requests,
  waiting at most ``max_wait_ms`` after the first arrival, then serve the
  window in plane-locality order through :meth:`QueryServer.serve_one`;
* **adaptive windows** — with ``adaptive_wait`` (the default), a worker
  holds a window open for ``max_wait_ms`` only while every *other* worker
  is busy serving: if a peer is idle-parked, new arrivals would be picked
  up immediately anyway, so waiting buys no batching — the window flushes
  at once and low-load p50 stays at service time, not service + window;
* **deadlines** — every request carries one; a request that expires while
  queued resolves to a ``QueryError("DeadlineExceeded")`` without touching
  the stores (shedding stale work is the other half of backpressure);
* **runtime executor** — the window-serving loops run on a
  :mod:`repro_torch.runtime` executor (``threads`` by default, ``serial`` for
  deterministic debugging), the same substrate the aggregator uses.

**Sharded backends** (:class:`~repro_torch.serve.shard.ShardedQueryServer`)
swap the execution model: parent-side windows would only re-serialize
what the worker processes already parallelize, so :meth:`submit_many`
dispatches straight from the submitting thread through the server's
``serve_window_async`` (which dedupes the call and sends one batch
message per shard) and chains the returned futures.  Admission control
becomes a *per-shard* bound on dispatched-but-unanswered requests — one
hot shard rejects while the others keep admitting — and batching across
calls falls out of each worker's own plane cache.

Results are delivered through ``concurrent.futures.Future``s; per-request
failures resolve (not raise) as :class:`~repro_torch.serve.engine.QueryError`,
so one poisoned request never disturbs its window peers.
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass

from repro_torch.obs import HIST_EDGES_US, Histogram, MetricsRegistry, monotime, recorder
from repro_torch.serve.engine import QueryError, QueryRequest, QueryServer

# Both names predate repro_torch.obs and are re-exported for compatibility:
# the histogram now lives in the registry (`serve/http.py` and
# `ingest/server.py` used to re-import this module's private copy).
_HIST_EDGES_US = HIST_EDGES_US
LatencyHistogram = Histogram


class Overloaded(RuntimeError):
    """Admission queue full; retry after ``retry_after_s`` seconds."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"admission queue full; retry after "
                         f"{retry_after_s:.2f}s")
        self.retry_after_s = float(retry_after_s)


@dataclass
class _Pending:
    req: QueryRequest
    future: Future
    enq_t: float
    deadline: float
    # epoch pin: a retained EpochSwitcher handle; the worker serves this
    # request against pin.db and releases the pin at every terminal path,
    # so an epoch switch mid-queue cannot split one call across snapshots
    pin: object | None = None


class BatchScheduler:
    """Admission-controlled micro-batching front of one :class:`QueryServer`.

    ``max_batch=1`` degrades to one-request-at-a-time serving (the
    benchmark baseline).  ``max_wait_ms`` bounds how long a worker holds a
    window open after its first request; ``0`` (the default) is
    *opportunistic* batching — serve everything already queued, never
    stall an idle worker.  A small positive wait trades first-request
    latency for fuller windows (better plane dedup) when traffic is
    sparse but bursty; ``adaptive_wait`` (default) skips the wait
    whenever an idle peer worker would make it pure latency.

    With a sharded server, ``max_queue`` bounds each shard's
    dispatched-but-unanswered depth instead of a parent queue, and the
    executor/window knobs are inert (dispatch happens on the submitting
    thread; the worker processes do the batching).
    """

    def __init__(self, server: QueryServer, *, max_batch: int = 16,
                 max_wait_ms: float = 0.0, max_queue: int = 256,
                 executor: str = "threads", n_workers: int = 4,
                 default_timeout_s: float = 30.0,
                 adaptive_wait: bool = True, tenant: str = ""):
        self.server = server
        # multi-tenant fronts run one scheduler per tenant: ``max_queue``
        # is then that tenant's admission budget, and the name rides the
        # metrics so rejections are attributable
        self.tenant = str(tenant)
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.max_queue = max(1, int(max_queue))
        self.default_timeout_s = float(default_timeout_s)
        self.adaptive_wait = bool(adaptive_wait)
        self._executor_name = executor
        self.n_workers = 1 if executor == "serial" else max(1, int(n_workers))

        # sharded-backend hooks (absent on in-process QueryServers)
        self.n_shards = max(1, int(getattr(server, "n_shards", 1)))
        self._shard_of = getattr(server, "shard_of", None)
        self._serve_window_async = getattr(server, "serve_window_async",
                                           None)
        self._direct = (self._serve_window_async is not None
                        and self._shard_of is not None)

        # direct-mode admission ledger: requests admitted per shard and
        # not yet completed (exact under self._lock — the server-side
        # inflight gauge lags dispatch, so bounding on it alone would let
        # concurrent submitters overshoot the bound)
        self._admitted = [0] * self.n_shards
        self._q: deque[_Pending] = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stopped = True
        self._idle = 0     # workers parked waiting for any work
        self._holding = 0  # workers holding a window open on max_wait
        self._runner: threading.Thread | None = None
        self._ewma_service_s = 1e-3  # per-request service time estimate

        # observability: registry-backed instruments with the historical
        # shapes (counters guarded by self._lock exactly as before; the
        # group's own lock only matters for out-of-band readers)
        self.obs = MetricsRegistry()
        self.counters = self.obs.group(
            "scheduler", {"submitted": 0, "completed": 0, "rejected": 0,
                          "expired": 0, "errors": 0, "batches": 0,
                          "batched_requests": 0})
        # op -> Histogram (service time)
        self.latency = self.obs.histogram_family("scheduler.latency", "op")
        self.queue_wait = self.obs.histogram("scheduler.queue_wait")
        self.obs.gauge("scheduler.queue_depth", self.depth)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "BatchScheduler":
        """Spin up the window-serving loops on the runtime executor."""
        if self._direct:
            # sharded backend: no parent-side serving loops to start —
            # dispatch happens inline on submitting threads
            with self._lock:
                self._stopped = False
            return self
        from repro_torch.runtime import get_executor
        # resolve the executor BEFORE flipping state: a bad executor name
        # must not leave a "running" scheduler with zero workers
        ex = get_executor(self._executor_name, self.n_workers)
        with self._lock:
            if not self._stopped:
                ex.close()
                return self
            self._stopped = False

        def run():
            try:
                with ex:
                    ex.parallel_for(self.n_workers, self._worker_loop)
            except BaseException as e:  # worker crash: fail queued futures
                self._fail_all(e)

        self._runner = threading.Thread(target=run, daemon=True,
                                        name="serve-scheduler")
        self._runner.start()
        return self

    def stop(self) -> None:
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._cond.notify_all()
        if self._runner is not None:
            self._runner.join(timeout=10.0)
        self._fail_all(RuntimeError("scheduler stopped"))

    @staticmethod
    def _resolve(fut: Future, result=None, exc: BaseException | None = None
                 ) -> None:
        """set_result/set_exception that tolerates a caller-side cancel
        racing in after our done-check — a lost cancel race must never
        take down the worker loop."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except InvalidStateError:
            pass

    def _fail_all(self, exc: BaseException) -> None:
        with self._cond:
            pending, self._q = list(self._q), deque()
        for p in pending:
            if not p.future.done():
                self._resolve(p.future, exc=exc)
            if p.pin is not None:
                p.pin.release()

    def __enter__(self) -> "BatchScheduler":
        return self.start()

    def __exit__(self, *a) -> None:
        self.stop()

    # -- submission (admission control) --------------------------------------
    def depth(self) -> int:
        with self._lock:
            return len(self._q) + self._inflight_depth()

    def _inflight_depth(self) -> int:
        return sum(self._admitted) if self._direct else 0

    def _retry_after_locked(self) -> float:
        if self._direct:
            # a hot shard's backlog drains through its one worker
            # process; the parent thread count is irrelevant to it
            est = max(self._admitted) * self._ewma_service_s
        else:
            est = len(self._q) * self._ewma_service_s / self.n_workers
        return max(0.05, min(est, 30.0))

    def retry_after_s(self) -> float:
        """Rough time until the queue drains enough to admit again."""
        with self._lock:
            return self._retry_after_locked()

    def submit(self, req: QueryRequest, *, timeout_s: float | None = None,
               pin=None) -> Future:
        return self.submit_many([req], timeout_s=timeout_s, pin=pin)[0]

    def submit_many(self, reqs: list[QueryRequest], *,
                    timeout_s: float | None = None, pin=None) -> list[Future]:
        """Admit a group atomically: all enqueued, or :class:`Overloaded`.

        Atomic admission keeps multi-request HTTP calls coherent — a call
        either gets every answer or a single 429, never a half-served body.

        ``pin`` (an epoch handle with ``retain``/``release``/``db``) pins
        every admitted request to one database snapshot: retained once per
        request here, served against ``pin.db``, and released at every
        terminal path (served, expired, cancelled, failed) — in-process
        backends only; a sharded backend gets call-level epoch consistency
        from its own single-dispatch reopen lock.
        """
        timeout_s = self.default_timeout_s if timeout_s is None else timeout_s
        now = monotime()
        if self._direct:
            if pin is not None:
                raise ValueError(
                    "epoch pins apply to in-process serving; a sharded "
                    "backend pins whole dispatches via reopen()")
            return self._submit_direct(list(reqs), now, timeout_s)
        with self._cond:
            if self._stopped:
                raise RuntimeError("scheduler is not running")
            if len(self._q) + len(reqs) > self.max_queue:
                self.counters["rejected"] += len(reqs)
                raise Overloaded(self._retry_after_locked())
            out = []
            for req in reqs:
                p = _Pending(req, Future(), now, now + timeout_s,
                             pin.retain() if pin is not None else None)
                self._q.append(p)
                out.append(p.future)
            self.counters["submitted"] += len(reqs)
            # wake enough workers to spread a multi-request call; one
            # notify would serve it as sequential windows on one worker
            self._cond.notify(min(len(reqs), self.n_workers))
        return out

    # -- sharded direct dispatch ---------------------------------------------
    def _submit_direct(self, reqs: list[QueryRequest], now: float,
                       timeout_s: float) -> list[Future]:
        """Admission + inline async dispatch for a sharded backend.

        The bound is per shard, on dispatched-but-unanswered depth: a call
        is rejected only when a shard it targets is saturated, so a hot
        shard cannot starve admission for traffic bound elsewhere.
        Scatter requests count against every shard (they run on all).
        """
        targets = []
        incoming: dict[int, int] = {}
        for req in reqs:
            s = self._shard_of(req)
            shards = tuple(range(self.n_shards)) if s is None else (int(s),)
            targets.append(shards)
            for t in shards:
                incoming[t] = incoming.get(t, 0) + 1
        with self._lock:
            if self._stopped:
                raise RuntimeError("scheduler is not running")
            if any(self._admitted[s] + k > self.max_queue
                   for s, k in incoming.items()):
                self.counters["rejected"] += len(reqs)
                raise Overloaded(self._retry_after_locked())
            for s, k in incoming.items():
                self._admitted[s] += k  # released in _chain_cb
            self.counters["submitted"] += len(reqs)
            self.counters["batches"] += 1
            self.counters["batched_requests"] += len(reqs)
        try:
            server_futs = self._serve_window_async(reqs)
        except BaseException:
            with self._lock:  # dispatch failed: release the admission
                for s, k in incoming.items():
                    self._admitted[s] -= k
            raise
        out = []
        n = max(len(reqs), 1)
        for req, sf, shards in zip(reqs, server_futs, targets):
            p = _Pending(req, Future(), now, now + timeout_s)
            sf.add_done_callback(self._chain_cb(p, now, n, shards))
            out.append(p.future)
        return out

    def _chain_cb(self, p: _Pending, t0: float, window_n: int,
                  shards: tuple[int, ...] = ()):
        """Completion hook for one directly-dispatched request: forward
        the shard result to the caller's future (on the shard pump
        thread) and do the per-request bookkeeping."""

        def done(f) -> None:
            exc = f.exception()
            res = (QueryError(op=str(getattr(p.req, "op", "?")),
                              error=type(exc).__name__, message=str(exc))
                   if exc is not None else f.result())
            if not p.future.cancelled():
                self._resolve(p.future, res)
            dt = monotime() - t0
            op = str(getattr(p.req, "op", "?"))
            rec = recorder()
            if rec.enabled:
                # one span per admitted slot: coalesced duplicates each
                # keep their own _Pending (and their own trace id), so
                # every caller's trace shows its dispatch
                rec.record("dispatch", op, t0, dt,
                           trace_id=getattr(p.req, "trace_id", None) or "")
                if isinstance(res, QueryError):
                    rec.dump(f"query_error op={op} error={res.error}")
            with self._lock:
                for s in shards:
                    self._admitted[s] -= 1
                self.counters["completed"] += 1
                if isinstance(res, QueryError):
                    self.counters["errors"] += 1
                self.latency.labels(op).observe(dt)
                self.queue_wait.observe(max(t0 - p.enq_t, 0.0))
                # call completion time / call size approximates the
                # per-request service time for the drain estimate
                self._ewma_service_s += 0.05 * (dt / window_n
                                                - self._ewma_service_s)

        return done

    # -- window serving -------------------------------------------------------
    def _collect(self) -> list[_Pending] | None:
        """Block for the next micro-batch window; ``None`` on shutdown.

        The wait loop honors ``adaptive_wait``: holding a window open only
        pays when every other worker is busy serving — an idle peer would
        absorb new arrivals instantly, so the window flushes immediately.
        """
        with self._cond:
            while not self._q:
                if self._stopped:
                    return None
                self._idle += 1
                if self._holding:
                    # a newly idle peer invalidates any held-open window
                    # (adaptive rule) — wake the holders to re-check;
                    # gated on _holding so parked idle workers don't
                    # wake each other in an endless ping-pong
                    self._cond.notify_all()
                try:
                    self._cond.wait()
                finally:
                    self._idle -= 1
            batch = [self._q.popleft()]
            window_end = monotime() + self.max_wait_s
            while len(batch) < self.max_batch:
                if self._q:
                    batch.append(self._q.popleft())
                    continue
                remaining = window_end - monotime()
                if remaining <= 0 or self._stopped:
                    break
                if self.adaptive_wait and self._idle > 0:
                    break  # an idle peer makes waiting pure latency
                self._holding += 1
                try:
                    self._cond.wait(remaining)
                finally:
                    self._holding -= 1
            return batch

    def _execute(self, batch: list[_Pending]) -> None:
        try:
            self._execute_inner(batch)
        finally:
            # every pending passes through here exactly once (served,
            # expired, or cancelled) — the single release point that
            # balances submit_many's per-request retain
            for p in batch:
                if p.pin is not None:
                    p.pin.release()

    def _execute_inner(self, batch: list[_Pending]) -> None:
        now = monotime()
        live: list[_Pending] = []
        for p in batch:
            if p.future.cancelled():
                continue
            if now > p.deadline:
                with self._lock:
                    self.counters["expired"] += 1
                self._resolve(p.future, QueryError(
                    op=str(getattr(p.req, "op", "?")),
                    error="DeadlineExceeded",
                    message=f"spent {now - p.enq_t:.3f}s queued"))
                continue
            live.append(p)
        if not live:
            return
        with self._lock:
            self.counters["batches"] += 1
            self.counters["batched_requests"] += len(live)
        # plane-locality order: every hot plane decodes once per window
        order = sorted(range(len(live)),
                       key=lambda i: self.server._locality_key(live[i].req))
        rec = recorder()
        observed: list[tuple[str, float, float, float, bool, str]] = []
        for i in order:
            p = live[i]
            t0 = monotime()
            res = (self.server.serve_one(p.req, db=p.pin.db)
                   if p.pin is not None else self.server.serve_one(p.req))
            dt = monotime() - t0
            observed.append((str(getattr(p.req, "op", "?")), dt,
                             t0 - p.enq_t, t0, isinstance(res, QueryError),
                             getattr(p.req, "trace_id", None) or ""))
            if not p.future.cancelled():
                self._resolve(p.future, res)
        if rec.enabled:
            for op, dt, waited, t0, failed, tid in observed:
                rec.record("queue_wait", op, t0 - max(waited, 0.0),
                           max(waited, 0.0), trace_id=tid)
                rec.record("dispatch", op, t0, dt, trace_id=tid)
                if failed:
                    rec.dump(f"query_error op={op}")
        # one bookkeeping pass per window, not per request — the lock is
        # shared with submit(), so per-request acquisition would tax the
        # serving loop exactly where batching should be amortizing it
        with self._lock:
            for op, dt, waited, _t0, failed, _tid in observed:
                self.counters["completed"] += 1
                if failed:
                    self.counters["errors"] += 1
                self.latency.labels(op).observe(dt)
                self.queue_wait.observe(waited)
                self._ewma_service_s += 0.05 * (dt - self._ewma_service_s)

    def _worker_loop(self, w: int) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._execute(batch)

    # -- observability --------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["queue_depth"] = len(self._q) + self._inflight_depth()
            if self.tenant:
                out["tenant"] = self.tenant
            out["n_shards"] = self.n_shards
            out["direct_dispatch"] = self._direct
            if self._direct:
                out["admitted_per_shard"] = list(self._admitted)
            out["max_queue"] = self.max_queue
            out["max_batch"] = self.max_batch
            out["max_wait_ms"] = self.max_wait_s * 1e3
            out["adaptive_wait"] = self.adaptive_wait
            out["workers"] = self.n_workers
            out["executor"] = self._executor_name
            out["ewma_service_ms"] = self._ewma_service_s * 1e3
            out["mean_batch_size"] = (
                self.counters["batched_requests"]
                / max(self.counters["batches"], 1))
            out["latency"] = {op: h.as_dict() for op, h in self.latency.items()}
            out["queue_wait"] = self.queue_wait.as_dict()
        return out
