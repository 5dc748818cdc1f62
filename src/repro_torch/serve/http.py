"""Stdlib HTTP transport for the query service.

One ``ThreadingHTTPServer`` in front of one shared
:class:`~repro_torch.query.Database`; connection threads parse/serialize, the
:class:`~repro_torch.serve.scheduler.BatchScheduler` owns execution so requests
from *different* connections coalesce into plane-locality windows.  With
``shards=N`` the execution engine is a
:class:`~repro_torch.serve.shard.ShardedQueryServer` — N worker processes behind
the same transport, consistent-hash routed by plane — which lifts the GIL
ceiling on decode-heavy traffic.

Endpoints::

    POST /v1/query    {"requests": [{...}, ...], "timeout_ms": 5000}
                      -> 200 {"results": [...], "trace_id": "..."}
                      -> 429 + Retry-After when admission control rejects
                      -> 400 on malformed JSON envelopes
                      ?tenant= (or a "tenant" envelope field) routes to a
                      named tenant on a multi-tenant front; unknown -> 404
    GET  /v1/findings diagnosis findings for a tenant's current epoch
                      (?tenant=, ?metric=, ?inclusive=1, ?analyzers=a,b,
                      ?limit=N) -> {"findings": [...], "count": N};
                      admitted through the tenant's scheduler like any
                      query, so it 429s under that tenant's overload
    GET  /healthz     liveness + database identity
    GET  /metrics     cache hit/miss/eviction counters, queue depth,
                      admission counters, per-op latency histograms (JSON);
                      ?format=prom renders the same instruments as
                      Prometheus text exposition
    GET  /debug/spans the process flight recorder: recent spans across the
                      whole fleet (workers ship theirs back on replies)
                      plus any frozen worker-death/error dumps

Every call carries a trace id — accepted from an ``X-Trace-Id`` request
header (or a ``trace_id`` envelope field), minted otherwise — stamped on
each request so its spans correlate across scheduler, shard workers, and
replay; the reply echoes it in both body and header.

Payload encoding is :mod:`repro_torch.serve.wire`: a JSON envelope whose array
fields are base64 of the binary on-disk layouts.  ``batching=False`` keeps
the transport but serves each HTTP call directly on its connection thread
— the one-request-at-a-time baseline the load benchmark compares against.
"""
from __future__ import annotations

import json
import math
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from repro_torch.obs import (MetricsRegistry, configure, mint_trace_id, monotime,
                             recorder, valid_trace_id)
from repro_torch.query.database import Database
from repro_torch.query.epoch import EpochSwitcher
from repro_torch.serve.engine import QueryError
from repro_torch.serve.scheduler import BatchScheduler, Overloaded
from repro_torch.serve.shard import ShardedQueryServer
from repro_torch.serve.tenant import TenantBackend
from repro_torch.serve.wire import request_from_wire, result_to_wire

MAX_BODY_BYTES = 16 << 20
MAX_REQUESTS_PER_CALL = 1024

#: tenant name used when the server fronts a single database (the
#: historical mode): requests that name no tenant route here
DEFAULT_TENANT = "default"

#: envelope-only keys of a /v1/query body (everything else in a
#: single-request sugar body is the request itself)
_ENVELOPE_KEYS = ("requests", "timeout_ms", "tenant")


class _CappedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a keep-alive connection cap.

    Every accepted connection holds a handler thread for its whole
    keep-alive lifetime, so an unbounded ThreadingHTTPServer converts a
    connection flood into a thread flood.  With ``max_connections`` set,
    connection number cap+1 is answered with a raw ``429`` +
    ``Retry-After`` and closed *before* a handler thread is spawned —
    the cheapest possible rejection — while established connections are
    unaffected.  ``active``/``rejected`` feed ``/metrics``.
    """

    daemon_threads = True

    def __init__(self, addr, handler, *, max_connections: int = 0):
        self.max_connections = max(0, int(max_connections))
        self.active = 0
        self.rejected = 0
        self._conn_lock = threading.Lock()
        super().__init__(addr, handler)

    def process_request(self, request, client_address):
        if self.max_connections:
            with self._conn_lock:
                if self.active >= self.max_connections:
                    self.rejected += 1
                    reject = True
                else:
                    self.active += 1
                    reject = False
            if reject:
                self._send_reject(request)
                self.close_request(request)
                return
        else:
            with self._conn_lock:
                self.active += 1
        super().process_request(request, client_address)

    @staticmethod
    def _send_reject(request) -> None:
        body = (b'{"error": "TooManyConnections", "retry_after_s": 1, '
                b'"message": "connection cap reached; retry or reuse '
                b'an existing keep-alive connection"}')
        head = ("HTTP/1.1 429 Too Many Requests\r\n"
                "Content-Type: application/json\r\n"
                "Retry-After: 1\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n").encode("ascii")
        try:
            request.sendall(head + body)
        except OSError:
            pass  # client already gone; the close below is all that's left

    def shutdown_request(self, request):
        # end of a connection thread's life (never called for rejects,
        # which close_request directly) — release its cap slot
        try:
            super().shutdown_request(request)
        finally:
            with self._conn_lock:
                self.active = max(0, self.active - 1)

    def handle_error(self, request, client_address):
        # clients hanging up mid-request (resets, broken pipes) are
        # normal churn, not server errors — don't spray tracebacks
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class QueryHTTPServer:
    """The serve subsystem, assembled: warm cache, scheduler, transport.

    ``QueryHTTPServer(db).start()`` binds (``port=0`` picks a free port),
    optionally preloads the hottest planes (``warm_bytes``), and serves
    until :meth:`stop`.  Also usable as a context manager.

    ``shards=N`` (N >= 1) swaps the in-process engine for a
    :class:`~repro_torch.serve.shard.ShardedQueryServer`: N worker processes,
    each with its own Database handle and plane cache, consistent-hash
    routed by plane; the scheduler's admission queues and the warming
    budget become per-shard.  ``shards=0`` (default) keeps single-process
    serving.  ``replicas``/``shard_transport``/``hedge_ms`` pass through
    to the sharded engine (R-way ownership, shm vs tcp peer links, hedged
    reads); ``max_connections`` caps concurrent keep-alive connections —
    connection cap+1 gets a pre-thread ``429`` + ``Retry-After``.

    ``tenants={name: db_or_root, ...}`` (instead of ``db``) serves many
    named databases behind the one listener: each tenant gets its own
    :class:`~repro_torch.serve.tenant.TenantBackend` — engine, scheduler with
    its own admission budget (override per tenant via
    ``tenant_queues={name: N}``), epoch follower — and requests route by
    ``?tenant=`` / the ``"tenant"`` envelope field.  The single-``db``
    form is exactly a one-tenant front named ``"default"``, and the
    historical attribute surface (``srv.db``, ``srv.scheduler``, ...)
    reads through to it.
    """

    def __init__(self, db=None, *, tenants: dict | None = None,
                 tenant_queues: dict | None = None,
                 host: str = "127.0.0.1",
                 port: int = 0, batching: bool = True, max_batch: int = 16,
                 max_wait_ms: float = 0.0, max_queue: int = 256,
                 executor: str = "threads", n_workers: int = 4,
                 default_timeout_s: float = 30.0, adaptive_wait: bool = True,
                 warm_bytes: int | None = 0, shards: int = 0,
                 shard_cache_bytes: int | None = None,
                 shard_slab_bytes: int = 4 << 20, shard_slabs: int = 8,
                 replicas: int = 2, shard_transport: str = "shm",
                 hedge_ms: float | None = None,
                 max_connections: int = 0,
                 follow: bool = False, poll_ms: float = 250.0,
                 follow_wait_s: float = 60.0,
                 follow_cache_bytes: int = 64 << 20,
                 trace_ring: int | None = None):
        if trace_ring is not None:
            # size (or disable, with 0) this process's flight recorder;
            # the sharded engines below inherit the same capacity for
            # their workers
            configure(trace_ring)
        self._poll_s = max(float(poll_ms), 1.0) / 1e3
        backend_kw = dict(
            follow=follow, follow_wait_s=follow_wait_s,
            follow_cache_bytes=follow_cache_bytes, batching=batching,
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=max_queue, executor=executor, n_workers=n_workers,
            default_timeout_s=default_timeout_s, adaptive_wait=adaptive_wait,
            warm_bytes=warm_bytes, shards=shards,
            shard_cache_bytes=shard_cache_bytes,
            shard_slab_bytes=shard_slab_bytes, shard_slabs=shard_slabs,
            replicas=replicas, shard_transport=shard_transport,
            hedge_ms=hedge_ms)
        self.tenants: dict[str, TenantBackend] = {}
        if tenants:
            if db is not None:
                raise TypeError("pass either db or tenants=, not both")
            for name, target in tenants.items():
                kw = dict(backend_kw)
                if tenant_queues and name in tenant_queues:
                    kw["max_queue"] = int(tenant_queues[name])
                self.tenants[name] = TenantBackend(name, target, **kw)
        else:
            self.tenants[DEFAULT_TENANT] = TenantBackend(
                DEFAULT_TENANT, db, **backend_kw)
        self._default = next(iter(self.tenants.values()))
        self.multi_tenant = len(self.tenants) > 1
        self.host, self._port = host, int(port)
        self.batching = self._default.batching
        self.max_connections = max(0, int(max_connections))
        self._draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._httpd: _CappedThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._follower: threading.Thread | None = None
        self._follow_stop = threading.Event()
        self.obs = MetricsRegistry()
        self._http = self.obs.group("http", {"requests": 0})
        self.obs.gauge("http.uptime_s",
                       lambda: max(monotime() - self._started_t, 0.0))
        self.obs.gauge("http.trace_ring_spans",
                       lambda: recorder().recorded)
        self._started_t = 0.0

    # -- single-tenant compatibility surface ----------------------------------
    # The historical one-database API (``srv.db``, ``srv.scheduler``, ...)
    # reads through to the *default* backend — the only one in
    # single-tenant mode — so every existing caller keeps working.
    @property
    def db(self) -> Database:
        """The database answering *new* calls right now (default tenant).
        Under ``follow=True`` this moves when an epoch publishes;
        in-flight batches keep serving their pinned epoch regardless."""
        return self._default.db

    @property
    def engine(self):
        return self._default.engine

    @property
    def scheduler(self) -> BatchScheduler | None:
        return self._default.scheduler

    @property
    def sharded(self) -> ShardedQueryServer | None:
        return self._default.sharded

    @property
    def switcher(self) -> EpochSwitcher | None:
        return self._default.switcher

    @property
    def shards(self) -> int:
        return self._default.shards

    @property
    def warm_report(self) -> dict | None:
        return self._default.warm_report

    @property
    def _follow_errors(self) -> int:
        return sum(b.follow_errors for b in self.tenants.values())

    def tenant(self, name: str | None = None) -> TenantBackend:
        """Resolve a tenant name to its backend (``None`` -> default)."""
        if name is None or name == "":
            return self._default
        try:
            return self.tenants[name]
        except KeyError:
            raise _UnknownTenant(
                f"unknown tenant {name!r}; serving "
                f"{sorted(self.tenants)}") from None

    # -- epoch following ------------------------------------------------------
    def _follow_loop(self) -> None:
        while not self._follow_stop.wait(self._poll_s):
            for b in self.tenants.values():
                b.poll_follow()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "QueryHTTPServer":
        if self._httpd is not None:
            return self
        for b in self.tenants.values():
            b.start()
        service = self

        class Handler(_QueryHandler):
            pass

        Handler.service = service
        self._httpd = _CappedThreadingHTTPServer(
            (self.host, self._port), Handler,
            max_connections=self.max_connections)
        self._started_t = monotime()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True, name="serve-http")
        self._thread.start()
        if any(b.switcher is not None for b in self.tenants.values()):
            self._follow_stop.clear()
            self._follower = threading.Thread(target=self._follow_loop,
                                              daemon=True,
                                              name="serve-epoch-follower")
            self._follower.start()
        return self

    def drain(self, timeout_s: float = 10.0) -> dict:
        """Graceful shutdown, phase one: stop taking new work, finish
        what's in flight, shed the rest with structured errors.

        New ``/v1/query`` calls are answered ``503 {"error": "Draining"}``
        (a retryable signal — a load balancer or retrying client moves to
        another instance); the accept loop keeps running so those
        rejections are clean HTTP, not connection resets.  Established
        calls get up to ``timeout_s`` to complete.  Returns a report;
        the caller then runs :meth:`stop` for teardown.
        """
        self._draining = True
        t0 = monotime()
        deadline = t0 + max(0.0, float(timeout_s))
        # epoch follower first: no new reopens mid-drain
        self._follow_stop.set()
        if self._follower is not None:
            self._follower.join(timeout=max(deadline - monotime(), 0.1))
        drained = True
        # wait on in-flight *requests*, not connections: idle keep-alive
        # connections are harmless and may outlive any drain window
        while self._inflight > 0:
            if monotime() >= deadline:
                drained = False  # stragglers shed by stop()'s teardown
                break
            threading.Event().wait(0.02)
        return {"drained": drained,
                "waited_s": round(monotime() - t0, 3),
                "inflight_requests": self._inflight,
                "active_connections": (self._httpd.active
                                       if self._httpd is not None else 0)}

    def stop(self) -> None:
        self._follow_stop.set()
        if self._follower is not None:
            self._follower.join(timeout=10.0)
            self._follower = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for b in self.tenants.values():
            b.stop()

    @property
    def address(self) -> tuple[str, int]:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def __enter__(self) -> "QueryHTTPServer":
        return self.start()

    def __exit__(self, *a) -> None:
        self.stop()

    # -- endpoint bodies ------------------------------------------------------
    def health(self) -> dict:
        out = {"status": "ok", "batching": self.batching,
               "shards": self.shards,
               "profiles": self.db.n_profiles,
               "contexts": self.db.n_contexts,
               "uptime_s": round(monotime() - self._started_t, 3)}
        if self.switcher is not None:
            out["epoch"] = self.switcher.epoch
        if self.multi_tenant:
            out["tenants"] = {name: b.health_fragment()
                              for name, b in self.tenants.items()}
        return out

    def metrics(self) -> dict:
        # the top level keeps the exact historical single-tenant shape
        # (read through to the default backend); multi-tenant fronts add a
        # per-tenant breakdown under "tenants"
        d = self._default
        out = {"cache": d.db.cache_stats(),
               "db_counters": dict(d.db.counters),
               "http_requests": self._http["requests"],
               "connections": {
                   "cap": self.max_connections,
                   "active": (self._httpd.active
                              if self._httpd is not None else 0),
                   "rejected": (self._httpd.rejected
                                if self._httpd is not None else 0),
                   "draining": self._draining,
               },
               "warm": d.warm_report,
               "uptime_s": round(monotime() - self._started_t, 3)}
        frag = d.metrics_fragment()
        out["scheduler"] = frag["scheduler"]
        out["shards"] = frag["shards"]
        if "epoch" in frag:
            out["epoch"] = frag["epoch"]
        if self.multi_tenant:
            out["tenants"] = {name: b.metrics_fragment()
                              for name, b in self.tenants.items()}
        return out

    def prometheus(self) -> str:
        """Every subsystem's registry, concatenated as one exposition —
        distinct name prefixes (http/db/scheduler/shard) keep the merged
        output collision-free.  A multi-tenant front renders each
        backend's registries with a ``tenant="name"`` label so samples
        stay attributable after aggregation."""
        if not self.multi_tenant:
            return MetricsRegistry.render(
                [self.obs] + self._default.registries())
        parts = [self.obs.prometheus()]
        for name, b in self.tenants.items():
            parts.append(MetricsRegistry.render(
                b.registries(), labels=f'tenant="{name}"'))
        return "".join(parts)

    def debug_spans(self, limit: int = 256) -> dict:
        """The ``GET /debug/spans`` body: this process's flight recorder
        (which includes worker spans shipped back on replies)."""
        return recorder().as_dict(limit=limit)

    def serve_call(self, body: dict, trace_id: str | None = None,
                   tenant: str | None = None) -> dict:
        """One ``/v1/query`` call: parse, admit, await, serialize.

        ``trace_id`` (the ``X-Trace-Id`` header) or a ``trace_id``
        envelope field is propagated; anything missing or malformed is
        replaced by a freshly minted id.  Requests that already carry
        their own valid ``trace_id`` keep it.

        ``tenant`` (the ``?tenant=`` query parameter) or a ``tenant``
        envelope field routes the whole call to that tenant's backend —
        its scheduler admits (or 429s) the call against *its own* queue
        budget, so one tenant at its limit cannot shed a neighbor's
        traffic.  Unnamed calls go to the default (first) tenant.
        """
        call_t0 = monotime()
        backend = self.tenant(tenant if tenant else body.get("tenant"))
        tid = trace_id if valid_trace_id(trace_id) else None
        if tid is None:
            env_tid = body.get("trace_id")
            tid = env_tid if valid_trace_id(env_tid) else mint_trace_id()
        raw = body.get("requests")
        if raw is None and "op" in body:
            # single-request sugar: the body IS the request, minus any
            # envelope-only keys riding alongside it
            raw = [{k: v for k, v in body.items()
                    if k not in _ENVELOPE_KEYS}]
        if not isinstance(raw, list) or not raw:
            raise _BadRequest("body needs a non-empty 'requests' list")
        if len(raw) > MAX_REQUESTS_PER_CALL:
            raise _CallTooLarge(
                f"at most {MAX_REQUESTS_PER_CALL} requests per call")
        scheduler = backend.scheduler
        if scheduler is not None and len(raw) > scheduler.max_queue:
            # could never be admitted: a retrying client would loop forever
            # on 429, so answer non-retryably
            raise _CallTooLarge(
                f"call of {len(raw)} requests exceeds the admission bound "
                f"({scheduler.max_queue}); split it")
        timeout_ms = body.get("timeout_ms")
        try:
            timeout_s = (float(timeout_ms) / 1e3 if timeout_ms is not None
                         else None)
        except (TypeError, ValueError):
            raise _BadRequest(
                f"timeout_ms must be a number, got {timeout_ms!r}") from None

        reqs, parse_errors = [], {}
        for i, obj in enumerate(raw):
            try:
                req = request_from_wire(obj)
                if not valid_trace_id(req.trace_id):
                    req.trace_id = tid  # mutable dataclass: stamp in place
                reqs.append(req)
            except (ValueError, TypeError) as e:
                parse_errors[i] = QueryError(
                    op=str(obj.get("op", "?")) if isinstance(obj, dict)
                    else "?", error="BadRequest", message=str(e))
                reqs.append(None)

        live = [r for r in reqs if r is not None]
        # under follow=True, in-process serving pins this call's whole
        # batch to one epoch handle: a concurrent epoch switch retires the
        # old database but these requests keep reading it (the sharded
        # backend instead pins whole dispatch windows inside reopen())
        pin = (backend.switcher.acquire()
               if backend.switcher is not None and backend.sharded is None
               else None)
        try:
            if scheduler is not None:
                futures = iter(scheduler.submit_many(
                    live, timeout_s=timeout_s, pin=pin))
                deadline = monotime() + (
                    timeout_s or scheduler.default_timeout_s)
                results = []
                for r in reqs:
                    if r is None:
                        results.append(None)
                        continue
                    fut = next(futures)
                    try:
                        results.append(fut.result(
                            timeout=max(deadline - monotime(), 0.0)))
                    except FutureTimeout:
                        results.append(QueryError(
                            op=r.op, error="DeadlineExceeded",
                            message="result wait timed out"))
            else:
                engine = backend.engine
                served = iter(engine.serve(live, db=pin.db)
                              if pin is not None
                              else engine.serve(live))
                results = [None if r is None else next(served) for r in reqs]
        finally:
            if pin is not None:
                pin.release()

        rec = recorder()
        enc_t0 = monotime() if rec.enabled else 0.0
        wire = []
        for i, res in enumerate(results):
            wire.append(result_to_wire(parse_errors[i] if res is None
                                       else res))
        if rec.enabled:
            now = monotime()
            rec.record("encode", "call", enc_t0, now - enc_t0, trace_id=tid,
                       attrs={"n": len(wire)})
            rec.record("request", "call", call_t0, now - call_t0,
                       trace_id=tid, attrs={"n": len(wire)})
        out = {"results": wire, "trace_id": tid}
        if self.multi_tenant:
            out["tenant"] = backend.name
        return out

    def findings_call(self, query: dict, trace_id: str | None = None) -> dict:
        """The ``GET /v1/findings`` body: run the diagnosis analyzers on a
        tenant's current epoch through the normal admission path.

        ``query`` holds flat string query parameters: ``tenant``,
        ``metric`` (id or name), ``inclusive`` (0/1), ``analyzers``
        (comma-separated), ``limit``.  Delegates to :meth:`serve_call`, so
        admission (429), epoch pinning, and tracing behave exactly like a
        POSTed ``findings`` op.
        """
        known = {"tenant", "metric", "inclusive", "analyzers", "limit"}
        unknown = set(query) - known
        if unknown:
            raise _BadRequest(f"unknown query parameters {sorted(unknown)}; "
                              f"known: {sorted(known)}")
        req: dict = {"op": "findings"}
        metric = query.get("metric")
        if metric is not None:
            req["metric"] = (int(metric) if metric.lstrip("-").isdigit()
                             else metric)
        if query.get("inclusive", "") in ("1", "true", "yes"):
            req["inclusive"] = True
        params: dict = {}
        if "analyzers" in query:
            params["analyzers"] = [a for a in query["analyzers"].split(",")
                                   if a]
        if "limit" in query:
            try:
                params["limit"] = int(query["limit"])
            except ValueError:
                raise _BadRequest(
                    f"limit must be an integer, got "
                    f"{query['limit']!r}") from None
        if params:
            req["params"] = params
        out = self.serve_call({"requests": [req]}, trace_id=trace_id,
                              tenant=query.get("tenant"))
        res = out["results"][0]
        if res.get("kind") == "error":
            # analyzer/metric parameter problems surface as per-request
            # errors; for this single-request endpoint they are the
            # caller's fault -> 400
            if res.get("error") in ("ValueError", "KeyError", "BadRequest"):
                raise _BadRequest(res.get("message", "bad findings request"))
            raise RuntimeError(
                f"{res.get('error')}: {res.get('message', '')}")
        body = {"findings": res.get("rows", []), "trace_id": out["trace_id"]}
        body["count"] = len(body["findings"])
        if "tenant" in out:
            body["tenant"] = out["tenant"]
        return body


class _BadRequest(ValueError):
    pass


class _UnknownTenant(ValueError):
    """Named tenant is not served here: 404, routing error, do not retry."""


class _CallTooLarge(ValueError):
    """Structurally oversized call: 413, never admissible, do not retry."""


class _QueryHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-serve/1.0"
    # a reply is written as headers, then body: with Nagle's algorithm on
    # (the reference's setting) a body that fits one segment waits for the
    # client's delayed ACK of the headers (40 ms at least on Linux)
    disable_nagle_algorithm = True
    service: QueryHTTPServer  # injected per server instance

    def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
        pass  # keep the serving path quiet; /metrics is the observer

    def _send_json(self, code: int, obj: dict,
                   extra_headers: dict | None = None) -> None:
        payload = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        payload = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 - stdlib casing
        svc = self.service
        parts = urlsplit(self.path)
        query = parse_qs(parts.query)
        if parts.path == "/healthz":
            self._send_json(200, svc.health())
        elif parts.path == "/metrics":
            if query.get("format", ["json"])[0] == "prom":
                self._send_text(
                    200, svc.prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._send_json(200, svc.metrics())
        elif parts.path == "/debug/spans":
            try:
                limit = int(query.get("limit", ["256"])[0])
            except ValueError:
                limit = 256
            self._send_json(200, svc.debug_spans(limit=max(1, limit)))
        elif parts.path == "/v1/findings":
            if svc._draining:
                self.close_connection = True
                self._send_json(503, {"error": "Draining",
                                      "message": "server is draining; retry "
                                                 "against another instance"},
                                {"Retry-After": "1", "Connection": "close"})
                return
            svc._http.inc("requests")
            with svc._inflight_lock:
                svc._inflight += 1
            try:
                flat = {k: v[0] for k, v in query.items()}
                out = svc.findings_call(
                    flat, trace_id=self.headers.get("X-Trace-Id"))
                self._send_json(200, out,
                                {"X-Trace-Id": out.get("trace_id", "-")})
            except _UnknownTenant as e:
                self._send_json(404, {"error": "UnknownTenant",
                                      "message": str(e)})
            except _BadRequest as e:
                self._send_json(400, {"error": "BadRequest",
                                      "message": str(e)})
            except Overloaded as e:
                self._send_json(
                    429, {"error": "Overloaded",
                          "retry_after_s": e.retry_after_s},
                    {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
            except Exception as e:  # noqa: BLE001 - last-resort 500
                self._send_json(500, {"error": type(e).__name__,
                                      "message": str(e)})
            finally:
                with svc._inflight_lock:
                    svc._inflight -= 1
        else:
            self._send_json(404, {"error": "NotFound", "path": self.path})

    def do_POST(self):  # noqa: N802 - stdlib casing
        svc = self.service
        parts = urlsplit(self.path)
        if parts.path != "/v1/query":
            self._send_json(404, {"error": "NotFound", "path": self.path})
            return
        tenant = parse_qs(parts.query).get("tenant", [None])[0]
        if svc._draining:
            # structured shed: a retrying client or LB moves elsewhere;
            # close so the slot frees for the drain to complete
            self.close_connection = True
            self._send_json(503, {"error": "Draining",
                                  "message": "server is draining; retry "
                                             "against another instance"},
                            {"Retry-After": "1", "Connection": "close"})
            return
        svc._http.inc("requests")
        with svc._inflight_lock:
            svc._inflight += 1
        try:
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n <= 0 or n > MAX_BODY_BYTES:
                # body never read: the stale bytes would desynchronize the
                # keep-alive stream, so drop the connection with the 400
                self.close_connection = True
                raise _BadRequest(f"Content-Length must be in (0, "
                                  f"{MAX_BODY_BYTES}]")
            body = json.loads(self.rfile.read(n).decode("utf-8"))
            if not isinstance(body, dict):
                raise _BadRequest("body must be a JSON object")
            out = svc.serve_call(body,
                                 trace_id=self.headers.get("X-Trace-Id"),
                                 tenant=tenant)
            self._send_json(200, out,
                            {"X-Trace-Id": out.get("trace_id", "-")})
        except _UnknownTenant as e:
            self._send_json(404, {"error": "UnknownTenant", "message": str(e)})
        except _CallTooLarge as e:
            self._send_json(413, {"error": "CallTooLarge", "message": str(e)})
        except (_BadRequest, json.JSONDecodeError, UnicodeDecodeError) as e:
            self._send_json(400, {"error": "BadRequest", "message": str(e)})
        except Overloaded as e:
            self._send_json(
                429, {"error": "Overloaded",
                      "retry_after_s": e.retry_after_s},
                {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
        except Exception as e:  # noqa: BLE001 - last-resort 500
            self._send_json(500, {"error": type(e).__name__, "message": str(e)})
        finally:
            with svc._inflight_lock:
                svc._inflight -= 1
