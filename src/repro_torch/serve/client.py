"""Typed stdlib client for the query service HTTP transport.

One :class:`QueryClient` wraps one keep-alive ``http.client`` connection
(HTTP/1.1), decodes the :mod:`repro_torch.serve.wire` payloads back into the
same types :meth:`QueryServer.submit` returns locally (``SparseMetrics``,
``(profiles, values)`` arrays, ``HotPath`` rows, ``Trace`` windows), and
maps transport-level failures to typed exceptions:

* :class:`ServerOverloaded` — admission control said 429; carries the
  server's ``Retry-After`` hint;
* :class:`RequestFailed` — a single-op convenience call resolved to a
  structured :class:`~repro_torch.serve.engine.QueryError` (batch calls return
  the error objects inline instead, preserving slot alignment).

:class:`RetryPolicy` (and :meth:`QueryClient.batch_with_retry`) adds
client-side retry-with-backoff: 429s honor the server's ``Retry-After``
hint, transient transport failures back off exponentially with full
jitter, non-retryable 4xx fail fast, and a retry budget bounds the total
time spent.

Not thread-safe: it is one socket.  Give each load-generator client its
own instance (they are cheap) — exactly what ``benchmarks/serve_load.py``
does.
"""
from __future__ import annotations

import http.client
import json
import random
import time
from dataclasses import dataclass, field
from urllib.parse import urlencode

from repro_torch.diagnose.findings import Finding
from repro_torch.serve.engine import QueryError, QueryRequest
from repro_torch.serve.wire import request_to_wire, result_from_wire


class ServerOverloaded(RuntimeError):
    def __init__(self, retry_after_s: float):
        super().__init__(f"server overloaded; retry after {retry_after_s:.2f}s")
        self.retry_after_s = float(retry_after_s)


class RequestFailed(RuntimeError):
    def __init__(self, err: QueryError):
        super().__init__(f"{err.error}: {err.message} (op={err.op})")
        self.query_error = err


class TransportError(RuntimeError):
    """Non-2xx/429 responses: 400 envelopes, 500s, unreachable paths."""

    def __init__(self, status: int, body: dict):
        super().__init__(f"HTTP {status}: {body}")
        self.status, self.body = status, body


class RetryBudgetExceeded(RuntimeError):
    """The retry policy ran out of budget/attempts; carries the last
    transport-level failure as ``__cause__``."""


@dataclass
class RetryPolicy:
    """Retry-with-backoff for transient service failures.

    * **what retries**: 429 (:class:`ServerOverloaded` — honoring the
      server's ``Retry-After`` hint as a floor), 5xx responses, and socket
      -level :class:`OSError`/``http.client`` failures (server restarting);
    * **what fails fast**: every other 4xx (:class:`TransportError` with
      ``400 <= status < 500``) — the request is structurally wrong and
      will never succeed, so retrying would loop forever on e.g. a 413;
    * **backoff**: exponential from ``base_s`` capped at ``max_backoff_s``
      with full jitter (``uniform(0, wait)``) so a herd of clients bounced
      by the same overload spike does not re-arrive in lockstep;
    * **budget**: total time spent (including the next planned sleep) is
      bounded by ``budget_s`` and attempts by ``max_attempts`` — whichever
      runs out first raises :class:`RetryBudgetExceeded` from the last
      failure.
    """

    max_attempts: int = 6
    budget_s: float = 30.0
    base_s: float = 0.05
    max_backoff_s: float = 2.0
    jitter: bool = True
    rng: random.Random = field(default_factory=random.Random)

    def backoff_s(self, attempt: int, retry_after_s: float = 0.0) -> float:
        """Sleep before retry ``attempt`` (0-based), >= the server hint."""
        wait = min(self.base_s * (2 ** attempt), self.max_backoff_s)
        if self.jitter:
            wait = self.rng.uniform(0.0, wait)
        return max(wait, float(retry_after_s))

    def call(self, fn, *, sleep=time.sleep):
        """Run ``fn()`` under this policy; returns its result."""
        t0 = time.monotonic()
        last: Exception | None = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn()
            except ServerOverloaded as e:
                last, hint = e, e.retry_after_s
            except TransportError as e:
                if 400 <= e.status < 500:
                    raise  # non-retryable: the request itself is wrong
                last, hint = e, 0.0
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                last, hint = e, 0.0
            wait = self.backoff_s(attempt, hint)
            if (attempt + 1 >= self.max_attempts
                    or time.monotonic() - t0 + wait > self.budget_s):
                break
            sleep(wait)
        raise RetryBudgetExceeded(
            f"gave up after {attempt + 1} attempt(s) / "
            f"{time.monotonic() - t0:.2f}s") from last


class JSONClient:
    """One keep-alive HTTP/1.1 connection speaking JSON envelopes.

    The shared transport under :class:`QueryClient` and the ingest tier's
    :class:`~repro_torch.ingest.client.IngestClient`: JSON (or raw-bytes) request
    bodies, JSON responses, 429 -> :class:`ServerOverloaded` (so one
    :class:`RetryPolicy` serves both services), everything else non-200 ->
    :class:`TransportError`.
    """

    def __init__(self, host: str, port: int, *, timeout_s: float = 30.0):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self._conn: http.client.HTTPConnection | None = None

    # -- transport ------------------------------------------------------------
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        return self._conn

    def _roundtrip(self, method: str, path: str, body: dict | None = None,
                   *, raw: bytes | None = None,
                   content_type: str = "application/json",
                   headers: dict | None = None):
        if raw is not None:
            payload: bytes | None = raw
        else:
            payload = (None if body is None
                       else json.dumps(body).encode("utf-8"))
        hdrs = {"Content-Type": content_type} if payload is not None else {}
        if headers:
            hdrs.update(headers)
        headers = hdrs
        for attempt in (0, 1):  # one transparent retry on a dropped keep-alive
            conn = self._connection()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                break
            except (http.client.HTTPException, ConnectionError, OSError):
                self.close()
                if attempt:
                    raise
        obj = json.loads(data.decode("utf-8")) if data else {}
        if resp.status == 429:
            retry = float(obj.get("retry_after_s")
                          or resp.headers.get("Retry-After") or 1.0)
            raise ServerOverloaded(retry)
        if resp.status != 200:
            raise TransportError(resp.status, obj)
        return obj

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *a) -> None:
        self.close()


class QueryClient(JSONClient):
    """``tenant=`` pins every call this client makes to one named tenant
    on a multi-tenant front (sent as the ``tenant`` envelope field /
    ``?tenant=`` query parameter); ``None`` keeps the historical
    default-tenant behavior."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 30.0,
                 tenant: str | None = None):
        super().__init__(host, port, timeout_s=timeout_s)
        self.tenant = tenant

    # -- batched query surface -------------------------------------------------
    def batch(self, requests: list[QueryRequest], *,
              timeout_ms: float | None = None,
              trace_id: str | None = None) -> list:
        """Submit a batch; returns one decoded result per slot (failures as
        inline :class:`QueryError` objects, never exceptions).  ``trace_id``
        is sent as ``X-Trace-Id`` so the server stamps the caller's id on
        every span instead of minting its own."""
        body: dict = {"requests": [request_to_wire(r) for r in requests]}
        if timeout_ms is not None:
            body["timeout_ms"] = timeout_ms
        if self.tenant is not None:
            body["tenant"] = self.tenant
        hdrs = {"X-Trace-Id": trace_id} if trace_id else None
        obj = self._roundtrip("POST", "/v1/query", body, headers=hdrs)
        self.last_trace_id = obj.get("trace_id")
        return [result_from_wire(r) for r in obj["results"]]

    def batch_with_retry(self, requests: list[QueryRequest], *,
                         policy: RetryPolicy | None = None,
                         timeout_ms: float | None = None,
                         trace_id: str | None = None,
                         sleep=time.sleep) -> list:
        """:meth:`batch` wrapped in a :class:`RetryPolicy` (default policy
        when none given): transparently rides out 429 bursts and server
        restarts, fails fast on non-retryable 4xx."""
        policy = policy or RetryPolicy()
        return policy.call(
            lambda: self.batch(requests, timeout_ms=timeout_ms,
                               trace_id=trace_id), sleep=sleep)

    def _one(self, req: QueryRequest):
        res = self.batch([req])[0]
        if isinstance(res, QueryError):
            raise RequestFailed(res)
        return res

    # -- typed convenience ops -------------------------------------------------
    def profile(self, pid: int):
        return self._one(QueryRequest(op="profile", pid=pid))

    def stripe(self, ctx: int, metric, *, inclusive: bool = False):
        return self._one(QueryRequest(op="stripe", ctx=ctx, metric=metric,
                                      inclusive=inclusive))

    def value(self, pid: int, ctx: int, metric, *,
              inclusive: bool = False) -> float:
        return self._one(QueryRequest(op="value", pid=pid, ctx=ctx,
                                      metric=metric, inclusive=inclusive))

    def topk(self, metric, *, k: int = 10, inclusive: bool = True,
             **params):
        return self._one(QueryRequest(op="topk", metric=metric, k=k,
                                      inclusive=inclusive, params=params))

    def window(self, pid: int, t0: float, t1: float):
        return self._one(QueryRequest(op="window", pid=pid, t0=t0, t1=t1))

    def findings(self, *, metric=None, inclusive: bool = False,
                 analyzers=None, limit: int = 0,
                 trace_id: str | None = None) -> list:
        """Run the diagnosis analyzers server-side (``GET /v1/findings``)
        and return typed :class:`~repro_torch.diagnose.Finding` records, most
        severe first.  ``analyzers`` limits the pass (e.g.
        ``("imbalance",)``); default runs the full trace-derived set."""
        q: dict = {}
        if self.tenant is not None:
            q["tenant"] = self.tenant
        if metric is not None:
            q["metric"] = metric
        if inclusive:
            q["inclusive"] = "1"
        if analyzers:
            q["analyzers"] = ",".join(analyzers)
        if limit:
            q["limit"] = int(limit)
        path = "/v1/findings" + (f"?{urlencode(q)}" if q else "")
        hdrs = {"X-Trace-Id": trace_id} if trace_id else None
        obj = self._roundtrip("GET", path, headers=hdrs)
        self.last_trace_id = obj.get("trace_id")
        return [Finding.from_dict(row) for row in obj.get("findings", [])]

    # -- service introspection --------------------------------------------------
    def health(self) -> dict:
        return self._roundtrip("GET", "/healthz")

    def metrics(self) -> dict:
        return self._roundtrip("GET", "/metrics")
