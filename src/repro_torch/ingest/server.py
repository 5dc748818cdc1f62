"""HTTP upload endpoint for the live ingest tier.

One :class:`IngestHTTPServer` owns a snapshot root::

    root/
      spool/              accepted-but-unmerged uploads (crash-safe queue;
                          each entry's filename carries a crc32 of its
                          bytes, verified on restart recovery)
      spool/quarantine/   entries whose checksum failed recovery (torn
                          writes / bit rot), kept for inspection
      epoch-NNNNNNNNNN/   published snapshots (repro_torch.ingest.snapshot)
      CURRENT             atomic pointer to the newest epoch

Uploads land in the spool from connection threads; a single **merger
thread** drains them through :meth:`~repro_torch.ingest.state.IngestState.append`
— the incremental phase-2 pipeline — so aggregation order is the arrival
order and the resident state is only ever touched by one thread.  A
publish (explicit ``POST /v1/publish`` or automatic every
``publish_every`` profiles) writes the state as a fresh epoch through
:class:`~repro_torch.ingest.snapshot.SnapshotStore` and GCs old epochs past the
retention bound.  Followers (``query-server --follow``) pick the new
epoch up from ``CURRENT`` without restart.

Endpoints::

    POST /v1/ingest   application/octet-stream: one RPRF profile blob
                      application/json: {"profiles": ["<b64 rprf>", ...]}
                      -> 200 {"accepted": k, "pending": n}
                      -> 400 not RPRF / malformed envelope
                      -> 413 body over max_body_bytes
                      -> 429 + Retry-After when the spool backlog is full
    POST /v1/publish  drain the spool, write a snapshot, GC old epochs
                      -> 200 {"epoch": N, "dir": ..., "stats": {...}}
    GET  /v1/epochs   {"current": N, "epochs": [...], "pinned": [...]}
    GET  /healthz     liveness + resident-state size
    GET  /metrics     ingest/merge/publish counters and latency histograms

Error codes mirror the query transport (:mod:`repro_torch.serve.http`), so one
:class:`~repro_torch.serve.client.RetryPolicy` drives clients of both services.
"""
from __future__ import annotations

import base64
import json
import math
import os
import queue as queue_mod
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from repro_torch.core.sparse import PROFILE_MAGIC
from repro_torch.ingest.snapshot import SnapshotStore
from repro_torch.ingest.state import IngestState
from repro_torch.obs import MetricsRegistry, monotime, recorder, valid_trace_id
from repro_torch.serve.scheduler import Overloaded

MAX_BODY_BYTES = 64 << 20
SPOOL_DIR = "spool"
QUARANTINE_DIR = "quarantine"  # under spool/: corrupt entries land here


def spool_entry_name(seq: int, blob: bytes) -> str:
    """Spool filename carrying its own integrity check:
    ``NNNNNNNNNNNN.<crc32 hex>.rprf``.  The crc is of the blob as
    written, so a restart can detect torn/bit-rotted entries without
    parsing them."""
    return f"{seq:012d}.{zlib.crc32(blob) & 0xFFFFFFFF:08x}.rprf"


def spool_entry_ok(path: str, name: str) -> bool:
    """Verify one recovered spool entry.  Checksummed names must match
    their crc; legacy names (``NNNNNNNNNNNN.rprf``, written before
    checksumming) are accepted iff the content still looks like an RPRF
    blob — the strongest check available for them."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    parts = name.split(".")
    if len(parts) == 3:  # seq.crc.rprf
        try:
            want = int(parts[1], 16)
        except ValueError:
            return False
        return (zlib.crc32(data) & 0xFFFFFFFF) == want
    return data.startswith(PROFILE_MAGIC)


class _BadUpload(ValueError):
    pass


class _TooLarge(ValueError):
    pass


class IngestHTTPServer:
    """Continuous profile uploads -> incremental aggregation -> snapshots.

    ``max_pending`` bounds the spool backlog (admission control: beyond it
    uploads get 429 with a ``Retry-After`` derived from the observed merge
    rate); ``publish_every`` > 0 publishes a snapshot automatically each
    time that many new profiles have merged; ``retain`` epochs are kept by
    the post-publish GC (plus the current epoch and any pinned ones).

    :meth:`pause`/:meth:`resume` freeze the merger between batches —
    deterministic backpressure for tests and maintenance windows.
    """

    def __init__(self, root, *, host: str = "127.0.0.1", port: int = 0,
                 config=None, max_body_bytes: int = MAX_BODY_BYTES,
                 max_pending: int = 256, merge_batch: int = 32,
                 publish_every: int = 0, retain: int = 2):
        self.root = str(root)
        self.store = SnapshotStore(self.root)
        self.state = IngestState(config=config)
        self.max_body_bytes = int(max_body_bytes)
        self.max_pending = max(1, int(max_pending))
        self.merge_batch = max(1, int(merge_batch))
        self.publish_every = max(0, int(publish_every))
        self.retain = max(1, int(retain))
        self.host, self._port = host, int(port)

        self._spool = os.path.join(self.root, SPOOL_DIR)
        os.makedirs(self._spool, exist_ok=True)
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._lock = threading.Lock()          # counters + spool seq
        self._state_lock = threading.Lock()    # resident IngestState
        self._seq = 0
        self._pending = 0                      # spooled, not yet merged
        self._merging = False
        self._paused = threading.Event()
        self._stop = threading.Event()
        self._merger: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._started_t = 0.0
        self._last_pub_profiles = 0
        # counters + histograms on one obs registry: the JSON /metrics view
        # reads them as before, GET /metrics?format=prom renders the same
        # instruments as Prometheus text exposition
        self.obs = MetricsRegistry()
        self._merge_hist = self.obs.histogram("ingest.merge_latency")
        self._publish_hist = self.obs.histogram("ingest.publish_latency")
        self._counters = self.obs.group(
            "ingest", {"http_requests": 0, "profiles_ingested": 0,
                       "bytes_ingested": 0, "profiles_merged": 0,
                       "merges": 0, "merge_failures": 0,
                       "epochs_published": 0, "gc_removed": 0,
                       "rejected_overload": 0, "rejected_bad": 0,
                       "spool_quarantined": 0})
        self.obs.gauge("ingest.pending", lambda: self._pending)
        self.obs.gauge("ingest.paused", lambda: self._paused.is_set())
        self.obs.gauge("ingest.resident_profiles",
                       lambda: self.state.n_profiles)
        self.obs.gauge("ingest.resident_contexts",
                       lambda: len(self.state.tree.parent))
        self.obs.gauge("ingest.uptime_s",
                       lambda: monotime() - self._started_t)
        self._last_merge_error: str | None = None
        self._draining = False

        # recover a spool left behind by a crash: verify each entry's
        # checksum and re-enqueue the good ones in seq order; corrupt
        # entries (torn writes, bit rot) go to spool/quarantine/ for
        # inspection instead of poisoning a merge batch
        self._quarantine_dir = os.path.join(self._spool, QUARANTINE_DIR)
        for name in sorted(os.listdir(self._spool)):
            if not name.endswith(".rprf"):
                continue
            path = os.path.join(self._spool, name)
            try:
                self._seq = max(self._seq,
                                int(name.split(".", 1)[0], 10) + 1)
            except ValueError:
                self._quarantine(path, name)
                continue
            if spool_entry_ok(path, name):
                self._queue.put(path)
                self._pending += 1
            else:
                self._quarantine(path, name)

    def _quarantine(self, path: str, name: str) -> None:
        os.makedirs(self._quarantine_dir, exist_ok=True)
        try:
            os.replace(path, os.path.join(self._quarantine_dir, name))
        except OSError:
            return
        self._counters["spool_quarantined"] += 1

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "IngestHTTPServer":
        if self._httpd is not None:
            return self
        self._merger = threading.Thread(target=self._merge_loop, daemon=True,
                                        name="ingest-merger")
        self._merger.start()
        service = self

        class Handler(_IngestHandler):
            pass

        Handler.service = service
        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._started_t = monotime()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True, name="ingest-http")
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 10.0) -> dict:
        """Graceful shutdown, phase one: new uploads are shed with
        ``503 {"error": "Draining"}`` while the merger keeps folding the
        spooled backlog for up to ``timeout_s``.  Anything still spooled
        at the deadline is safe — spool entries are durable and recovered
        (checksum-verified) on the next start.  Follow with :meth:`stop`.
        """
        self._draining = True
        t0 = monotime()
        deadline = t0 + max(0.0, float(timeout_s))
        drained = False
        while monotime() < deadline:
            with self._lock:
                if self._pending == 0 and not self._merging:
                    drained = True
                    break
            if self._paused.is_set():
                break  # a paused merger will never drain; don't spin
            time.sleep(0.02)
        return {"drained": drained, "pending": self._pending,
                "waited_s": round(monotime() - t0, 3)}

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._merger is not None:
            self._merger.join(timeout=10.0)
            self._merger = None

    @property
    def address(self) -> tuple[str, int]:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def __enter__(self) -> "IngestHTTPServer":
        return self.start()

    def __exit__(self, *a) -> None:
        self.stop()

    # -- merger control -------------------------------------------------------
    def pause(self) -> None:
        """Freeze the merger between batches (uploads keep spooling until
        the backlog hits ``max_pending`` and 429s start)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    # -- upload admission -----------------------------------------------------
    def enqueue(self, blobs: list[bytes]) -> dict:
        """Validate, spool, and queue uploaded profile blobs."""
        for b in blobs:
            if not b.startswith(PROFILE_MAGIC):
                raise _BadUpload("not an RPRF profile blob")
        with self._lock:
            if self._pending + len(blobs) > self.max_pending:
                self._counters["rejected_overload"] += 1
                # hint scaled by how long a merge batch takes to drain
                hint = max(0.05, self._merge_hist.quantile(0.5) or 0.1)
                raise Overloaded(retry_after_s=hint)
            paths = []
            for b in blobs:
                path = os.path.join(self._spool,
                                    spool_entry_name(self._seq, b))
                self._seq += 1
                paths.append((path, b))
            self._pending += len(blobs)
            self._counters["profiles_ingested"] += len(blobs)
            self._counters["bytes_ingested"] += sum(len(b) for b in blobs)
            pending = self._pending
        for path, b in paths:
            with open(path, "wb") as f:
                f.write(b)
            self._queue.put(path)
        return {"accepted": len(blobs), "pending": pending}

    # -- merger ---------------------------------------------------------------
    def _merge_loop(self) -> None:
        while not self._stop.is_set():
            if self._paused.is_set():
                time.sleep(0.01)
                continue
            try:
                first = self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            # a pause() may land while we were blocked in get(): hold the
            # dequeued item (still counted as pending) instead of merging
            # it, so pause really freezes the state between batches
            while self._paused.is_set() and not self._stop.is_set():
                time.sleep(0.01)
            if self._stop.is_set():
                break  # still spooled on disk; recovered on restart
            batch = [first]
            while len(batch) < self.merge_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue_mod.Empty:
                    break
            with self._lock:
                self._merging = True
            try:
                t0 = monotime()
                with self._state_lock:
                    self.state.append(batch)
                self._merge_hist.observe(monotime() - t0)
                for path in batch:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                with self._lock:
                    self._counters["merges"] += 1
                    self._counters["profiles_merged"] += len(batch)
            except Exception as e:                          # noqa: BLE001
                # append() is all-or-nothing: state is unchanged; drop the
                # poisoned batch so one corrupt blob cannot wedge ingest
                with self._lock:
                    self._counters["merge_failures"] += 1
                self._last_merge_error = f"{type(e).__name__}: {e}"
                for path in batch:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            finally:
                with self._lock:
                    self._pending -= len(batch)
                    self._merging = False
            if (self.publish_every
                    and (self.state.n_profiles - self._last_pub_profiles
                         >= self.publish_every)):
                try:
                    self._do_publish()
                except Exception as e:                      # noqa: BLE001
                    self._last_merge_error = (
                        f"auto-publish: {type(e).__name__}: {e}")

    def _drain(self, timeout_s: float) -> None:
        deadline = monotime() + float(timeout_s)
        while True:
            with self._lock:
                if self._pending == 0 and not self._merging:
                    return
                stuck = self._paused.is_set() and self._pending > 0
            if stuck:
                raise RuntimeError("merger is paused with uploads pending; "
                                   "resume() before publishing")
            if monotime() > deadline:
                raise TimeoutError(
                    f"spool did not drain within {timeout_s:.0f}s")
            time.sleep(0.01)

    # -- publish --------------------------------------------------------------
    def _do_publish(self) -> dict:
        with self._state_lock:
            if self.state.n_profiles == 0:
                raise ValueError("nothing to publish: no profiles ingested")
            t0 = monotime()
            stats_box = {}

            def write(stage: str) -> None:
                stats_box.update(self.state.write_database(stage))

            epoch, final_dir = self.store.publish(
                write, extra_meta={"n_profiles": self.state.n_profiles})
            self._last_pub_profiles = self.state.n_profiles
        removed = self.store.gc(retain=self.retain)
        dt = monotime() - t0
        self._publish_hist.observe(dt)
        with self._lock:
            self._counters["epochs_published"] += 1
            self._counters["gc_removed"] += len(removed)
        return {"epoch": epoch, "dir": final_dir, "seconds": round(dt, 4),
                "gc_removed": removed, "stats": stats_box}

    def publish(self, *, timeout_s: float = 120.0) -> dict:
        """Drain the spool, then snapshot the resident state as the next
        epoch and GC old ones.  Blocks until the snapshot is durable."""
        self._drain(timeout_s)
        return self._do_publish()

    # -- introspection --------------------------------------------------------
    def health(self) -> dict:
        cur = self.store.current()
        return {"status": "ok",
                "profiles": self.state.n_profiles,
                "contexts": len(self.state.tree.parent),
                "pending": self._pending,
                "paused": self._paused.is_set(),
                "draining": self._draining,
                "epoch": cur[0] if cur else None,
                "uptime_s": round(monotime() - self._started_t, 3)}

    def epochs(self) -> dict:
        """The ``GET /v1/epochs`` body.  ``pinned`` is a sorted list: the
        reference returns the store's set, which JSON cannot encode, so its
        endpoint drops the connection instead of answering."""
        cur = self.store.current()
        return {"current": cur[0] if cur else None,
                "epochs": self.store.epochs(),
                "pinned": sorted(self.store.pinned_epochs())}

    def metrics(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        out.update({"pending": self._pending,
                    "paused": self._paused.is_set(),
                    "resident_profiles": self.state.n_profiles,
                    "resident_contexts": len(self.state.tree.parent),
                    "merge_latency": self._merge_hist.as_dict(),
                    "publish_latency": self._publish_hist.as_dict(),
                    "last_merge_error": self._last_merge_error,
                    "epochs": self.store.epochs(),
                    "uptime_s": round(monotime() - self._started_t, 3)})
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition of every ingest instrument."""
        return MetricsRegistry.render([self.obs])

    # -- request bodies -------------------------------------------------------
    def ingest_call(self, body: bytes, content_type: str,
                    trace_id: str | None = None) -> dict:
        """Decode one upload body and spool it.  A JSON envelope may carry
        a ``trace_id`` (same contract as the query transport's
        ``X-Trace-Id`` header, which also lands here) — the accept path
        records an ``ingest`` span under that id."""
        tid = trace_id if trace_id and valid_trace_id(trace_id) else ""
        if content_type.startswith("application/json"):
            try:
                obj = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise _BadUpload(f"malformed JSON envelope: {e}") from None
            raw = obj.get("profiles") if isinstance(obj, dict) else None
            if not isinstance(raw, list) or not raw:
                raise _BadUpload("body needs a non-empty 'profiles' list")
            env_tid = obj.get("trace_id")
            if not tid and isinstance(env_tid, str) and valid_trace_id(env_tid):
                tid = env_tid
            try:
                blobs = [base64.b64decode(s) for s in raw]
            except (TypeError, ValueError) as e:
                raise _BadUpload(f"profiles must be base64: {e}") from None
        else:
            blobs = [body]
        rec = recorder()
        t0 = monotime() if rec.enabled else 0.0
        out = self.enqueue(blobs)
        if rec.enabled:
            rec.record("ingest", "upload", t0, monotime() - t0,
                       trace_id=tid, attrs={"profiles": len(blobs)})
        if tid:
            out["trace_id"] = tid
        return out


class _IngestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-ingest/1.0"
    # a reply is written as headers, then body: with Nagle's algorithm on
    # (the reference's setting) a body that fits one segment waits for the
    # client's delayed ACK of the headers (40 ms at least on Linux)
    disable_nagle_algorithm = True
    service: IngestHTTPServer  # injected per server instance

    def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
        pass

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

    def do_GET(self):  # noqa: N802 - stdlib casing
        svc = self.service
        parts = urlsplit(self.path)
        if parts.path == "/healthz":
            self._send_json(200, svc.health())
        elif parts.path == "/metrics":
            q = parse_qs(parts.query)
            if q.get("format", [""])[0] == "prom":
                payload = svc.prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self._send_json(200, svc.metrics())
        elif parts.path == "/v1/epochs":
            self._send_json(200, svc.epochs())
        else:
            self._send_json(404, {"error": "NotFound", "path": self.path})

    def do_POST(self):  # noqa: N802 - stdlib casing
        svc = self.service
        if svc._draining:
            # structured shed: the spool stays durable, the uploader's
            # RetryPolicy moves to another instance or retries later
            self.close_connection = True
            self._send_json(503, {"error": "Draining",
                                  "message": "ingest endpoint is draining"},
                            {"Retry-After": "1", "Connection": "close"})
            return
        svc._counters["http_requests"] += 1
        try:
            if self.path == "/v1/ingest":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    n = -1
                if n > svc.max_body_bytes:
                    # never read: drop the connection so the keep-alive
                    # stream cannot desynchronize on the unread bytes
                    self.close_connection = True
                    raise _TooLarge(f"body of {n} bytes exceeds "
                                    f"{svc.max_body_bytes}")
                if n <= 0:
                    self.close_connection = True
                    raise _BadUpload("Content-Length required and positive")
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type",
                                         "application/octet-stream")
                self._send_json(200, svc.ingest_call(
                    body, ctype, trace_id=self.headers.get("X-Trace-Id")))
            elif self.path == "/v1/publish":
                # drain any (small) body so the keep-alive stream stays
                # aligned for the next request on this connection
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    n = 0
                if n > 4096:
                    self.close_connection = True
                    raise _BadUpload("publish takes no body")
                if n > 0:
                    self.rfile.read(n)
                self._send_json(200, svc.publish())
            else:
                self._send_json(404, {"error": "NotFound", "path": self.path})
        except _TooLarge as e:
            self._send_json(413, {"error": "TooLarge", "message": str(e)})
        except (_BadUpload, ValueError) as e:
            self._send_json(400, {"error": "BadRequest", "message": str(e)})
        except Overloaded as e:
            self._send_json(
                429, {"error": "Overloaded",
                      "retry_after_s": e.retry_after_s},
                {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
        except Exception as e:  # noqa: BLE001 - last-resort 500
            self._send_json(500, {"error": type(e).__name__,
                                  "message": str(e)})
