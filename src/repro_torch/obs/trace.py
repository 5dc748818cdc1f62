"""Request tracing and the per-process flight recorder.

A **trace id** is minted at the HTTP edge (or accepted from an
``X-Trace-Id`` header / ``trace_id`` envelope field), stamped on every
:class:`~repro_torch.serve.engine.QueryRequest` in the call, and rides the
request through the scheduler, across the shm/pickle transport into
shard workers, and back through replay-after-SIGKILL — the wire codec
ships it like any other request field.

A **span** is one timed phase of one request's life (``queue_wait``,
``dispatch``, ``decode``, ``encode``, ``merge``, ``replay``,
``request``), recorded into the process-local :class:`FlightRecorder`:
a bounded ring buffer that costs O(1) per span and can never grow.
Workers ship their freshly recorded spans piggybacked on reply
messages; the parent folds them into its own ring so ``GET
/debug/spans`` shows the whole fleet.  On worker death or a burst of
``QueryError`` results the recorder freezes a dump of the most recent
spans — the last seconds of history that led to the event.

Ring contents export through :mod:`repro_torch.obs.export` into the repo's
own trace-plane format, so the server's execution is queryable with the
same timeline/occupancy ops it serves.
"""
from __future__ import annotations

import os
import re
import threading
from collections import deque
from dataclasses import dataclass, field

from repro_torch.obs.clock import monotime

#: span phase names recorded by the serving stack (docs/observability.md);
#: "failover" marks a request re-dispatched to a live replica after its
#: owner died, "hedge" a duplicate dispatch fired at a replica after the
#: p99-derived hedge delay, "watch" one epoch evaluation by the
#: regression-watch service
SPAN_PHASES = ("request", "queue_wait", "dispatch", "decode", "encode",
               "merge", "replay", "failover", "hedge", "ingest", "watch")

_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,64}$")


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (64 random bits)."""
    return os.urandom(8).hex()


def valid_trace_id(tid) -> bool:
    """Accept only ids that are safe to log, ship, and echo in headers."""
    return isinstance(tid, str) and bool(_TRACE_ID_RE.match(tid))


@dataclass
class Span:
    """One timed phase of one request — picklable, so workers can ship
    spans to the parent on the existing reply transport."""

    trace_id: str
    name: str           # phase: one of SPAN_PHASES
    op: str             # query op ("stripe", "topk", ...) or transport verb
    t0: float           # monotime() at phase start (host-wide comparable)
    dur: float          # seconds
    pid: int            # os pid that recorded it
    shard: int = -1     # owning shard, -1 for the parent / unsharded
    attrs: dict | None = None

    def as_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "name": self.name, "op": self.op,
             "t0": round(self.t0, 6), "dur_ms": round(self.dur * 1e3, 4),
             "pid": self.pid, "shard": self.shard}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


@dataclass
class _Dump:
    reason: str
    t: float
    spans: list = field(default_factory=list)


class FlightRecorder:
    """Bounded ring of recent spans + a bounded outbox for shipping.

    ``capacity`` spans are retained (oldest evicted); ``0`` disables
    recording entirely (every ``record`` is a cheap no-op guarded by
    :attr:`enabled`, which is how the benchmark's traced-off leg pays
    nothing).  All methods are thread-safe; `record` is designed to sit
    on the serving hot path — one deque append under a lock.
    """

    #: retained per dump — the last moments before a death/error burst
    DUMP_SPANS = 128
    #: dumps retained (worker deaths can cluster)
    MAX_DUMPS = 8
    #: min seconds between dumps — an error storm must not spin freezing
    DUMP_INTERVAL_S = 1.0

    def __init__(self, capacity: int = 2048):
        self.capacity = max(0, int(capacity))
        #: stamped on spans recorded without an explicit shard — shard
        #: workers set it once at startup so every span they record
        #: (including ones from shared code like ``serve_one``) carries
        #: the owning shard without threading it through call sites
        self.default_shard = -1
        self._lock = threading.Lock()
        self._ring: deque[Span] = deque(maxlen=max(self.capacity, 1))
        # spans recorded here and not yet shipped to the parent process;
        # bounded separately so a quiet transport can't grow it
        self._outbox: deque[Span] = deque(maxlen=max(self.capacity, 1))
        self._dumps: deque[_Dump] = deque(maxlen=self.MAX_DUMPS)
        self._last_dump_t = -1e9
        self.recorded = 0        # total spans ever recorded (not bounded)
        self.dropped_outbox = 0  # outbox overwrites (ring keeps them)

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, name: str, op: str, t0: float, dur: float, *,
               trace_id: str = "", shard: int = -1,
               attrs: dict | None = None) -> None:
        """Record one locally-measured span (also queued for shipping)."""
        if not self.capacity:
            return
        if shard < 0:
            shard = self.default_shard
        span = Span(trace_id, name, op, t0, dur, os.getpid(), shard, attrs)
        with self._lock:
            if len(self._outbox) == self._outbox.maxlen:
                self.dropped_outbox += 1
            self._ring.append(span)
            self._outbox.append(span)
            self.recorded += 1

    def extend(self, spans) -> None:
        """Fold spans shipped from another process into the ring only
        (never re-shipped — the parent is the terminus)."""
        if not self.capacity or not spans:
            return
        with self._lock:
            self._ring.extend(spans)
            self.recorded += len(spans)

    def drain_outbox(self) -> list[Span]:
        """Take every span recorded since the last drain (workers call
        this when building a reply message)."""
        if not self.capacity:
            return []
        with self._lock:
            out = list(self._outbox)
            self._outbox.clear()
        return out

    def snapshot(self, limit: int | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._ring)
        return spans if limit is None else spans[-limit:]

    def dump(self, reason: str) -> bool:
        """Freeze the most recent spans under ``reason`` (rate-limited)."""
        if not self.capacity:
            return False
        now = monotime()
        with self._lock:
            if now - self._last_dump_t < self.DUMP_INTERVAL_S:
                return False
            self._last_dump_t = now
            spans = list(self._ring)[-self.DUMP_SPANS:]
            self._dumps.append(
                _Dump(reason, now, [s.as_dict() for s in spans]))
        return True

    def as_dict(self, limit: int = 256) -> dict:
        """The ``GET /debug/spans`` body."""
        with self._lock:
            spans = list(self._ring)[-limit:]
            dumps = [{"reason": d.reason, "t": round(d.t, 6),
                      "n_spans": len(d.spans), "spans": d.spans}
                     for d in self._dumps]
        return {"capacity": self.capacity, "recorded": self.recorded,
                "dropped_outbox": self.dropped_outbox,
                "n": len(spans), "spans": [s.as_dict() for s in spans],
                "dumps": dumps}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._outbox.clear()
            self._dumps.clear()
            self.recorded = 0
            self.dropped_outbox = 0
            self._last_dump_t = -1e9


def _default_capacity() -> int:
    try:
        return int(os.environ.get("REPRO_TRACE_RING", "2048"))
    except ValueError:
        return 2048


_recorder = FlightRecorder(_default_capacity())


def recorder() -> FlightRecorder:
    """The process-local flight recorder."""
    return _recorder


def configure(capacity: int) -> FlightRecorder:
    """Replace the process recorder (``0`` disables tracing).  Called by
    servers honoring ``--trace-ring`` and by shard workers at startup."""
    global _recorder
    _recorder = FlightRecorder(capacity)
    return _recorder
