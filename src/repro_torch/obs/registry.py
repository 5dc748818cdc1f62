"""Unified metrics registry for the serve/ingest fleet.

One thread-safe home for the counters, gauges, and latency histograms
that used to live as ad-hoc ``dict`` + ``Lock`` pairs in every module
(`serve/http.py`, `serve/scheduler.py`, `serve/shard.py`,
`query/database.py`, `ingest/server.py`).  Two render paths from the
same instruments:

* the existing JSON ``/metrics`` shapes — :class:`CounterGroup` is a
  real mapping and :class:`Histogram.as_dict` keeps its historical keys,
  so ``dict(group)`` / ``hist.as_dict()`` at the old call sites emit
  byte-identical JSON;
* Prometheus text exposition (``GET /metrics?format=prom``) via
  :meth:`MetricsRegistry.prometheus` / :meth:`MetricsRegistry.render`.

Locking discipline matches the code it replaces: single integer
increments on counters are lock-free under the GIL where the caller
already holds its own lock, and :class:`CounterGroup` carries its own
lock for callers that don't.
"""
from __future__ import annotations

import re
import threading
from collections.abc import MutableMapping

# histogram bucket upper edges in MICROseconds: 100us .. 3s, then +inf.
# (Identical to the scheduler's historical LatencyHistogram edges — the
# /metrics JSON shape depends on them.)
HIST_EDGES_US = (100.0, 300.0, 1e3, 3e3, 1e4, 3e4, 1e5, 3e5, 1e6, 3e6)

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_SANITIZE.sub("_", name)


class Histogram:
    """Bounded latency histogram over fixed microsecond buckets.

    Lock-free under the GIL for single observations (list item increment
    is atomic enough for monitoring); cheap to snapshot.  This is the
    one histogram for the whole stack — ``serve/scheduler.py`` and
    ``serve/http.py`` used to carry their own copy as
    ``LatencyHistogram``, which remains importable as an alias.
    """

    __slots__ = ("counts", "total_s", "n")

    def __init__(self):
        self.counts = [0] * (len(HIST_EDGES_US) + 1)
        self.total_s = 0.0
        self.n = 0

    def observe(self, seconds: float) -> None:
        us = seconds * 1e6
        i = 0
        for edge in HIST_EDGES_US:
            if us < edge:
                break
            i += 1
        self.counts[i] += 1
        self.total_s += seconds
        self.n += 1

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of quantile ``q`` in seconds."""
        if self.n == 0:
            return 0.0
        rank = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return (HIST_EDGES_US[i] if i < len(HIST_EDGES_US)
                        else HIST_EDGES_US[-1] * 10) / 1e6
        return HIST_EDGES_US[-1] * 10 / 1e6

    def as_dict(self) -> dict:
        return {"buckets_us": list(HIST_EDGES_US), "counts": list(self.counts),
                "n": self.n,
                "mean_ms": (self.total_s / self.n * 1e3) if self.n else 0.0,
                "p50_ms_le": self.quantile(0.5) * 1e3,
                "p99_ms_le": self.quantile(0.99) * 1e3}

    def _prom_lines(self, name: str, labels: str = "") -> list[str]:
        """Cumulative-bucket exposition lines (no HELP/TYPE header)."""
        counts = list(self.counts)          # snapshot (GIL-atomic copy)
        lines, cum = [], 0
        for edge, c in zip(HIST_EDGES_US, counts):
            cum += c
            le = repr(edge / 1e6)
            sep = "," if labels else ""
            lines.append(f'{name}_bucket{{{labels}{sep}le="{le}"}} {cum}')
        cum += counts[-1]
        sep = "," if labels else ""
        lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {cum}')
        suffix = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{suffix} {repr(self.total_s)}")
        lines.append(f"{name}_count{suffix} {cum}")
        return lines


class Counter:
    """A monotonically increasing counter with its own lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """A point-in-time value: either set explicitly or computed by ``fn``."""

    __slots__ = ("_fn", "_value")

    def __init__(self, fn=None):
        self._fn = fn
        self._value = 0.0

    def set(self, value) -> None:
        self._value = value

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:   # noqa: BLE001 - a dead backing object reads 0
                return 0.0
        return self._value


class CounterGroup(MutableMapping):
    """A named family of counters that *is* a mapping.

    Drop-in for the fleet's historical ``self.counters = {...}`` dicts:
    ``group[key] += 1``, ``dict(group)``, and ``group[key]`` all behave
    exactly like the dict they replace (so existing ``/metrics`` JSON
    shapes and tests are untouched), while the registry renders each key
    as a Prometheus series.  Keys named in ``gauges`` render as gauges
    (values that can go down, e.g. ``reopen_last_s``); the rest render
    as counters with a ``_total`` suffix.  Carries its own lock for
    callers without one; :meth:`inc` is the locked increment.
    """

    def __init__(self, initial: dict | None = None, gauges=()):
        self._lock = threading.Lock()
        self._data: dict = dict(initial or {})
        self._gauges = frozenset(gauges)

    def inc(self, key, n=1) -> None:
        with self._lock:
            self._data[key] = self._data.get(key, 0) + n

    def set(self, key, value) -> None:
        with self._lock:
            self._data[key] = value

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        self._data[key] = value

    def __delitem__(self, key):
        with self._lock:
            del self._data[key]

    def __iter__(self):
        return iter(dict(self._data))

    def __len__(self):
        return len(self._data)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._data)


class HistogramFamily:
    """Label-keyed histograms (e.g. per-op latency).

    Mapping-shaped where the scheduler used a plain ``dict`` of
    histograms: ``family.setdefault(op, Histogram()).observe(dt)`` and
    ``{k: h.as_dict() for k, h in family.items()}`` both work unchanged.
    """

    def __init__(self, label: str = "op"):
        self.label = label
        self._lock = threading.Lock()
        self._children: dict[str, Histogram] = {}

    def labels(self, key: str) -> Histogram:
        h = self._children.get(key)
        if h is None:
            with self._lock:
                h = self._children.setdefault(key, Histogram())
        return h

    # dict-compatible surface for existing call sites
    def setdefault(self, key, default=None) -> Histogram:
        return self.labels(key)

    def __getitem__(self, key) -> Histogram:
        return self._children[key]

    def __contains__(self, key) -> bool:
        return key in self._children

    def __len__(self) -> int:
        return len(self._children)

    def items(self):
        return list(self._children.items())


class MetricsRegistry:
    """Creates + tracks instruments and renders them all as Prometheus text.

    Instruments are namespaced ``repro_<name>`` in the exposition;
    callers pick dotted or slashed names freely (sanitized to the
    Prometheus charset).  Each module owns its own registry with a
    distinct name prefix (``http.``, ``scheduler.``, ``shard.``,
    ``db.``, ``ingest.``) and the HTTP front concatenates them with
    :meth:`render` — no global singleton to fight over across processes.
    """

    namespace = "repro"

    def __init__(self):
        self._lock = threading.Lock()
        # name -> ("counter"|"gauge"|"hist"|"family"|"group", instrument)
        self._instruments: dict[str, tuple[str, object]] = {}

    def _register(self, name: str, kind: str, instrument):
        with self._lock:
            have = self._instruments.get(name)
            if have is not None:
                if have[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {have[0]}")
                return have[1]
            self._instruments[name] = (kind, instrument)
            return instrument

    def counter(self, name: str) -> Counter:
        return self._register(name, "counter", Counter())

    def gauge(self, name: str, fn=None) -> Gauge:
        return self._register(name, "gauge", Gauge(fn))

    def histogram(self, name: str) -> Histogram:
        return self._register(name, "hist", Histogram())

    def histogram_family(self, name: str, label: str = "op") -> HistogramFamily:
        return self._register(name, "family", HistogramFamily(label))

    def group(self, prefix: str, initial: dict, gauges=()) -> CounterGroup:
        """A :class:`CounterGroup` whose keys render as
        ``repro_<prefix>_<key>[_total]`` series."""
        return self._register(prefix, "group", CounterGroup(initial, gauges))

    # -- exposition ---------------------------------------------------------

    def prometheus(self, labels: str = "") -> str:
        """Render every instrument as Prometheus text exposition 0.0.4.

        ``labels`` (e.g. ``tenant="team-a"``) is merged into every sample
        line — how a multi-tenant front exposes one registry per tenant
        under shared series names.  Repeated same-type ``# TYPE`` lines
        across tenants are valid exposition (and accepted by
        tools/check_prom.py); only *conflicting* redeclarations are not.
        """
        out: list[str] = []
        suffix = f"{{{labels}}}" if labels else ""
        with self._lock:
            items = sorted(self._instruments.items())
        for name, (kind, inst) in items:
            base = f"{self.namespace}_{_prom_name(name)}"
            if kind == "counter":
                out.append(f"# TYPE {base}_total counter")
                out.append(f"{base}_total{suffix} {inst.value}")
            elif kind == "gauge":
                out.append(f"# TYPE {base} gauge")
                out.append(f"{base}{suffix} {_num(inst.value)}")
            elif kind == "hist":
                out.append(f"# TYPE {base}_seconds histogram")
                out.extend(inst._prom_lines(f"{base}_seconds", labels))
            elif kind == "family":
                out.append(f"# TYPE {base}_seconds histogram")
                for key, h in inst.items():
                    label = f'{_prom_name(inst.label)}="{key}"'
                    if labels:
                        label = f"{labels},{label}"
                    out.extend(h._prom_lines(f"{base}_seconds", label))
            elif kind == "group":
                for key, val in sorted(inst.snapshot().items()):
                    series = f"{base}_{_prom_name(str(key))}"
                    if key in inst._gauges:
                        out.append(f"# TYPE {series} gauge")
                        out.append(f"{series}{suffix} {_num(val)}")
                    else:
                        out.append(f"# TYPE {series}_total counter")
                        out.append(f"{series}_total{suffix} {_num(val)}")
        return "\n".join(out) + "\n" if out else ""

    @staticmethod
    def render(registries, labels: str = "") -> str:
        """Concatenate several registries' expositions (``None`` skipped)."""
        return "".join(r.prometheus(labels) for r in registries
                       if r is not None)


def _num(v) -> str:
    """Prometheus sample value: ints stay ints, floats use repr."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    try:
        return repr(float(v))
    except (TypeError, ValueError):
        return "0"
