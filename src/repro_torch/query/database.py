"""Postmortem database handle: one open per store, routed reads, LRU cache.

The paper's sparse formats exist to be *read* (§3): PMS answers
"all metrics of profile p" with one plane read, CMS answers "metric m of
context c across all profiles" with one stripe read.  :class:`Database`
packages both stores (plus the integrated trace file) behind a single
handle:

* the meta-database — unified CCT, summary statistics, metric registry,
  profile identities — is parsed **once** at open; the PMS/CMS data regions
  are ``mmap``-ed so plane reads are slices, not syscalls;
* every query is routed to the cheaper store: profile-major -> a PMS plane,
  context-major -> a CMS context plane, point lookups -> whichever plane is
  smaller (or already cached);
* decoded planes land in a byte-budgeted :class:`~repro_torch.query.cache.LRUCache`
  shared by all query shapes, so repeated and bursty access patterns (the
  interactive-browser workload of §3) hit memory, not disk.

Routing is observable: ``db.counters`` records how many planes each store
served, which is how tests pin down that context-major queries never scan
PMS planes.
"""
from __future__ import annotations

import mmap
import os

import numpy as np

from repro_torch.core.cms import (CMSReader, decode_plane, empty_plane,
                                  stripe_from_buffer, stripe_from_plane)
from repro_torch.core.metrics import INCLUSIVE_BIT, MetricRegistry
from repro_torch.core.pms import PMSReader
from repro_torch.core.sparse import SparseMetrics, Trace
from repro_torch.core.stats import pack_keys
from repro_torch.core.traces import TraceDBReader
from repro_torch.obs import MetricsRegistry
from repro_torch.query.cache import LRUCache

PMS_NAME, CMS_NAME, TRC_NAME = "db.pms", "db.cms", "db.trc"


class Database:
    """Read-only handle over one analysis run's PMS + CMS + trace databases.

    ``Database(db_dir)`` opens ``db.pms`` (required) and ``db.cms`` /
    ``db.trc`` (optional — queries that need a missing store either fall
    back or raise, see each method).  Also accepts an explicit
    ``pms_path=`` when the databases do not share a directory.
    """

    def __init__(self, db_dir=None, *, pms_path=None, cms_path=None,
                 trace_path=None, cache_bytes: int = 64 << 20):
        self.db_dir = None if db_dir is None else str(db_dir)
        if db_dir is not None:
            db_dir = str(db_dir)
            pms_path = pms_path or os.path.join(db_dir, PMS_NAME)
            cand = cms_path or os.path.join(db_dir, CMS_NAME)
            cms_path = cand if os.path.exists(cand) else None
            cand = trace_path or os.path.join(db_dir, TRC_NAME)
            trace_path = cand if os.path.exists(cand) else None
        if pms_path is None:
            raise ValueError("Database needs a db_dir or an explicit pms_path")

        # one open + one meta parse per store, held for the handle's lifetime
        self._pms = PMSReader(pms_path)
        self._pms_mm = mmap.mmap(self._pms._fd, 0, access=mmap.ACCESS_READ)
        self._cms = None
        self._cms_mm = None
        if cms_path is not None:
            self._cms = CMSReader(cms_path)
            self._cms_mm = mmap.mmap(self._cms._fd, 0, access=mmap.ACCESS_READ)
        self._trc = TraceDBReader(trace_path) if trace_path is not None else None

        self.tree = self._pms.tree
        self.stats = self._pms.stats
        self.n_profiles = self._pms.n_profiles
        self.n_contexts = len(self.tree.parent) if self.tree is not None else 0
        reg_json = self._pms.meta.get("registry") or []
        self.registry = MetricRegistry.from_json(reg_json) if reg_json else None
        # summary stats are sorted by packed (ctx << 16 | mid) key (the
        # StatsAccumulator invariant): point lookups are one binary search
        self._stat_keys = (pack_keys(self.stats["ctx"], self.stats["mid"])
                           if self.stats else np.empty(0, np.uint64))

        # snapshot epoch this handle serves, when opened from a versioned
        # snapshot root (open_current / EpochSwitcher); None for plain dirs
        self.epoch: int | None = None

        self.cache = LRUCache(cache_bytes)
        # counters live on an obs registry so the serving layer can render
        # them over Prometheus; CounterGroup keeps the dict surface every
        # caller (tests, benchmarks) already uses, with a lock inside —
        # `+=` on a bare dict slot is not atomic and the serving layer
        # drives one handle from many threads
        self.obs = MetricsRegistry()
        self.counters = self.obs.group(
            "db", {"pms_plane_loads": 0, "cms_plane_loads": 0,
                   "cms_stripe_reads": 0, "cms_stripe_skips": 0,
                   "trace_loads": 0, "pms_scan_fallbacks": 0})
        for name, fn in (("db.cache_hits", lambda: self.cache.hits),
                         ("db.cache_misses", lambda: self.cache.misses),
                         ("db.cache_evictions", lambda: self.cache.evictions),
                         ("db.cache_bytes", lambda: self.cache.nbytes),
                         ("db.cache_capacity_bytes",
                          lambda: self.cache.capacity_bytes)):
            self.obs.gauge(name, fn)

    @classmethod
    def open_current(cls, root, *, cache_bytes: int = 64 << 20) -> "Database":
        """Open the epoch a snapshot root's ``CURRENT`` pointer names.

        One-shot resolution (postmortem reads, tests); a serving process
        that must *track* the pointer uses
        :class:`repro_torch.query.epoch.EpochSwitcher` instead.  Raises
        :class:`~repro_torch.ingest.snapshot.SnapshotGone` when the pointed-at
        epoch directory lost a race with the publisher's GC — re-resolve
        and retry.
        """
        from repro_torch.ingest.snapshot import SnapshotGone, read_current
        cur = read_current(root)
        if cur is None:
            raise FileNotFoundError(f"no CURRENT pointer under {root}")
        epoch, db_dir = cur
        try:
            db = cls(db_dir, cache_bytes=cache_bytes)
        except (FileNotFoundError, OSError) as e:
            raise SnapshotGone(
                f"epoch {epoch} dir vanished under {root}") from e
        db.epoch = epoch
        return db

    def _count(self, key: str) -> None:
        self.counters.inc(key)

    # -- identity / naming ---------------------------------------------------
    @property
    def has_cms(self) -> bool:
        return self._cms is not None

    @property
    def has_traces(self) -> bool:
        return self._trc is not None

    def trace_lengths(self) -> np.ndarray:
        """Per-profile trace sample counts straight from the in-memory toc.

        Zero segment decodes: the toc's second column *is* the sample
        count, so rank-activity shape (who sampled how much) is readable
        at file-open cost — the straggler analyzer's whole input.  Empty
        array when the database carries no trace store.
        """
        if self._trc is None:
            return np.zeros(0, dtype=np.int64)
        return self._trc.toc[:, 1].astype(np.int64)

    def identity(self, pid: int) -> dict | None:
        return self._pms.identity(pid)

    def path_of(self, ctx: int) -> str:
        return self.tree.full_path(int(ctx))

    def resolve_metric(self, metric, *, inclusive: bool = False) -> int:
        """Metric name or id -> concrete mid; ``inclusive`` ORs the bit.

        Names need a registry in the database meta; the ``":I"`` suffix
        selects the propagated inclusive variant (``foo:I`` == ``foo`` with
        ``inclusive=True``).
        """
        if isinstance(metric, str):
            name = metric
            if name.endswith(":I"):
                name, inclusive = name[:-2], True
            if self.registry is None:
                raise ValueError(
                    f"metric {metric!r} given by name but the database has "
                    f"no metric registry; use an integer metric id")
            mid = self.registry[name].mid
        else:
            mid = int(metric)
        return mid | INCLUSIVE_BIT if inclusive else mid

    # -- plane loads (the only code that touches the stores) -----------------
    def profile_metrics(self, pid: int) -> SparseMetrics:
        """All metrics of profile ``pid``: one PMS plane (paper §3.2)."""
        pid = int(pid)

        def load():
            self._count("pms_plane_loads")
            off, nbytes = int(self._pms.index[pid, 0]), int(self._pms.index[pid, 1])
            if nbytes == 0:
                return SparseMetrics.empty(), 64
            sm, _ = SparseMetrics.decode(self._pms_mm[off:off + nbytes])
            return sm, sm.nbytes()

        return self.cache.get_or_load(("pms", pid), load)

    def context_plane(self, ctx: int):
        """Decoded CMS plane for one context: ``(mids, mstart, prof, vals)``."""
        if self._cms is None:
            raise ValueError("database has no CMS store; "
                             "use stripe() which can fall back to a PMS scan")
        ctx = int(ctx)

        def load():
            self._count("cms_plane_loads")
            lo, hi = int(self._cms.offsets[ctx]), int(self._cms.offsets[ctx + 1])
            if lo == hi:
                return empty_plane(), 64
            plane = decode_plane(self._cms_mm[lo:hi])
            return plane, sum(a.nbytes for a in plane)

        return self.cache.get_or_load(("cms", ctx), load)

    def trace(self, pid: int) -> Trace:
        if self._trc is None:
            return Trace.empty()
        pid = int(pid)

        def load():
            self._count("trace_loads")
            tr = self._trc.trace(pid)
            return tr, tr.nbytes()

        return self.cache.get_or_load(("trc", pid), load)

    def _stripe_pushdown(self, ctx: int, mid: int):
        """One stripe decoded straight from the CMS mmap (pushdown read).

        The metric predicate runs against the plane *header* (the
        ``mids``/``mstart`` arrays, tens of bytes), so a context whose plane
        lacks the metric is discarded without materializing it — the cost
        model threshold/call-path selects rely on.  Hits cache only the
        stripe (``("cms-stripe", ctx, mid)``), not the full plane.
        """
        key = ("cms-stripe", ctx, mid)

        def load():
            lo, hi = int(self._cms.offsets[ctx]), int(self._cms.offsets[ctx + 1])
            if lo != hi:
                hit = stripe_from_buffer(self._cms_mm, lo, mid)
                if hit is not None:
                    self._count("cms_stripe_reads")
                    # copy the (small) slices: cached views would pin the
                    # mmap and make close() a BufferError
                    prof, vals = hit[0].copy(), hit[1].copy()
                    return (prof, vals), prof.nbytes + vals.nbytes
            self._count("cms_stripe_skips")
            return (np.empty(0, np.uint32), np.empty(0, np.float64)), 64

        return self.cache.get_or_load(key, load)

    # -- routed queries ------------------------------------------------------
    def stripe(self, ctx: int, metric, *, inclusive: bool = False):
        """Metric ``m`` of context ``c`` across all profiles: one CMS stripe.

        Returns ``(profile_ids, values)``.  A cached full plane is sliced
        for free; otherwise the read is pushed down to the single metric
        (:meth:`_stripe_pushdown`) instead of decoding the whole context
        plane.  Without a CMS store this degrades to the strawman PMS scan
        (counted in ``counters["pms_scan_fallbacks"]``) so PMS-only
        databases stay queryable.
        """
        mid = self.resolve_metric(metric, inclusive=inclusive)
        ctx = int(ctx)
        if self._cms is not None:
            if ("cms", ctx) in self.cache:
                return stripe_from_plane(self.context_plane(ctx), mid)
            return self._stripe_pushdown(ctx, mid)
        self._count("pms_scan_fallbacks")
        pids, vs = [], []
        for pid in range(self.n_profiles):
            v = self.profile_metrics(pid).lookup(int(ctx), mid)
            if v != 0.0:
                pids.append(pid)
                vs.append(v)
        return np.asarray(pids, np.uint32), np.asarray(vs, np.float64)

    def value(self, pid: int, ctx: int, metric, *, inclusive: bool = False) -> float:
        """Point lookup routed to the cheaper store.

        A cached PMS plane always wins (slicing it is free).  Otherwise
        the CMS side pays: since stripe reads push the metric predicate
        down, the miss cost is one plane *header* plus one stripe — always
        bounded above by (and usually far below) decoding the full profile
        plane, so the old decode-the-smaller-plane comparison (paper §3's
        "bytes moved decides") now degenerates to "prefer the stripe".
        PMS-only databases fall back to the profile plane.
        """
        mid = self.resolve_metric(metric, inclusive=inclusive)
        pid, ctx = int(pid), int(ctx)
        if ("pms", pid) in self.cache or self._cms is None:
            return self.profile_metrics(pid).lookup(ctx, mid)
        prof, vals = self.stripe(ctx, mid)
        k = int(np.searchsorted(prof, pid))
        if k < prof.size and prof[k] == pid:
            return float(vals[k])
        return 0.0

    # -- summary statistics (never touch planes) ----------------------------
    def summary(self, ctx: int, metric, stat: str = "sum", *,
                inclusive: bool = False) -> float:
        """Cross-profile summary statistic for one (context, metric).

        Served from the completed database's summary-statistics section
        (paper §4.1.2) — O(log) over the sorted stat keys, zero plane I/O.
        """
        mid = self.resolve_metric(metric, inclusive=inclusive)
        key = pack_keys(np.uint64(ctx), np.uint64(mid))
        k = int(np.searchsorted(self._stat_keys, key))
        if k < self._stat_keys.size and self._stat_keys[k] == key:
            return float(self.stats[stat][k])
        return 0.0

    def metric_entries(self, metric, *, inclusive: bool = False):
        """All summary-stat rows of one metric: ``(ctx_ids, stat_slice_fn)``.

        Returns the context ids carrying this metric and a row-index mask
        into the ``db.stats`` arrays — the building block for threshold
        selects and top-k that never densify.
        """
        mid = self.resolve_metric(metric, inclusive=inclusive)
        mask = self.stats["mid"] == mid
        return self.stats["ctx"][mask], np.flatnonzero(mask)

    # -- lifecycle -----------------------------------------------------------
    def cache_stats(self) -> dict[str, int]:
        return self.cache.stats()

    def close(self) -> None:
        if self._pms_mm is not None:
            self._pms_mm.close()
        if self._cms_mm is not None:
            self._cms_mm.close()
        self._pms.close()
        if self._cms is not None:
            self._cms.close()
        if self._trc is not None:
            self._trc.close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, *a) -> None:
        self.close()
