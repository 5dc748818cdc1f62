"""Per-tenant serving backends for the multi-tenant HTTP front.

One :class:`TenantBackend` is the execution stack the single-tenant
``QueryHTTPServer`` always assembled — engine (in-process or sharded),
batch scheduler, optional epoch switcher, warm plan — minus the HTTP
transport.  A multi-tenant front holds one backend per named database
behind one listener, so:

* **admission is isolated**: each tenant gets its own
  :class:`~repro_torch.serve.scheduler.BatchScheduler` with its own queue
  budget — one tenant saturating its budget is 429'd while its
  neighbors' queues stay empty;
* **epoch following is per tenant**: each backend polls its own
  snapshot root, so teams publish on independent cadences;
* **metrics stay attributable**: every backend's registries render with
  a ``tenant="name"`` label in the merged Prometheus exposition.
"""
from __future__ import annotations

import re

from repro_torch.obs import MetricsRegistry, monotime
from repro_torch.query.database import Database
from repro_torch.query.epoch import EpochSwitcher, wait_for_epoch
from repro_torch.serve.engine import QueryServer
from repro_torch.serve.scheduler import BatchScheduler
from repro_torch.serve.shard import ShardedQueryServer
from repro_torch.serve.warm import warm_cache

_TENANT_NAME_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")


def valid_tenant_name(name) -> bool:
    return isinstance(name, str) and bool(_TENANT_NAME_RE.match(name))


def parse_tenant_arg(spec: str) -> tuple[str, str, int | None]:
    """Parse one ``--tenant`` CLI value: ``name=path[,queue=N]``.

    Returns ``(name, path, max_queue_or_None)``.
    """
    head, _, tail = spec.partition(",")
    name, sep, path = head.partition("=")
    if not sep or not path:
        raise ValueError(f"--tenant needs name=path, got {spec!r}")
    if not valid_tenant_name(name):
        raise ValueError(f"invalid tenant name {name!r} "
                         f"(alnum, dot, dash, underscore; max 64)")
    queue = None
    if tail:
        k, _, v = tail.partition("=")
        if k.strip() != "queue":
            raise ValueError(f"unknown --tenant option {k!r}; known: queue")
        queue = int(v)
    return name, path, queue


class TenantBackend:
    """One tenant's execution stack behind a shared HTTP front."""

    def __init__(self, name: str, db, *, follow: bool = False,
                 follow_wait_s: float = 60.0,
                 follow_cache_bytes: int = 64 << 20,
                 batching: bool = True, max_batch: int = 16,
                 max_wait_ms: float = 0.0, max_queue: int = 256,
                 executor: str = "threads", n_workers: int = 4,
                 default_timeout_s: float = 30.0,
                 adaptive_wait: bool = True, warm_bytes: int | None = 0,
                 shards: int = 0, shard_cache_bytes: int | None = None,
                 shard_slab_bytes: int = 4 << 20, shard_slabs: int = 8,
                 replicas: int = 2, shard_transport: str = "shm",
                 hedge_ms: float | None = None):
        if not valid_tenant_name(name):
            raise ValueError(f"invalid tenant name {name!r}")
        self.name = name
        self.switcher: EpochSwitcher | None = None
        if follow:
            # ``db`` is the tenant's snapshot ROOT; open whatever CURRENT
            # points at and track it
            root = str(db)
            wait_for_epoch(root, timeout_s=follow_wait_s)
            self.switcher = EpochSwitcher(root,
                                          cache_bytes=follow_cache_bytes)
            self._db = None
        elif isinstance(db, (str, bytes)) or hasattr(db, "__fspath__"):
            raise TypeError(f"tenant {name!r}: pass an open Database (or "
                            f"follow=True with a snapshot root)")
        else:
            self._db = db
        db = self.db
        self.shards = max(0, int(shards))
        self.sharded: ShardedQueryServer | None = None
        if self.shards:
            self.sharded = ShardedQueryServer(
                db.db_dir, self.shards,
                cache_bytes=shard_cache_bytes or db.cache.capacity_bytes,
                warm_bytes=warm_bytes, n_slabs=shard_slabs,
                slab_bytes=shard_slab_bytes, replicas=replicas,
                transport=shard_transport, hedge_ms=hedge_ms)
            self.engine = self.sharded
        else:
            self.engine = QueryServer(db)
        self.batching = bool(batching)
        self.scheduler = BatchScheduler(
            self.engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=max_queue, executor=executor, n_workers=n_workers,
            default_timeout_s=default_timeout_s,
            adaptive_wait=adaptive_wait,
            tenant=name) if self.batching else None
        self._warm_bytes = warm_bytes
        self.warm_report: dict | None = None
        self.follow_errors = 0
        self.obs = MetricsRegistry()
        self.reopen_hist = self.obs.histogram("http.epoch_reopen")

    @property
    def db(self) -> Database:
        """The database answering *new* requests right now."""
        if self.switcher is not None:
            return self.switcher.db
        return self._db

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self.sharded is not None:
            self.sharded.start()
            self.warm_report = {"sharded": self.sharded.warm_reports()}
        elif self._warm_bytes is None or self._warm_bytes > 0:
            self.warm_report = warm_cache(self.db, self._warm_bytes or None)
        if self.scheduler is not None:
            self.scheduler.start()

    def stop(self) -> None:
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.sharded is not None:
            self.sharded.close()
        if self.switcher is not None:
            self.switcher.close()

    # -- epoch following ------------------------------------------------------
    def poll_follow(self) -> None:
        """One follow tick: swing to a newly published epoch if any.
        Called from the front's single follower thread for every tenant."""
        if self.switcher is None:
            return
        try:
            if not self.switcher.poll():
                return
            t0 = monotime()
            if self.sharded is not None:
                # all workers swing together; the window lock inside
                # reopen() keeps every dispatch single-epoch
                self.sharded.reopen(self.switcher.db.db_dir)
            else:
                # in-process: future batches default to the new epoch;
                # in-flight ones hold pins on the old handle
                self.engine.db = self.switcher.db
            self.reopen_hist.observe(monotime() - t0)
        except Exception:                                   # noqa: BLE001
            # a torn transition (e.g. SnapshotGone racing GC) is retried
            # on the next poll; keep serving the old epoch
            self.follow_errors += 1

    # -- reporting ------------------------------------------------------------
    def health_fragment(self) -> dict:
        out = {"profiles": self.db.n_profiles,
               "contexts": self.db.n_contexts,
               "shards": self.shards, "batching": self.batching}
        if self.switcher is not None:
            out["epoch"] = self.switcher.epoch
        return out

    def metrics_fragment(self) -> dict:
        out = {"cache": self.db.cache_stats(),
               "db_counters": dict(self.db.counters),
               "warm": self.warm_report,
               "scheduler": (self.scheduler.metrics()
                             if self.scheduler is not None else None),
               "shards": (self.sharded.metrics()
                          if self.sharded is not None else None)}
        if self.switcher is not None:
            out["epoch"] = {"current": self.switcher.epoch,
                            "transitions": self.switcher.transitions,
                            "follow_errors": self.follow_errors,
                            "reopen": self.reopen_hist.as_dict()}
        return out

    def registries(self) -> list:
        """Every registry this tenant contributes to the merged scrape."""
        return [self.obs, getattr(self.db, "obs", None),
                self.scheduler.obs if self.scheduler is not None else None,
                self.sharded.obs if self.sharded is not None else None]
