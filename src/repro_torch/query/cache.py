"""Byte-budgeted LRU cache for decoded planes and stripes.

The query engine's unit of I/O is a *plane* (one PMS profile plane or one
CMS context plane).  Decoding a plane costs far more than slicing it, so the
:class:`Database` caches decoded planes keyed by ``(store, id)`` and serves
point/stripe queries out of the cached object.

Two properties matter for the serving path (``repro_torch.serve``):

* the cache is thread-safe, so one :class:`~repro_torch.query.Database` can back
  many concurrent requests;
* concurrent misses on the *same* key are coalesced: one loader runs, the
  rest wait for its result — this is the "cache does the batching" behavior
  the serve engine relies on when a burst of requests hits one hot context.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable


class LRUCache:
    """LRU keyed cache bounded by an approximate byte budget.

    ``put`` evicts least-recently-used entries until the budget holds; a
    single value larger than the whole budget is still admitted (and evicted
    by the next insert) so oversized planes degrade to pass-through instead
    of erroring.
    """

    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: OrderedDict[object, tuple[object, int]] = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self._inflight: dict[object, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- plain dict-ish surface ---------------------------------------------
    def get(self, key, default=None):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return default
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def put(self, key, value, nbytes: int) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, int(nbytes))
            self._bytes += int(nbytes)
            while self._bytes > self.capacity_bytes and len(self._entries) > 1:
                _, (_, sz) = self._entries.popitem(last=False)
                self._bytes -= sz
                self.evictions += 1

    # -- coalescing loader --------------------------------------------------
    def get_or_load(self, key, loader: Callable[[], tuple[object, int]]):
        """Return the cached value for ``key``, loading it at most once.

        ``loader() -> (value, nbytes)`` runs outside the cache lock.  When
        several threads miss the same key simultaneously, one runs the
        loader and the others block on its completion, then re-read the
        cache — a burst of identical queries costs one plane decode.
        """
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return entry[0]
                waiter = self._inflight.get(key)
                if waiter is None:
                    self._inflight[key] = threading.Event()
                    self.misses += 1
                    break
            waiter.wait()
        try:
            value, nbytes = loader()
            self.put(key, value, nbytes)
            return value
        finally:
            with self._lock:
                self._inflight.pop(key).set()

    # -- observability ------------------------------------------------------
    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "entries": len(self._entries),
                    "bytes": self._bytes}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
