"""Epoch-aware database handles for live snapshot roots.

The ingest tier publishes versioned snapshots (``epoch-N`` directories
behind an atomic ``CURRENT`` pointer — :mod:`repro_torch.ingest.snapshot`); the
query tier follows them **without restart**.  Two pieces:

* :class:`_EpochHandle` — a refcounted wrapper around one open
  :class:`~repro_torch.query.database.Database`.  The serving layer *pins* a
  handle for every in-flight batch (scheduler ``submit_many(pin=...)``),
  so a mid-batch epoch switch can retire the old database but its file
  handles stay open until the last pinned batch resolves — no reply ever
  mixes epochs, and no reader ever hits a closed mmap.
* :class:`EpochSwitcher` — owns the current handle; :meth:`poll` re-reads
  ``CURRENT`` and atomically swings to the new epoch, retiring (not
  closing) the old one.  Losing the race with the publisher's GC raises
  :class:`~repro_torch.ingest.snapshot.SnapshotGone` after one retry against a
  freshly-read pointer.
"""
from __future__ import annotations

import threading
import time

from repro_torch.query.database import Database


class _EpochHandle:
    """Refcounted open database for one epoch.

    Born with one base reference owned by the switcher; every pinned batch
    adds one.  ``retire()`` drops the base reference when a newer epoch
    takes over; the underlying database closes when the last pin releases.
    """

    def __init__(self, db: Database, epoch: int, db_dir: str):
        self.db = db
        self.epoch = int(epoch)
        self.db_dir = str(db_dir)
        self._lock = threading.Lock()
        self._refs = 1
        self._retired = False

    def retain(self) -> "_EpochHandle":
        with self._lock:
            assert self._refs > 0, "retain() after the handle closed"
            self._refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            close = self._refs == 0
        if close:
            self.db.close()

    def retire(self) -> None:
        """Drop the switcher's base reference (idempotent)."""
        with self._lock:
            if self._retired:
                return
            self._retired = True
        self.release()

    @property
    def refs(self) -> int:
        with self._lock:
            return self._refs


def _read_current(root):
    from repro_torch.ingest.snapshot import read_current
    return read_current(root)


def wait_for_epoch(root, *, timeout_s: float = 60.0, poll_s: float = 0.05,
                   min_epoch: int = 1) -> int:
    """Block until ``root/CURRENT`` points at epoch >= ``min_epoch``;
    returns that epoch.  The bringup helper for serve-before-ingest races
    (a follower can start before the first snapshot publishes)."""
    deadline = time.monotonic() + float(timeout_s)
    while True:
        cur = _read_current(root)
        if cur is not None and cur[0] >= int(min_epoch):
            return cur[0]
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no snapshot epoch >= {min_epoch} under {root} within "
                f"{timeout_s:.0f}s (is the ingest server publishing?)")
        time.sleep(poll_s)


class EpochSwitcher:
    """Follow a snapshot root's ``CURRENT`` pointer across epochs.

    One instance per serving process.  :meth:`poll` is cheap (one small
    file read) and safe to call from a timer thread; :meth:`acquire`
    returns a retained handle the caller must :meth:`~_EpochHandle.release`.
    """

    def __init__(self, root, *, cache_bytes: int = 64 << 20):
        self.root = str(root)
        self.cache_bytes = int(cache_bytes)
        self._lock = threading.Lock()
        self._handle: _EpochHandle | None = None
        self.transitions = 0
        self.poll()
        if self._handle is None:
            raise FileNotFoundError(
                f"no CURRENT pointer under {self.root}; publish a snapshot "
                f"first or use wait_for_epoch()")

    # -- current state --------------------------------------------------------
    @property
    def epoch(self) -> int | None:
        with self._lock:
            return self._handle.epoch if self._handle is not None else None

    @property
    def db(self) -> Database:
        """Unretained peek at the current database (health/metrics use);
        pin with :meth:`acquire` before serving from it."""
        with self._lock:
            assert self._handle is not None
            return self._handle.db

    def acquire(self) -> _EpochHandle:
        with self._lock:
            assert self._handle is not None, "switcher is closed"
            return self._handle.retain()

    # -- the switch -----------------------------------------------------------
    def _open(self, epoch: int, db_dir: str) -> _EpochHandle:
        from repro_torch.ingest.snapshot import SnapshotGone
        try:
            db = Database(db_dir, cache_bytes=self.cache_bytes)
        except (FileNotFoundError, OSError) as e:
            raise SnapshotGone(f"epoch {epoch} dir vanished: {db_dir}") from e
        db.epoch = int(epoch)
        return _EpochHandle(db, epoch, db_dir)

    def poll(self) -> bool:
        """Re-read ``CURRENT``; switch if it moved.  Returns True on a
        transition.  An open that loses the race with GC retries once
        against a freshly-read pointer before raising ``SnapshotGone``."""
        from repro_torch.ingest.snapshot import SnapshotGone
        cur = _read_current(self.root)
        if cur is None:
            return False
        epoch, db_dir = cur
        with self._lock:
            if self._handle is not None and epoch == self._handle.epoch:
                return False
        try:
            handle = self._open(epoch, db_dir)
        except SnapshotGone:
            cur = _read_current(self.root)
            if cur is None or cur[0] == epoch:
                raise
            handle = self._open(*cur)
        with self._lock:
            old, self._handle = self._handle, handle
            self.transitions += 1
        if old is not None:
            old.retire()
        return True

    def close(self) -> None:
        with self._lock:
            old, self._handle = self._handle, None
        if old is not None:
            old.retire()
