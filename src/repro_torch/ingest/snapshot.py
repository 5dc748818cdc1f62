"""Versioned database snapshots: epoch directories + atomic ``CURRENT``.

A snapshot root published by the ingest tier looks like::

    root/
      CURRENT                      -> {"epoch": 7, "dir": "epoch-0000000007"}
      epoch-0000000006/            (kept by the retention window)
        db.pms  db.cms  db.trc
        MANIFEST.json
      epoch-0000000007/
        ...

Publication protocol (crash-safe at every step):

1. the database files are written into a hidden staging directory
   (``.tmp-epoch-N``) that no reader ever resolves;
2. ``MANIFEST.json`` (epoch, file list with sizes, schema version) is
   written and fsync'd, then every database file and the staging directory
   itself are fsync'd — after this the snapshot is durably complete;
3. the staging directory is renamed to ``epoch-N`` (atomic on POSIX) and
   the root is fsync'd;
4. ``CURRENT`` is replaced via write-temp + fsync + ``os.rename`` + root
   fsync — readers either see the old pointer or the new one, never a
   partial file.

A crash before step 4 leaves ``CURRENT`` pointing at the previous epoch
and at worst an orphaned staging/epoch directory; the next publication
picks the next free epoch number and :meth:`SnapshotStore.gc` sweeps
stale staging directories.

Retention: :meth:`gc` keeps the newest ``retain`` epochs.  It never
removes the current epoch, and never removes an epoch that a local reader
has pinned (:meth:`pin` — the refcount the query tier holds while a
snapshot serves in-flight batches).  Readers that open an epoch directly
and lose the race with GC get :class:`SnapshotGone` — resolve ``CURRENT``
again and retry.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

CURRENT_NAME = "CURRENT"
MANIFEST_NAME = "MANIFEST.json"
EPOCH_PREFIX = "epoch-"
_STAGE_PREFIX = ".tmp-epoch-"
SCHEMA_VERSION = 1


class SnapshotGone(RuntimeError):
    """The epoch directory a reader resolved no longer exists (GC won the
    race, or ``CURRENT`` points mid-publish at a not-yet-visible epoch).
    Retryable: re-read ``CURRENT`` and open the fresh epoch."""


def epoch_dirname(epoch: int) -> str:
    return f"{EPOCH_PREFIX}{int(epoch):010d}"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_current(root) -> tuple[int, str] | None:
    """Resolve ``root/CURRENT`` -> ``(epoch, absolute_epoch_dir)``;
    ``None`` when nothing has been published yet."""
    path = os.path.join(str(root), CURRENT_NAME)
    try:
        with open(path, "rb") as f:
            obj = json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        return None
    return int(obj["epoch"]), os.path.join(str(root), obj["dir"])


def read_manifest(epoch_dir: str) -> dict:
    try:
        with open(os.path.join(epoch_dir, MANIFEST_NAME), "rb") as f:
            return json.loads(f.read().decode("utf-8"))
    except FileNotFoundError as e:
        raise SnapshotGone(f"no manifest under {epoch_dir}") from e


class SnapshotStore:
    """Owner side of a snapshot root: publish epochs, GC old ones.

    One process owns publication (the ingest server); readers only ever
    resolve ``CURRENT`` and open epoch directories, so they need no store
    object at all (:func:`read_current` /
    :meth:`repro_torch.query.Database.open_current`).
    """

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._pins: dict[int, int] = {}  # epoch -> refcount

    # -- introspection -------------------------------------------------------
    def current(self) -> tuple[int, str] | None:
        return read_current(self.root)

    def epochs(self) -> list[int]:
        """Published epoch numbers on disk, ascending."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith(EPOCH_PREFIX):
                try:
                    out.append(int(name[len(EPOCH_PREFIX):]))
                except ValueError:
                    pass
        return sorted(out)

    def epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.root, epoch_dirname(epoch))

    # -- publication ---------------------------------------------------------
    def publish(self, write_fn, extra_meta: dict | None = None
                ) -> tuple[int, str]:
        """Publish one epoch: ``write_fn(staging_dir)`` writes the database
        files, then the manifest/rename/CURRENT dance makes them visible.
        Returns ``(epoch, epoch_dir)``.  On any failure the staging
        directory is removed and ``CURRENT`` is untouched.
        """
        with self._lock:
            known = self.epochs()
            cur = self.current()
            epoch = max(known + [cur[0] if cur else 0]) + 1
            stage = os.path.join(self.root, f"{_STAGE_PREFIX}{epoch:010d}")
            final = self.epoch_dir(epoch)
            if os.path.exists(stage):
                shutil.rmtree(stage)
            os.makedirs(stage)
            try:
                write_fn(stage)
                files = sorted(f for f in os.listdir(stage)
                               if f != MANIFEST_NAME)
                manifest = {
                    "schema": SCHEMA_VERSION, "epoch": epoch,
                    "files": {f: os.path.getsize(os.path.join(stage, f))
                              for f in files},
                }
                manifest.update(extra_meta or {})
                mpath = os.path.join(stage, MANIFEST_NAME)
                with open(mpath, "w", encoding="utf-8") as f:
                    json.dump(manifest, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                for fname in files:
                    _fsync_path(os.path.join(stage, fname))
                _fsync_path(stage)
            except BaseException:
                shutil.rmtree(stage, ignore_errors=True)
                raise
            os.rename(stage, final)
            _fsync_path(self.root)
            self._write_current(epoch)
            return epoch, final

    def _write_current(self, epoch: int) -> None:
        """Atomic ``CURRENT`` swing; a crash at any point leaves a valid
        (old or new) pointer because ``os.rename`` replaces atomically."""
        tmp = os.path.join(self.root, CURRENT_NAME + ".tmp")
        blob = json.dumps({"epoch": int(epoch),
                           "dir": epoch_dirname(epoch)}).encode("utf-8")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.root, CURRENT_NAME))
        _fsync_path(self.root)

    # -- pinning (local readers) ---------------------------------------------
    def pin(self, epoch: int) -> "_Pin":
        """Hold ``epoch`` against GC while a reader serves from it."""
        with self._lock:
            self._pins[int(epoch)] = self._pins.get(int(epoch), 0) + 1
        return _Pin(self, int(epoch))

    def _unpin(self, epoch: int) -> None:
        with self._lock:
            left = self._pins.get(epoch, 0) - 1
            if left > 0:
                self._pins[epoch] = left
            else:
                self._pins.pop(epoch, None)

    def pinned_epochs(self) -> set[int]:
        with self._lock:
            return set(self._pins)

    # -- retention -----------------------------------------------------------
    def gc(self, retain: int = 2) -> list[int]:
        """Remove epochs older than the newest ``retain``; returns the
        epochs removed.  The current epoch and pinned epochs always
        survive, as do stale staging directories younger than the lock
        (they are swept too, they just don't count against retention).
        """
        retain = max(1, int(retain))
        removed: list[int] = []
        with self._lock:
            cur = self.current()
            keep = set(self.epochs()[-retain:])
            if cur is not None:
                keep.add(cur[0])
            keep |= set(self._pins)
            for epoch in self.epochs():
                if epoch not in keep:
                    shutil.rmtree(self.epoch_dir(epoch), ignore_errors=True)
                    removed.append(epoch)
            # orphaned staging dirs from crashed publications
            for name in os.listdir(self.root):
                if name.startswith(_STAGE_PREFIX):
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)
        return removed


class _Pin:
    """Context-manager handle for one :meth:`SnapshotStore.pin`."""

    def __init__(self, store: SnapshotStore, epoch: int):
        self._store = store
        self.epoch = epoch
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._unpin(self.epoch)

    def __enter__(self) -> "_Pin":
        return self

    def __exit__(self, *a) -> None:
        self.release()
