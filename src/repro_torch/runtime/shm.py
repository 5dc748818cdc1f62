"""Shared-memory slab transport for the ``processes`` backend.

The legacy plane path pickles every encoded plane through the pool's result
pipe: serialize in the worker, copy through a socket, deserialize in the
parent — three copies plus syscalls per plane.  This module replaces that
with a parent-owned arena of fixed-size shared-memory *slabs*:

* the parent creates ``n_slabs`` segments up front and assigns a free slab
  to each task **at submission time, in index order**;
* the worker writes the encoded plane (and trace/statistics sections)
  straight into the slab — ``SparseMetrics.encode_into`` serializes into
  the mapping, so the only copy left is the final write-buffer append in
  the parent — and ships a tiny ``(slab, lengths)`` descriptor back;
* the parent consumes planes in profile order and *recycles* the slab.

Because slabs are assigned in index order and only recycled on in-order
consumption, slab exhaustion throttles submission: at most ``n_slabs``
profiles are in flight (worker-resident or buffered out-of-order), and the
next-expected profile always already owns a slab — so the ordered sink can
run a bounded window with no self-deadlock (the ROADMAP known limit on the
sharded path).  Planes larger than a slab fall back to a dedicated one-shot
segment created by the worker and unlinked by the parent after use.

``attach`` avoids resource-tracker re-registration where the runtime
supports it (``track=False``, 3.13+).  On older runtimes the attach-side
``register`` is a harmless set-dedupe: workers share the parent's tracker
process (the fd is inherited on both fork and spawn starts), so the name
stays registered exactly until the creator unlinks it.

Every segment is named ``rtorch_<parent pid>_<random>``: arena slabs by
the parent, one-shot segments by workers, which get the parent's prefix
through the pool initializer.  A leak check lists ``/dev/shm`` for one
run's prefix and sees no other process's segments.
"""
from __future__ import annotations

import os
import secrets
from multiprocessing import shared_memory

import numpy as np

_ALIGN = 8


def attach(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment (the creator owns unlinking; see the
    module docstring on tracker accounting)."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)  # 3.13+
    except TypeError:
        return shared_memory.SharedMemory(name=name)


def segment_prefix() -> str:
    """The name prefix of the segments a run whose parent is this process
    creates: the port's own, then this process's pid."""
    return f"rtorch_{os.getpid()}_"


def create_segment(size: int, prefix: str) -> shared_memory.SharedMemory:
    """A new segment named under the run's ``prefix``: an arena slab, or a
    dedicated one-shot segment (oversize-plane fallback)."""
    while True:
        try:
            return shared_memory.SharedMemory(
                name=prefix + secrets.token_hex(4), create=True,
                size=max(int(size), 1))
        except FileExistsError:  # a name drawn twice: draw again
            continue


def destroy_segment(seg: shared_memory.SharedMemory) -> None:
    """Close + unlink a segment through *any* handle, keeping the resource
    tracker consistent.

    One-shot segments are created by a worker but unlinked by the parent's
    attach handle.  On 3.13+ that handle is untracked (``track=False``), so
    its ``unlink`` skips ``resource_tracker.unregister`` — but the worker's
    *create* did register with the shared tracker, which would report the
    segment as leaked at shutdown.  Unregister explicitly in that case; on
    older runtimes ``unlink`` already unregisters, and doing it twice would
    make the tracker log spurious KeyErrors.
    """
    seg.close()
    try:
        seg.unlink()
    except FileNotFoundError:
        pass
    if getattr(seg, "_track", True) is False:
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(
                getattr(seg, "_name", "/" + seg.name), "shared_memory")
        except Exception:
            pass


def sections_layout(lengths) -> tuple[list[int], int]:
    """8-byte-aligned section offsets for a slab payload.

    Writer (worker) and reader (parent) both derive offsets from the same
    section lengths, so only the lengths travel in the descriptor.
    Alignment keeps ``np.frombuffer`` views on every section aligned.
    """
    offs = []
    off = 0
    for ln in lengths:
        offs.append(off)
        off += -(-int(ln) // _ALIGN) * _ALIGN
    return offs, off


def write_section(buf, off: int, arr: np.ndarray) -> None:
    """Copy one array into the slab at ``off`` (dtype preserved)."""
    if arr.size:
        dst = np.frombuffer(buf, dtype=arr.dtype, count=arr.size, offset=off)
        dst[:] = arr


def read_section(buf, off: int, dtype, count: int, *, copy: bool = False):
    """View (or copy) one section; copy when the array must outlive the
    slab's recycling — e.g. statistics arrays held by the stats reducer."""
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
    return arr.copy() if copy else arr


class SlabArena:
    """Parent-owned pool of equal-size shared-memory slabs.

    Single-threaded by design: ``acquire``/``release`` are called only from
    the parent's feed/consume loop, whose submission credits guarantee a
    free slab exists whenever a task is pulled — an empty free list at
    ``acquire`` is therefore a logic error, not a wait condition.
    """

    def __init__(self, n_slabs: int, slab_bytes: int):
        self.slab_bytes = int(slab_bytes)
        self.prefix = segment_prefix()
        self._slabs: dict[str, shared_memory.SharedMemory] = {}
        self._free: list[str] = []
        try:
            for _ in range(max(int(n_slabs), 1)):
                seg = create_segment(self.slab_bytes, self.prefix)
                self._slabs[seg.name] = seg
                self._free.append(seg.name)
        except BaseException:
            self.close()
            raise

    @property
    def n_slabs(self) -> int:
        return len(self._slabs)

    def acquire(self) -> str:
        if not self._free:
            raise RuntimeError(
                "SlabArena exhausted: submission ran ahead of consumption "
                "(credits must bound in-flight tasks by n_slabs)")
        return self._free.pop()

    def release(self, name: str) -> None:
        assert name in self._slabs, f"unknown slab {name!r}"
        self._free.append(name)

    def view(self, name: str) -> memoryview:
        return self._slabs[name].buf

    def close(self) -> None:
        """Unlink every slab; idempotent."""
        for seg in self._slabs.values():
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass
        self._slabs = {}
        self._free = []


# -- worker side -------------------------------------------------------------

_WORKER_SLABS: dict[str, shared_memory.SharedMemory] = {}


def worker_slab(name: str) -> shared_memory.SharedMemory:
    """Attach (once per worker per slab) and cache: slabs are recycled
    across tasks, so re-attaching per task would waste an mmap each time."""
    seg = _WORKER_SLABS.get(name)
    if seg is None:
        seg = attach(name)
        _WORKER_SLABS[name] = seg
    return seg
