"""Trace timeline queries against the integrated trace database.

The trace store (paper §4, footnote 2) holds one (timestamp, context)
sample segment per profile.  Timestamps within a segment are
non-decreasing (the measurement subsystem appends in time order), so a
time window is two binary searches; per-context occupancy over a window is
a segmented count — no window ever materializes samples outside itself.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sparse import Trace
from repro_torch.query.database import Database


def samples_in_window(db: Database, pid: int, t0: float, t1: float) -> Trace:
    """Samples of profile ``pid`` with ``t0 <= time < t1``; O(log n) + slice."""
    tr = db.trace(pid)
    lo, hi = np.searchsorted(tr.time, [t0, t1])
    return Trace(tr.time[lo:hi], tr.ctx[lo:hi])


def occupancy(db: Database, t0: float, t1: float, *,
              pids=None) -> tuple[np.ndarray, np.ndarray]:
    """Per-context sample counts inside a window, across profiles.

    Returns ``(ctx_ids, counts)`` sorted by context id.  ``pids`` restricts
    to a subset of profiles (default: all).  Counts approximate per-context
    occupancy under uniform sampling — context c's share of samples is its
    share of wall time.
    """
    pids = range(db.n_profiles) if pids is None else pids
    chunks = []
    for pid in pids:
        win = samples_in_window(db, int(pid), t0, t1)
        if win.ctx.size:
            chunks.append(win.ctx.astype(np.int64))
    if not chunks:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    ctx = np.concatenate(chunks)
    uniq, counts = np.unique(ctx, return_counts=True)
    return uniq, counts


def activity(db: Database, pid: int, t0: float, t1: float,
             n_bins: int = 50) -> np.ndarray:
    """Sample counts of one profile over ``n_bins`` equal time slices —
    the rendering primitive for a trace-view row."""
    win = samples_in_window(db, pid, t0, t1)
    if t1 <= t0:
        return np.zeros(n_bins, np.int64)
    bins = np.clip(((win.time - t0) * n_bins / (t1 - t0)).astype(np.int64),
                   0, n_bins - 1)
    return np.bincount(bins, minlength=n_bins).astype(np.int64)
