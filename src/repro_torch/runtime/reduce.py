"""Reduction-tree machinery shared by thread, process, and rank engines.

The paper composes parallelism with two-phase reduction trees (§4.4):
phase 1 merges per-worker CCTs, phase 2 merges per-worker statistic
accumulators.  This module holds the generic tree reducer, the streaming
statistics reducers, and the CCT-with-remaps merge payload, so
``repro_torch.core.aggregate`` (executor backends) and
``repro_torch.core.reduction`` (the multi-rank driver) share one
implementation instead of each holding a global uniquing lock.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from repro_torch.core.cct import ContextTree


def tree_reduce(items: list, merge, branching: int):
    """Reduce ``items`` with a branching-factor-``branching`` tree.

    ``merge(a, b) -> a`` combines in place.  Returns ``(result, rounds)``;
    rounds == ceil(log_branching(n)) as in the paper's footnote 6.  The
    reduction shape is a pure function of ``(len(items), branching)``, so
    for a fixed item order the result is deterministic — which is what lets
    floating-point statistic merges stay byte-identical across executors.
    """
    assert branching >= 2
    layer = list(items)
    rounds = 0
    while len(layer) > 1:
        nxt = []
        for i in range(0, len(layer), branching):
            head = layer[i]
            for other in layer[i + 1 : i + branching]:
                head = merge(head, other)
            nxt.append(head)
        layer = nxt
        rounds += 1
    return (layer[0] if layer else None), rounds


class StreamingReducer:
    """Deterministic streaming fold with O(log n) items resident.

    A binary-counter carry chain: pushing items 0..n-1 in order merges
    completed sibling pairs immediately, so at most ``log2(n) + 1`` partial
    reductions are live at any time — the streaming replacement for
    materializing all n items and calling :func:`tree_reduce`.  The merge
    shape (and therefore any floating-point op order) is a pure function of
    ``n`` alone, which is the property the executor byte-parity contract
    needs.  ``merge(a, b) -> a`` combines in place with ``a`` the
    earlier-index operand.
    """

    def __init__(self, merge):
        self._merge = merge
        self._slots: list = []  # slot k: a reduction of 2^k items, or None

    def push(self, item) -> None:
        k = 0
        while k < len(self._slots) and self._slots[k] is not None:
            item = self._merge(self._slots[k], item)  # earlier block on the left
            self._slots[k] = None
            k += 1
        if k == len(self._slots):
            self._slots.append(item)
        else:
            self._slots[k] = item

    def result(self):
        """Fold the remaining slots (highest weight = earliest indices first);
        returns None when nothing was pushed."""
        acc = None
        for slot in reversed(self._slots):
            if slot is None:
                continue
            acc = slot if acc is None else self._merge(acc, slot)
        return acc

    def close(self) -> None:
        """No-op; symmetry with :class:`AsyncStreamingReducer` so engines
        can treat either uniformly on abort paths."""


class AsyncStreamingReducer:
    """:class:`StreamingReducer` with the merges executed on a small thread
    pool — same binary-counter carry chain, same shape, same left/right
    operand order, therefore **byte-identical results**; only *where* each
    merge runs changes.

    This unclogs the known sharded phase-2 bottleneck (ROADMAP item 3): the
    parent's consume thread used to execute every statistics merge inline
    between slab recycles, serializing O(n log n) merge work behind the
    writer.  Here :meth:`push` only links futures (O(log n) bookkeeping)
    and returns; pool threads do the merges, overlapping worker compute and
    writer IO.  numpy releases the GIL inside the sort/reduceat kernels, so
    the overlap is real even in-process.

    Deadlock-freedom for any pool size >= 1: leaves arrive pre-resolved and
    every merge depends only on futures submitted strictly earlier, so FIFO
    pool order always finds runnable work.  A merge that raises parks the
    exception in its future; dependents re-raise it, and :meth:`result`
    surfaces the original error.
    """

    def __init__(self, merge, n_threads: int = 2):
        self._merge = merge
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(n_threads)),
                                        thread_name_prefix="carry-merge")
        self._slots: list[Future | None] = []
        self._closed = False

    def push(self, item) -> None:
        fut: Future = Future()
        fut.set_result(item)
        k = 0
        while k < len(self._slots) and self._slots[k] is not None:
            left = self._slots[k]
            fut = self._pool.submit(
                lambda a=left, b=fut: self._merge(a.result(), b.result()))
            self._slots[k] = None
            k += 1
        if k == len(self._slots):
            self._slots.append(fut)
        else:
            self._slots[k] = fut

    def result(self):
        """Drain the chain: fold remaining slots exactly like
        :meth:`StreamingReducer.result`, then release the pool."""
        try:
            acc = None
            for slot in reversed(self._slots):
                if slot is None:
                    continue
                item = slot.result()
                acc = item if acc is None else self._merge(acc, item)
            return acc
        finally:
            self.close()

    def close(self) -> None:
        """Release pool threads; in-flight merges finish on their own (pure
        compute, no external resources), we just stop waiting for them —
        the abort-path teardown must never hang on statistics."""
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=False)


@dataclass
class TreeWithMaps:
    """A CCT plus, per contributing shard/rank, the remap of its local ids."""

    tree: ContextTree
    maps: dict[int, np.ndarray]


def merge_tree_with_maps(a: TreeWithMaps, b: TreeWithMaps) -> TreeWithMaps:
    """Phase-1 merge payload: unify ``b`` into ``a``, composing id remaps."""
    remap = a.tree.merge(b.tree)
    for key, m in b.maps.items():
        a.maps[key] = remap[m]
    return a
