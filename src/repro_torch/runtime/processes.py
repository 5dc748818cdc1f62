"""Multiprocessing backend: profile-shard workers, the single-node MPI analog.

Workers live in separate address spaces, so ``in_process`` is False and
engines must route work through :meth:`map_unordered` /
:meth:`map_throttled` with module-level (picklable) functions; shared state
goes through the pool ``initializer`` (shipped once per worker, not once
per task).

Built on :class:`concurrent.futures.ProcessPoolExecutor` rather than
``multiprocessing.Pool``: a worker that dies abruptly (OOM-kill, segfault,
``SIGKILL`` mid-slab) breaks the pool and every pending future raises
``BrokenProcessPool`` — ``Pool.imap_unordered`` would silently respawn the
worker and hang forever waiting for the lost result.  Ordinary task
exceptions still propagate as themselves (the crash-propagation contract
tested in tests/test_torch_processes.py).

Start method: fork by default on Linux, ``REPRO_MP_CONTEXT`` when set, an
explicit ``mp_context`` over both.  Engines whose workers run the CUDA
kernels pass ``spawn`` (:func:`repro_torch.runtime.base.executor_for`): a
forked child cannot use CUDA once its parent has.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
from concurrent.futures import (FIRST_COMPLETED, ProcessPoolExecutor,
                                as_completed, wait)
from functools import partial
from typing import Callable, Iterable, Iterator

from repro_torch.runtime.base import Executor, register_executor


_INIT_FAILURE: BaseException | None = None


def _guarded_initializer(initializer: Callable, initargs: tuple) -> None:
    """Capture initializer errors instead of letting the worker die.

    A worker dying during init breaks the whole pool with a generic
    ``BrokenProcessPool``.  Stashing the exception and re-raising it at the
    first task routes the *original* failure through the normal result
    path, where it surfaces with its own type and message."""
    global _INIT_FAILURE
    try:
        initializer(*initargs)
    except BaseException as e:
        _INIT_FAILURE = e


def _call_indexed(fn: Callable, i: int, task) -> tuple[int, object]:
    if _INIT_FAILURE is not None:
        raise _INIT_FAILURE
    return i, fn(task)


@register_executor
class ProcessesExecutor(Executor):
    name = "processes"
    in_process = False

    def __init__(self, n_workers: int = 1, mp_context: str | None = None):
        super().__init__(n_workers)
        if mp_context is None:
            mp_context = os.environ.get("REPRO_MP_CONTEXT") or None
        if mp_context is None:
            # Linux: fork — forkserver/spawn re-import __main__, which hangs
            # the pool in a respawn loop for stdin/interactive programs (no
            # importable main) and re-runs unguarded scripts.  The cost is
            # the classic fork-from-a-threaded-parent hazard (a worker can
            # inherit a mutex locked by e.g. a torch thread pool); parents
            # that are thread-heavy can opt out via
            # REPRO_MP_CONTEXT=forkserver.
            # Elsewhere: spawn — macOS fork is unsafe with system frameworks
            # (ObjC/Accelerate state), which is why CPython itself switched
            # the macOS default.  Worker fns and initargs are module-level/
            # picklable, so every start method works.
            methods = mp.get_all_start_methods()
            mp_context = ("fork" if sys.platform == "linux"
                          and "fork" in methods else "spawn")
        self._ctx = mp.get_context(mp_context)

    def parallel_for(self, n_items: int, body: Callable[[int], None]) -> None:
        raise NotImplementedError(
            "the processes executor cannot run closures over shared state; "
            "use map_unordered with a module-level function")

    def _pool(self, n: int, initializer: Callable | None,
              initargs: tuple) -> ProcessPoolExecutor:
        # a fresh pool per call, not a cached one: the initializer contract
        # is per-pool (it must run before any task), and callers batch an
        # entire phase into one map call, so startup amortizes
        guarded = (partial(_guarded_initializer, initializer, initargs)
                   if initializer is not None else None)
        return ProcessPoolExecutor(max_workers=n, mp_context=self._ctx,
                                   initializer=guarded)

    def map_unordered(self, fn: Callable, tasks: Iterable, *,
                      initializer: Callable | None = None,
                      initargs: tuple = ()) -> Iterator[tuple[int, object]]:
        task_list = list(tasks)
        if not task_list:
            return
        pool = self._pool(min(self.n_workers, len(task_list)),
                          initializer, initargs)
        try:
            futs = [pool.submit(_call_indexed, fn, i, t)
                    for i, t in enumerate(task_list)]
            for f in as_completed(futs):
                yield f.result()
        finally:
            # cancel_futures so an aborting caller (or a task exception)
            # doesn't wait out the whole remaining queue
            pool.shutdown(wait=True, cancel_futures=True)

    def map_throttled(self, fn: Callable, tasks: Iterable, *,
                      credits: Callable[[], float],
                      initializer: Callable | None = None,
                      initargs: tuple = (),
                      on_discard: Callable[[object], None] | None = None
                      ) -> Iterator[tuple[int, object]]:
        """Submission-throttled fan-out: task ``i`` is pulled from ``tasks``
        and submitted only while ``i < credits()``.

        ``tasks`` is consumed lazily, so a task source that attaches a
        scarce resource per task (a shared-memory slab) is only asked for a
        task when the credit window guarantees the resource is available.
        ``credits`` must be monotone non-decreasing and is re-read after
        every yielded result, so consumption (which recycles resources)
        extends the window.

        ``on_discard`` receives the result of any task that completed but
        was never yielded (the caller aborted mid-iteration) — the hook for
        releasing external resources a result descriptor may own.
        """
        it = enumerate(iter(tasks))
        pool = self._pool(self.n_workers, initializer, initargs)
        pending: dict = {}
        submitted = 0
        exhausted = False
        try:
            while True:
                while not exhausted and submitted < credits():
                    try:
                        i, task = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending[pool.submit(_call_indexed, fn, i, task)] = i
                    submitted += 1
                if not pending:
                    if exhausted:
                        return
                    raise RuntimeError(
                        "map_throttled stalled: no submission credit and "
                        "nothing in flight — credits() must allow at least "
                        "one task")
                done, _ = wait(pending, return_when=FIRST_COMPLETED)
                for f in done:
                    del pending[f]
                    yield f.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            if on_discard is not None:
                for f in pending:  # completed but never yielded
                    if f.done() and not f.cancelled() \
                            and f.exception() is None:
                        try:
                            on_discard(f.result())
                        except Exception:
                            pass
