"""Executor interface and registry for the aggregation runtime.

The paper's analysis tool gets its order-of-magnitude speedup from *both*
shared-memory threading (§4.2) and distributed-memory ranks (§4.4).  This
package makes the execution substrate of the streaming aggregator a
pluggable choice:

* ``serial``    — inline loop, no concurrency (debugging / baselines);
* ``threads``   — the original shared-counter thread pool (§4.2.4 analog);
* ``processes`` — multiprocessing workers over profile shards, the
  single-node stand-in for the paper's MPI ranks.

An :class:`Executor` exposes two primitives:

* :meth:`Executor.parallel_for` — an in-process parallel loop over item
  indices; the body may close over shared state (threads/serial only);
* :meth:`Executor.map_unordered` — fan out picklable ``fn(task)`` calls and
  yield ``(index, result)`` in completion order; works on every backend and
  is the only primitive the ``processes`` backend supports, since closures
  do not cross address spaces.

Backends self-register via :func:`register_executor`; engines resolve one
with :func:`get_executor` and treat it uniformly.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Callable, Iterable, Iterator

_REGISTRY: dict[str, type["Executor"]] = {}


def register_executor(cls: type["Executor"]) -> type["Executor"]:
    """Class decorator: make ``cls`` resolvable by :func:`get_executor`."""
    assert cls.name, "executor classes must set a non-empty `name`"
    _REGISTRY[cls.name] = cls
    return cls


def available_executors() -> list[str]:
    return sorted(_REGISTRY)


def get_executor(name: str, n_workers: int = 1, **kwargs) -> "Executor":
    """Instantiate a registered backend by name.

    Raises ``ValueError`` (not KeyError) on unknown names so config errors
    surface with the list of valid choices.  ``kwargs`` pass through to the
    backend constructor (e.g. ``mp_context`` for ``processes``).
    """
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; available: {', '.join(available_executors())}"
        ) from None
    return cls(n_workers, **kwargs)


def executor_for(name: str, n_workers: int, compute: str) -> "Executor":
    """:func:`get_executor` for an engine run on ``compute``, with the spawn
    rule: when ``compute == "device"`` an out-of-process backend starts its
    workers with ``spawn``, since a forked child cannot use CUDA once its
    parent has (and forking a parent whose torch thread pools have run is
    the hazard :mod:`repro_torch.runtime.processes` names).  An explicit
    ``REPRO_MP_CONTEXT`` still wins."""
    kwargs = {}
    cls = _REGISTRY.get(name)
    if (compute == "device" and cls is not None and not cls.in_process
            and not os.environ.get("REPRO_MP_CONTEXT")):
        kwargs["mp_context"] = "spawn"
    return get_executor(name, n_workers, **kwargs)


class Executor(ABC):
    """A unit of parallel execution policy.

    ``in_process`` tells engines whether workers share the caller's address
    space: when False, shared-mutable-state code paths must be replaced by
    shard-local computation plus explicit reduction (see
    :mod:`repro_torch.runtime.reduce`).
    """

    name: str = ""
    in_process: bool = True
    # "stream": the executor runs the streaming engine's loops itself.
    # "ranks": the backend is a whole-run driver (paper §4.4) — the engine
    # delegates the entire aggregation to it instead of calling primitives.
    driver: str = "stream"

    def __init__(self, n_workers: int = 1):
        self.n_workers = max(1, int(n_workers))

    # -- primitives ---------------------------------------------------------
    @abstractmethod
    def parallel_for(self, n_items: int, body: Callable[[int], None]) -> None:
        """Run ``body(i)`` for every ``i in range(n_items)``; the first
        worker exception is re-raised after all workers stop."""

    @abstractmethod
    def map_unordered(self, fn: Callable, tasks: Iterable, *,
                      initializer: Callable | None = None,
                      initargs: tuple = ()) -> Iterator[tuple[int, object]]:
        """Yield ``(index, fn(task))`` pairs in completion order.

        ``fn``/``tasks`` must be picklable for out-of-process backends.
        ``initializer(*initargs)`` runs before any task executes: once per
        worker process on out-of-process backends, once in the caller's
        thread on in-process ones — so it must set up state shared through
        the address space (module globals), not per-thread state."""

    def map_throttled(self, fn: Callable, tasks: Iterable, *,
                      credits: Callable[[], float],
                      initializer: Callable | None = None,
                      initargs: tuple = (),
                      on_discard: Callable[[object], None] | None = None
                      ) -> Iterator[tuple[int, object]]:
        """Like :meth:`map_unordered`, but task ``i`` is pulled from
        ``tasks`` (lazily) and submitted only while ``i < credits()`` —
        the backpressure primitive for feeders that attach a scarce
        per-task resource (shared-memory slabs).  ``on_discard`` disposes
        results that completed but were never yielded to an aborting
        caller.  In-process engines get backpressure from the bounded
        :class:`~repro_torch.runtime.OrderedSink` instead, so only
        out-of-process backends implement this."""
        raise NotImplementedError(
            f"executor {self.name!r} does not support throttled submission")

    # -- helpers ------------------------------------------------------------
    def shards(self, n_items: int) -> list[list[int]]:
        """Deterministic contiguous split of ``range(n_items)`` into at most
        ``n_workers`` non-empty shards (profile-shard layout of paper §4.4)."""
        w = max(1, min(self.n_workers, n_items))
        bounds = [round(k * n_items / w) for k in range(w + 1)]
        return [list(range(bounds[k], bounds[k + 1]))
                for k in range(w) if bounds[k] < bounds[k + 1]]

    def close(self) -> None:
        """Release backend resources (worker pools); idempotent."""

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
