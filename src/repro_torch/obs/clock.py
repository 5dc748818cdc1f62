"""The one monotonic clock of the port: the serve/ingest stack and the
training job.

Every duration and span timestamp in the fleet comes from here.  On
Linux ``time.monotonic()`` is ``CLOCK_MONOTONIC`` — the same epoch in
every process on the host — so spans recorded in shard workers line up
with spans recorded in the HTTP front on a shared timeline, which is
what lets :mod:`repro_torch.obs.export` build one coherent trace database out
of a multi-process server's flight recorders.

(`serve/warm.py` used to time with ``time.perf_counter()`` while the
rest of the stack used ``time.monotonic()``; mixing the two makes
cross-module latency numbers incomparable.  Import ``monotime`` instead
of picking a clock.)

``torch.profiler`` stamps its events on the Unix wall clock, in ns.
:data:`TRACE_ANCHOR_NS`, taken once at import, is the wall clock less
``monotime``; :func:`to_trace_ns` puts a ``monotime`` on that clock, so
spans lie over a profiler trace, and over other hosts' spans as far as
their wall clocks agree.
"""
from __future__ import annotations

import time

monotime = time.monotonic

#: ``time.time_ns() - time.monotonic_ns()`` at import
TRACE_ANCHOR_NS = time.time_ns() - time.monotonic_ns()


def to_trace_ns(t: float) -> int:
    """A ``monotime()`` reading ``t`` as ns on ``torch.profiler``'s clock."""
    return round(t * 1e9) + TRACE_ANCHOR_NS
