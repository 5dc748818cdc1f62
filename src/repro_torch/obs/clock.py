"""The one monotonic clock for the serve/ingest stack.

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
"""
from __future__ import annotations

import time

monotime = time.monotonic
