"""Chaos schedule harness: timed fault injection against a live server.

A :class:`ChaosSchedule` is a deterministic list of :class:`ChaosEvent`s
applied to a running :class:`~repro_torch.serve.shard.ShardedQueryServer`
while load is in flight — the proof harness behind the replicated
serving design: with R-way ownership, any single replica's death (or a
whole shard group's), transport message loss, added latency, or a hung
peer must cost *latency only*, never a failed client request and never
a byte of divergence from the unfaulted run.

Event kinds:

* ``kill``       — SIGKILL one shard's worker process (the classic
  worker-death drill; recovery = failover to a live replica + respawn).
* ``kill_group`` — SIGKILL several workers at the same instant (a whole
  shard group / host dying; ``shards`` lists the group).
* ``drop``       — the parent->worker transport silently discards
  requests for ``duration_s`` (message loss; recovery = stall
  detection -> suspect -> hung-kill -> replay).
* ``delay``      — every transport send sleeps ``delay_s`` for
  ``duration_s`` (a slow link).
* ``stall``      — worker replies stop being delivered for
  ``duration_s`` even though the worker is alive (a hung peer /
  partition that heals).

Port of :mod:`repro.serve.chaos`; it imports no torch.  Used by
``tests/test_torch_chaos.py`` (its long drills are the ``-m chaos``
suite) and ``chip_smoke.py``'s ``chaos`` phase.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from repro_torch.obs import monotime

#: event kinds understood by ChaosSchedule.run
KINDS = ("kill", "kill_group", "drop", "delay", "stall")


@dataclass(frozen=True)
class ChaosEvent:
    """One timed fault: fires ``at_s`` seconds after schedule start."""

    at_s: float
    kind: str            # one of KINDS
    shard: int = 0       # target shard (ignored by kill_group)
    shards: tuple = ()   # kill_group targets
    duration_s: float = 0.5   # fault window for drop/delay/stall
    delay_s: float = 0.02     # per-send sleep for delay

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}")


@dataclass
class AppliedEvent:
    """Journal entry: what actually fired, when, at what."""

    t_s: float
    kind: str
    targets: tuple
    detail: dict = field(default_factory=dict)


class ChaosSchedule:
    """Apply a fixed event list to a server on a background thread.

    The schedule is deterministic by construction (no randomness — vary
    the event list, not a seed), so a faulted run can be compared
    byte-for-byte against an unfaulted run of the same request stream.
    """

    def __init__(self, server, events: list[ChaosEvent]):
        self.server = server
        self.events = sorted(events, key=lambda e: e.at_s)
        self.applied: list[AppliedEvent] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ChaosSchedule":
        self._t0 = monotime()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-schedule")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "ChaosSchedule":
        return self.start()

    def __exit__(self, *a) -> None:
        self.stop()
        self.join(timeout=5.0)

    # -- engine -------------------------------------------------------------
    def _run(self) -> None:
        for ev in self.events:
            wait = self._t0 + ev.at_s - monotime()
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            self._apply(ev)

    def _apply(self, ev: ChaosEvent) -> None:
        t = monotime() - self._t0
        srv = self.server
        if ev.kind == "kill":
            pid = srv.kill_worker(ev.shard)
            self.applied.append(AppliedEvent(t, "kill", (ev.shard,),
                                             {"pid": pid}))
        elif ev.kind == "kill_group":
            targets = tuple(ev.shards) or (ev.shard,)
            pids = [srv.kill_worker(s) for s in targets]
            self.applied.append(AppliedEvent(t, "kill_group", targets,
                                             {"pids": pids}))
        else:
            srv.inject_fault(ev.shard, ev.kind, ev.duration_s,
                             delay_s=ev.delay_s)
            self.applied.append(AppliedEvent(
                t, ev.kind, (ev.shard,),
                {"duration_s": ev.duration_s}))

    def report(self) -> list[dict]:
        return [{"t_s": round(a.t_s, 3), "kind": a.kind,
                 "targets": list(a.targets), **a.detail}
                for a in self.applied]


def default_schedule(n_shards: int, *, span_s: float = 2.0,
                     kinds: tuple = ("kill", "drop", "stall")
                     ) -> list[ChaosEvent]:
    """A canned schedule spreading one event of each requested kind
    across ``span_s`` seconds, rotating over shards — the smoke-level
    dose."""
    kinds = tuple(k for k in kinds if k in KINDS) or ("kill",)
    step = span_s / (len(kinds) + 1)
    return [ChaosEvent(at_s=step * (i + 1), kind=k, shard=i % n_shards,
                       duration_s=min(0.5, step))
            for i, k in enumerate(kinds)]
