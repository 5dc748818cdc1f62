"""Regression watch: continuous diagnosis over the live epoch stream.

The ingest tier publishes versioned snapshots behind a ``CURRENT``
pointer; a :class:`RegressionWatch` follows one or more snapshot roots
with the same :class:`~repro_torch.query.epoch.EpochSwitcher` machinery the
``--follow`` server uses, and evaluates **every newly published epoch**
against its baseline fleet inside the poll loop itself — detection
latency is bounded by one poll interval plus the evaluation time, both of
which it measures.

Per evaluation it emits:

* typed :class:`~repro_torch.diagnose.findings.Finding` records (kept in a
  bounded history, handed to an optional ``on_report`` callback);
* ``watch.*`` metrics through the obs registry — evaluation latency
  histogram, per-severity finding counters, poll/error counters;
* one ``watch`` span per evaluation in the flight recorder, and a ring
  dump when an evaluation surfaces critical findings (so the spans
  *around* the regression are preserved for postmortem).

One watch supervises many targets — the multi-tenant pattern is one
``WatchTarget`` per team's snapshot root.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

from repro_torch.diagnose.analyzers import (compute_findings, regression_findings,
                                            sort_findings)
from repro_torch.diagnose.baseline import BaselineFleet
from repro_torch.diagnose.findings import Finding
from repro_torch.obs import FlightRecorder, MetricsRegistry, monotime, recorder
from repro_torch.query.epoch import EpochSwitcher, wait_for_epoch


@dataclass
class WatchTarget:
    """One supervised snapshot root and its evaluation recipe."""

    name: str
    root: str
    #: a BaselineFleet, a directory path for the watch to open (and own),
    #: or None: trace analyzers only
    baseline: BaselineFleet | str | None = None
    metric: object = 0
    stat: str = "sum"
    inclusive: bool = True
    analyzers: tuple = ()       # extra scatter-clean analyzers per epoch
    z: float = 3.0
    rel_margin: float = 0.05
    abs_margin: float = 0.0
    min_value: float = 0.0
    thresholds: dict = field(default_factory=dict)


@dataclass(frozen=True)
class EpochReport:
    """The outcome of evaluating one published epoch of one target."""

    target: str
    epoch: int
    findings: tuple
    eval_s: float

    @property
    def worst(self) -> str:
        return self.findings[0].severity if self.findings else "none"

    def as_dict(self) -> dict:
        return {"target": self.target, "epoch": self.epoch,
                "eval_s": self.eval_s, "worst": self.worst,
                "findings": [f.as_dict() for f in self.findings]}


class _TargetState:
    def __init__(self, target: WatchTarget, switcher: EpochSwitcher,
                 owned_baseline: BaselineFleet | None = None):
        self.target = target
        self.switcher = switcher
        self.owned_baseline = owned_baseline  # opened from a path: we close
        self.latest: EpochReport | None = None

    @property
    def baseline(self) -> BaselineFleet | None:
        if self.owned_baseline is not None:
            return self.owned_baseline
        b = self.target.baseline
        return b if isinstance(b, BaselineFleet) else None


class RegressionWatch:
    """Follow snapshot roots; diagnose each new epoch within a poll tick."""

    def __init__(self, targets, *, poll_ms: float = 250.0,
                 cache_bytes: int = 64 << 20, wait_s: float = 60.0,
                 history: int = 256, on_report=None,
                 rec: FlightRecorder | None = None):
        if isinstance(targets, WatchTarget):
            targets = [targets]
        if not targets:
            raise ValueError("RegressionWatch needs at least one target")
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate watch target names: {names}")
        self._targets = list(targets)
        self.poll_ms = float(poll_ms)
        self.cache_bytes = int(cache_bytes)
        self.wait_s = float(wait_s)
        self.on_report = on_report
        self._rec = rec if rec is not None else recorder()
        self._states: dict[str, _TargetState] = {}
        self._history: deque[EpochReport] = deque(maxlen=int(history))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        self.obs = MetricsRegistry()
        self._eval_hist = self.obs.histogram("watch.eval_latency")
        self.counters = self.obs.group(
            "watch", {"polls": 0, "epochs": 0, "errors": 0, "findings": 0,
                      "critical": 0, "warning": 0, "info": 0})
        self.obs.gauge("watch.targets", lambda: len(self._targets))

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "RegressionWatch":
        """Open every target (waiting for its first epoch) and evaluate it
        once, so a watch pointed at an already-regressed stream flags it
        immediately; then begin the poll thread."""
        for t in self._targets:
            wait_for_epoch(t.root, timeout_s=self.wait_s)
            owned = (BaselineFleet.from_dir(t.baseline)
                     if isinstance(t.baseline, str) else None)
            st = _TargetState(t, EpochSwitcher(t.root,
                                               cache_bytes=self.cache_bytes),
                              owned_baseline=owned)
            self._states[t.name] = st
            self._evaluate(st)
        self._thread = threading.Thread(target=self._loop,
                                        name="regression-watch", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for st in self._states.values():
            st.switcher.close()
            if st.owned_baseline is not None:
                st.owned_baseline.close()
        self._states.clear()

    def __enter__(self) -> "RegressionWatch":
        return self.start()

    def __exit__(self, *a) -> None:
        self.stop()

    # -- the loop -------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.poll_ms / 1000.0):
            self.poll_once()

    def poll_once(self) -> int:
        """One poll pass over every target; returns epochs evaluated.
        Public so tests (and cron-style drivers) can step deterministically."""
        evaluated = 0
        self.counters.inc("polls")
        for st in self._states.values():
            try:
                if st.switcher.poll():
                    self._evaluate(st)
                    evaluated += 1
            except Exception:
                # SnapshotGone after retry, torn reads mid-publish: count
                # and keep watching — the next poll sees a settled pointer
                self.counters.inc("errors")
        return evaluated

    def _evaluate(self, st: _TargetState) -> EpochReport:
        t = st.target
        t0 = monotime()
        db = st.switcher.db
        epoch = st.switcher.epoch or 0
        findings: list[Finding] = []
        baseline = st.baseline
        if baseline is not None:
            findings += regression_findings(
                db, baseline, t.metric, stat=t.stat, inclusive=t.inclusive,
                z=t.z, rel_margin=t.rel_margin, abs_margin=t.abs_margin,
                min_value=t.min_value)
        if t.analyzers:
            findings += compute_findings(
                db, analyzers=t.analyzers, metric=t.metric,
                thresholds=t.thresholds or None)
        findings = sort_findings(findings)
        dur = monotime() - t0

        self._eval_hist.observe(dur)
        self.counters.inc("epochs")
        self.counters.inc("findings", len(findings))
        for f in findings:
            self.counters.inc(f.severity)
        self._rec.record("watch", t.name, t0, dur,
                         attrs={"epoch": epoch, "findings": len(findings)})
        if findings and findings[0].severity == "critical":
            self._rec.dump(f"critical findings: target={t.name} "
                           f"epoch={epoch}")

        report = EpochReport(target=t.name, epoch=epoch,
                             findings=tuple(findings), eval_s=dur)
        with self._lock:
            st.latest = report
            self._history.append(report)
        if self.on_report is not None:
            self.on_report(report)
        return report

    # -- inspection -----------------------------------------------------------
    def latest(self, name: str) -> EpochReport | None:
        with self._lock:
            st = self._states.get(name)
            return st.latest if st is not None else None

    def reports(self, name: str | None = None) -> list[EpochReport]:
        with self._lock:
            return [r for r in self._history
                    if name is None or r.target == name]

    def status(self) -> dict:
        with self._lock:
            targets = {
                n: {"epoch": st.latest.epoch if st.latest else None,
                    "findings": len(st.latest.findings) if st.latest else 0,
                    "worst": st.latest.worst if st.latest else "none",
                    "eval_s": st.latest.eval_s if st.latest else 0.0}
                for n, st in self._states.items()}
        return {"poll_ms": self.poll_ms, "targets": targets,
                "counters": dict(self.counters),
                "eval_latency": self._eval_hist.as_dict()}
