"""Typed diagnosis records: the unit of output for every analyzer.

A ``Finding`` is one structured statement about a run — "this call path
regressed 2.1x against its baseline band", "rank 7 logged 3x the median
trace samples" — with enough evidence attached that a human (or the next
tool) never has to re-run the query that produced it.

Findings are value objects: frozen, orderable by a deterministic severity
key, and round-trippable through plain dicts so they travel the serve
wire protocol and land in JSON reports unchanged.  Determinism matters
beyond aesthetics — sharded serving computes findings per-shard and
merges by concatenation + this sort, so the sort key must totally order
any finding set the analyzers can emit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SEVERITIES = ("info", "warning", "critical")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def severity_for(score: float) -> str:
    """Map an analyzer score to a severity.

    ``score`` is normalized badness: observed / threshold (or band edge),
    so 1.0 is "exactly at the line".  Analyzers only emit findings at
    score >= 1, hence nothing here maps to ``info`` — that level is
    reserved for advisory findings (new call paths, missing baselines)
    that analyzers mint explicitly.
    """
    return "critical" if score >= 2.0 else "warning"


@dataclass(frozen=True)
class Finding:
    """One diagnosis: what is wrong, where, and the numbers behind it."""

    kind: str             # regression | load_imbalance | straggler | occupancy_gap | new_path
    severity: str         # one of SEVERITIES
    score: float          # normalized badness; >= 1 means "over the line"
    message: str          # one human-readable sentence
    ctx: int = -1         # context id (call-path findings; -1 otherwise)
    path: str = ""        # full call path string when ctx is set
    pid: int = -1         # profile/rank id (per-rank findings; -1 otherwise)
    metric: str = ""      # metric label the evidence is in ("" when n/a)
    value: float = 0.0    # observed quantity
    expected: float = 0.0 # reference: band edge, threshold, or baseline mean
    t0: float = 0.0       # trace span of the evidence (both 0: no span)
    t1: float = 0.0
    evidence: dict = field(default_factory=dict, compare=False)

    def sort_key(self):
        """Severity desc, score desc, then stable structural tiebreaks."""
        return (-_RANK.get(self.severity, 0), -self.score,
                self.kind, self.ctx, self.pid, self.path)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "severity": self.severity,
                "score": self.score, "message": self.message,
                "ctx": self.ctx, "path": self.path, "pid": self.pid,
                "metric": self.metric, "value": self.value,
                "expected": self.expected, "t0": self.t0, "t1": self.t1,
                "evidence": dict(self.evidence)}

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(kind=str(d.get("kind", "")),
                   severity=str(d.get("severity", "info")),
                   score=float(d.get("score", 0.0)),
                   message=str(d.get("message", "")),
                   ctx=int(d.get("ctx", -1)), path=str(d.get("path", "")),
                   pid=int(d.get("pid", -1)), metric=str(d.get("metric", "")),
                   value=float(d.get("value", 0.0)),
                   expected=float(d.get("expected", 0.0)),
                   t0=float(d.get("t0", 0.0)), t1=float(d.get("t1", 0.0)),
                   evidence=dict(d.get("evidence") or {}))


def sort_findings(findings: list[Finding], limit: int | None = None
                  ) -> list[Finding]:
    """The canonical ordering every producer (and shard merge) applies."""
    out = sorted(findings, key=Finding.sort_key)
    return out[:limit] if limit else out
