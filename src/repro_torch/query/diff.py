"""Cross-run regression analysis: diff two databases on the unified CCT.

Two runs of the same application produce different context *ids* (each
run's unified CCT depends on which call paths its profiles observed), so
alignment is by **call path**: a context in run A matches the context in
run B with the same root-to-node path.  Costs come from each database's
summary-statistics section — a diff reads zero planes from either store.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.query.database import Database


@dataclass(frozen=True)
class DiffEntry:
    """One aligned call path and its cost under each run.

    ``std_a``/``std_b`` carry the per-context cross-profile standard
    deviation from each run's summary stats — the raw material for noise
    bands (a delta smaller than the run's own internal spread is weather,
    not climate).
    """

    path: str
    ctx_a: int | None     # context id in run A (None: path only in B)
    ctx_b: int | None     # context id in run B (None: path only in A)
    a: float
    b: float
    std_a: float = 0.0    # per-context std across profiles in run A
    std_b: float = 0.0    # per-context std across profiles in run B

    @property
    def delta(self) -> float:
        return self.b - self.a

    @property
    def ratio(self) -> float:
        return self.b / self.a if self.a else float("inf")

    def as_dict(self) -> dict:
        return {"path": self.path, "ctx_a": self.ctx_a, "ctx_b": self.ctx_b,
                "a": self.a, "b": self.b, "delta": self.delta,
                "std_a": self.std_a, "std_b": self.std_b}


# how to fold two same-path contexts' stats into one path-level stat;
# mean/std are not foldable without counts, so they fail loudly instead
# of reporting a silently wrong number
_COMBINE = {"sum": lambda a, b: a + b, "count": lambda a, b: a + b,
            "max": max, "min": min}


def _metric_by_path(db: Database, metric, stat: str, inclusive: bool
                    ) -> dict[str, tuple[int, float]]:
    return {p: (c, v) for p, (c, v, _s) in
            metric_stats_by_path(db, metric, stat, inclusive).items()}


def metric_stats_by_path(db: Database, metric, stat: str, inclusive: bool
                         ) -> dict[str, tuple[int, float, float]]:
    """``{path: (ctx, value, std)}`` for one metric; tolerant of absence.

    A metric that exists in only one run resolves to an empty mapping here
    rather than raising — its paths then diff against 0 on the missing
    side, which is exactly the new/vanished shape a regression hunt wants.
    ``std`` is the per-context standard deviation across the run's own
    profiles; paths folding several contexts keep the largest std (the
    conservative noise estimate).
    """
    try:
        ctx_ids, rows = db.metric_entries(metric, inclusive=inclusive)
    except (KeyError, ValueError, IndexError):
        return {}
    vals = db.stats[stat][rows]
    stds = db.stats["std"][rows]
    out: dict[str, tuple[int, float, float]] = {}
    for c, v, s in zip(ctx_ids, vals, stds):
        path = db.path_of(int(c))
        prev = out.get(path)
        if prev is None:
            out[path] = (int(c), float(v), float(s))
            continue
        # distinct contexts can share a path string (same name, different
        # node kind): fold them — the diff unit is the call path
        fold = _COMBINE.get(stat)
        if fold is None:
            raise ValueError(
                f"stat {stat!r} cannot be folded across the {len(ctx_ids)} "
                f"contexts sharing path {path!r}; use sum/count/max/min")
        out[path] = (prev[0], fold(prev[1], float(v)), max(prev[2], float(s)))
    return out


def diff(db_a: Database, db_b: Database, metric, *, stat: str = "sum",
         inclusive: bool = True, top: int | None = None,
         min_abs_delta: float = 0.0) -> list[DiffEntry]:
    """Per-call-path cost deltas between two runs, largest first.

    Contexts present in only one run appear with the other side at 0 —
    exactly the new/vanished call paths a regression hunt wants surfaced.
    Ordering is deterministic: ``(-|delta|, path)``.  ``top`` truncates;
    ``min_abs_delta`` filters noise (and drops exact ties at 0.0).
    """
    by_a = metric_stats_by_path(db_a, metric, stat, inclusive)
    by_b = metric_stats_by_path(db_b, metric, stat, inclusive)
    out: list[DiffEntry] = []
    for path in by_a.keys() | by_b.keys():
        ca, va, sa = by_a.get(path, (None, 0.0, 0.0))
        cb, vb, sb = by_b.get(path, (None, 0.0, 0.0))
        if abs(vb - va) < min_abs_delta or (min_abs_delta == 0.0 and vb == va):
            continue
        out.append(DiffEntry(path=path, ctx_a=ca, ctx_b=cb, a=va, b=vb,
                             std_a=sa, std_b=sb))
    out.sort(key=lambda e: (-abs(e.delta), e.path))
    return out[:top] if top is not None else out


def total_delta(db_a: Database, db_b: Database, metric, *,
                stat: str = "sum") -> tuple[float, float]:
    """Whole-run exclusive-cost totals ``(total_a, total_b)`` for a metric.

    Uses exclusive entries only so the total is not inflated by ancestor
    propagation; zero plane reads.
    """
    ta = sum(v for _, v in _metric_by_path(db_a, metric, stat, False).values())
    tb = sum(v for _, v in _metric_by_path(db_b, metric, stat, False).values())
    return float(ta), float(tb)
