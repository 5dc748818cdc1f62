"""Call-path and metric-space selection, top-k, and aggregations.

Programmatic call-path query APIs (Hatchet/Chopper-style) over the sparse
stores.  Everything here keeps the paper's space discipline: selections run
on the unified CCT and the summary-statistics section (no plane I/O at
all), per-profile aggregations decode exactly one PMS plane, per-context
aggregations decode exactly one CMS plane — **nothing densifies** the
(profile x context x metric) tensor.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from repro_torch.core.metrics import INCLUSIVE_BIT
from repro_torch.query.database import Database


@dataclass(frozen=True)
class HotPath:
    """One top-k row: a context, its call path, and its costs."""

    ctx: int
    path: str
    value: float          # ranking cost (inclusive or exclusive, see query)
    exclusive: float      # exclusive cost of the same (ctx, metric)

    def as_dict(self) -> dict:
        return {"ctx": self.ctx, "path": self.path,
                "value": self.value, "exclusive": self.exclusive}


# ---------------------------------------------------------------------------
# call-path selection (CCT only — zero store I/O)
# ---------------------------------------------------------------------------

def select_contexts(db: Database, *, kind: int | None = None,
                    name: str | None = None, path_regex: str | None = None,
                    predicate=None) -> np.ndarray:
    """Context ids matching structural filters on the unified CCT.

    ``kind`` matches the node kind, ``name`` the node's own name exactly,
    ``path_regex`` searches the full root-to-node path, and ``predicate``
    is an escape hatch called as ``predicate(ctx, path) -> bool``.  Filters
    compose conjunctively.
    """
    tree = db.tree
    n = db.n_contexts
    keep = np.ones(n, dtype=bool)
    if kind is not None:
        keep &= np.asarray(tree.kind) == int(kind)
    if name is not None:
        names = np.array([tree.name_of(c) for c in range(n)])
        keep &= names == name
    if path_regex is not None or predicate is not None:
        rx = re.compile(path_regex) if path_regex is not None else None
        for c in np.flatnonzero(keep):
            path = tree.full_path(int(c))
            if rx is not None and not rx.search(path):
                keep[c] = False
            elif predicate is not None and not predicate(int(c), path):
                keep[c] = False
    return np.flatnonzero(keep)


def _within_mask(ctx_ids: np.ndarray, within) -> np.ndarray:
    """Membership of ``ctx_ids`` in a ``within`` restriction, which is
    either an array of context ids or a boolean ownership mask indexed by
    context id (the shard fast path: O(n) gather instead of a sort)."""
    w = np.asarray(within)
    if w.dtype == np.bool_:
        return w[ctx_ids.astype(np.int64)]
    return np.isin(ctx_ids, w)


def threshold_contexts(db: Database, metric, *, min_value: float,
                       stat: str = "sum", inclusive: bool = False,
                       within: np.ndarray | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Contexts whose cross-profile ``stat`` of ``metric`` >= ``min_value``.

    Runs entirely on the summary-statistics section (paper §4.1.2); returns
    ``(ctx_ids, stat_values)`` sorted by descending value.  ``within``
    optionally restricts to a prior :func:`select_contexts` result (id
    array or boolean mask over context ids).
    """
    ctx_ids, rows = db.metric_entries(metric, inclusive=inclusive)
    vals = db.stats[stat][rows]
    keep = vals >= min_value
    if within is not None:
        keep &= _within_mask(ctx_ids, within)
    ctx_ids, vals = ctx_ids[keep], vals[keep]
    order = np.lexsort((ctx_ids, -vals))  # value desc, ctx asc tiebreak
    return ctx_ids[order], vals[order]


@dataclass(frozen=True)
class StripeRow:
    """One :func:`stripe_select` row: a selected context with its stripe."""

    ctx: int
    path: str
    stat: float                # the summary stat the context was selected by
    profiles: np.ndarray       # (p,) u32 profile ids carrying the metric
    values: np.ndarray         # (p,) f64 per-profile values


def stripe_select(db: Database, metric, *, min_value: float = 0.0,
                  stat: str = "sum", inclusive: bool = False,
                  kind: int | None = None, name: str | None = None,
                  path_regex: str | None = None, predicate=None,
                  limit: int | None = None) -> list[StripeRow]:
    """Call-path + threshold select that returns per-profile stripes.

    The filters are pushed all the way down: call-path predicates and the
    summary-stat threshold run with zero store I/O (CCT + summary stats),
    and each surviving context is read through the Database's stripe
    pushdown — only the selected metric's slice is decoded, never the full
    CMS plane.  Before the pushdown this shape materialized (and cached)
    one whole plane per selected context just to keep one stripe of it.
    """
    within = None
    if any(f is not None for f in (kind, name, path_regex, predicate)):
        within = select_contexts(db, kind=kind, name=name,
                                 path_regex=path_regex, predicate=predicate)
    ctx_ids, vals = threshold_contexts(db, metric, min_value=min_value,
                                       stat=stat, inclusive=inclusive,
                                       within=within)
    if limit is not None:
        ctx_ids, vals = ctx_ids[:limit], vals[:limit]
    out = []
    for c, v in zip(ctx_ids, vals):
        prof, pv = db.stripe(int(c), metric, inclusive=inclusive)
        out.append(StripeRow(ctx=int(c), path=db.path_of(int(c)),
                             stat=float(v), profiles=prof, values=pv))
    return out


# ---------------------------------------------------------------------------
# top-k hot paths
# ---------------------------------------------------------------------------

def topk_hot_paths(db: Database, metric, k: int = 10, *,
                   inclusive: bool = True, stat: str = "sum",
                   leaves_only: bool = False,
                   within: np.ndarray | None = None) -> list[HotPath]:
    """The k hottest call paths by inclusive (default) or exclusive cost.

    Ranking reads only summary statistics; the deterministic
    ``(-value, ctx)`` order makes results identical across executor
    backends for byte-identical databases.  ``leaves_only`` drops interior
    nodes (whose inclusive cost double-counts their subtrees) — useful for
    flat profiles.  ``within`` restricts ranking to a context subset — id
    array or boolean mask over context ids (how a shard computes its
    partial top-k over only the contexts it owns: the global top-k is a
    merge of per-shard partials because ``within`` sets partition the
    contexts).
    """
    ctx_ids, rows = db.metric_entries(metric, inclusive=inclusive)
    vals = db.stats[stat][rows]
    if within is not None:
        keep = _within_mask(ctx_ids, within)
        ctx_ids, vals = ctx_ids[keep], vals[keep]
    if leaves_only and ctx_ids.size:
        parents = set(int(p) for p in db.tree.parent[1:])
        keep = np.array([int(c) not in parents for c in ctx_ids])
        ctx_ids, vals = ctx_ids[keep], vals[keep]
    order = np.lexsort((ctx_ids, -vals))[:k]
    mid = db.resolve_metric(metric, inclusive=inclusive)
    excl_mid = mid & ~INCLUSIVE_BIT
    out = []
    for i in order:
        c = int(ctx_ids[i])
        out.append(HotPath(ctx=c, path=db.path_of(c), value=float(vals[i]),
                           exclusive=db.summary(c, excl_mid, stat)))
    return out


# ---------------------------------------------------------------------------
# aggregations (one plane each — never densify)
# ---------------------------------------------------------------------------

_AGGS = {
    "sum": np.add.reduceat,
    "max": np.maximum.reduceat,
    "min": np.minimum.reduceat,
}


def profile_aggregate(db: Database, pid: int, *, agg: str = "sum",
                      include_inclusive: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-metric aggregate over all contexts of one profile.

    One PMS plane read; returns ``(mids, values)`` with metric ids sorted.
    Inclusive-variant metrics are excluded by default (they double-count
    their exclusive sources along every ancestor chain).
    """
    sm = db.profile_metrics(pid)
    _, mids, vals = sm.triplets()
    if not include_inclusive and mids.size:
        keep = (mids & INCLUSIVE_BIT) == 0
        mids, vals = mids[keep], vals[keep]
    if mids.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    order = np.argsort(mids, kind="stable")
    mids, vals = mids[order], vals[order]
    bounds = np.flatnonzero(np.diff(mids, prepend=-1))
    return mids[bounds], _AGGS[agg](vals, bounds)


def context_aggregate(db: Database, ctx: int, *, agg: str = "sum"
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-metric aggregate across all profiles of one context.

    One CMS plane read; returns ``(mids, values)``.  ``agg="mean"`` divides
    by the number of profiles observing each metric (non-zeros only, the
    same convention as the database's summary mean).
    """
    mids, mstart, _, vals = db.context_plane(ctx)
    if mids.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    bounds = mstart[:-1].astype(np.int64)
    if agg == "mean":
        sums = np.add.reduceat(vals, bounds)
        cnts = np.diff(mstart.astype(np.int64))
        return mids.astype(np.int64), sums / np.maximum(cnts, 1)
    return mids.astype(np.int64), _AGGS[agg](vals, bounds)
