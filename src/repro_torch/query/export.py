"""Hatchet-style dataframe export for interop with pandas tooling.

Automated programmatic analysis frameworks (Hatchet, Chopper) consume
call-path profiles as dataframes: one row per CCT node, one column per
metric, indexed by call path.  :func:`to_dataframe` produces that shape
from a :class:`~repro_torch.query.Database` using the summary-statistics section
alone — zero plane I/O, so exporting a million-context database costs one
pivot, not a store scan.

pandas is an *optional* dependency: importing this module is always safe,
and :func:`to_dataframe` raises a descriptive ``ImportError`` only when
actually called without pandas installed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import INCLUSIVE_BIT
from repro_torch.query.database import Database


def _pandas():
    try:
        import pandas as pd
    except ImportError as e:  # pragma: no cover - exercised via tests' skip
        raise ImportError(
            "to_dataframe() needs pandas, which is not installed; "
            "`pip install pandas` (the query engine itself does not "
            "require it)") from e
    return pd


def metric_label(db: Database, mid: int) -> str:
    """Human column label for a metric id: registry name when available,
    the numeric id otherwise; ``:I`` marks the propagated inclusive
    variant (mirrors :meth:`Database.resolve_metric`'s name syntax)."""
    if db.registry is not None:
        try:
            return db.registry.name_of(int(mid))
        except KeyError:
            pass
    base = str(int(mid) & ~INCLUSIVE_BIT)
    return base + (":I" if int(mid) & INCLUSIVE_BIT else "")


def to_dataframe(db: Database, *, stat: str = "sum",
                 include_inclusive: bool = True):
    """Export the database's per-context metric summaries as a dataframe.

    One row per context that carries data, indexed by full call path, with
    ``ctx``/``name``/``depth`` structure columns and one column per metric
    holding the cross-profile ``stat`` (inclusive variants as ``<m>:I``
    columns unless ``include_inclusive=False``).  Built entirely from the
    summary-statistics section — no plane reads, see the counters.
    """
    pd = _pandas()
    ctxs = np.asarray(db.stats["ctx"], dtype=np.int64)
    mids = np.asarray(db.stats["mid"], dtype=np.int64)
    vals = np.asarray(db.stats[stat], dtype=np.float64)
    if not include_inclusive:
        keep = (mids & INCLUSIVE_BIT) == 0
        ctxs, mids, vals = ctxs[keep], mids[keep], vals[keep]

    labels = {int(m): metric_label(db, int(m)) for m in np.unique(mids)}
    long = pd.DataFrame({
        "ctx": ctxs,
        "metric": [labels[int(m)] for m in mids],
        "value": vals,
    })
    wide = long.pivot_table(index="ctx", columns="metric", values="value",
                            aggfunc="sum", fill_value=0.0)
    wide.columns.name = None

    tree = db.tree
    parent = np.asarray(tree.parent, dtype=np.int64)
    depth = np.zeros(parent.size, dtype=np.int64)
    for c in range(1, parent.size):       # parents precede children by id
        depth[c] = depth[parent[c]] + 1
    idx = wide.index.to_numpy()
    wide.insert(0, "depth", depth[idx])
    wide.insert(0, "name", [tree.name_of(int(c)) for c in idx])
    wide.insert(0, "ctx", idx)
    wide.index = pd.Index([db.path_of(int(c)) for c in idx], name="path")
    return wide
