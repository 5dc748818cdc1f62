"""Metric propagation & placeholder redistribution (paper §4.1.2-4.1.3).

The measurement subsystem records only *exclusive* costs.  Analysis derives
*inclusive* costs by propagating exclusive values to every ancestor.

Scan formulation: with the unified CCT linearized in DFS preorder, a
node's subtree is the contiguous interval ``[i, end[i])``, so for a dense
preorder value vector ``v``::

    inclusive[i] = cumsum(v)[end[i]] - cumsum(v)[i]   (exclusive-prefix cumsum)

One streaming pass instead of a recursive walk; batched over the (few)
metrics a profile actually observed.  The ``blockscan`` kernel
(``csrc/blockscan.cu``) runs the cumsum on the card for the fused pipeline
(:mod:`repro_torch.core.pipeline`); this module is the numpy engine of the
legacy three-pass chain, which is the fused pipeline's byte oracle.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import INCLUSIVE_BIT
from repro_torch.core.sparse import SparseMetrics


def propagate_inclusive(
    metrics: SparseMetrics,
    pos: np.ndarray,
    end: np.ndarray,
    *,
    keep_exclusive: bool = True,
) -> SparseMetrics:
    """Exclusive -> exclusive+inclusive for one profile.

    ``pos``/``end`` come from ``ContextTree.preorder()`` of the *unified*
    tree; ``metrics`` must already be remapped onto unified context ids.
    Inclusive values are emitted under ``mid | INCLUSIVE_BIT`` for every
    context with a non-zero subtree sum.
    """
    n = pos.size
    rows, mids, vals = metrics.triplets()
    if rows.size == 0:
        return metrics
    prof_mids = np.unique(mids)
    m = prof_mids.size
    col_of = np.zeros(int(prof_mids.max()) + 1, dtype=np.int64)
    col_of[prof_mids] = np.arange(m)

    dense = np.zeros((n, m), dtype=np.float64)
    dense[pos[rows], col_of[mids]] = vals
    # exclusive-prefix cumsum: ps[i] = sum(dense[:i])
    ps = np.zeros((n + 1, m), dtype=np.float64)
    np.cumsum(dense, axis=0, out=ps[1:])
    order_idx = np.arange(n)
    incl = ps[end] - ps[order_idx]  # (n, m) inclusive values per preorder slot

    ir, ic = np.nonzero(incl)
    # map preorder slot back to context id: pos is a permutation; invert it
    inv = np.empty(n, dtype=np.int64)
    inv[pos] = np.arange(n)
    out_rows = [inv[ir]]
    out_mids = [prof_mids[ic] | INCLUSIVE_BIT]
    out_vals = [incl[ir, ic]]
    if keep_exclusive:
        out_rows.append(rows)
        out_mids.append(mids)
        out_vals.append(vals)
    return SparseMetrics.from_triplets(
        np.concatenate(out_rows), np.concatenate(out_mids), np.concatenate(out_vals)
    )


def propagate_inclusive_reference(
    metrics: SparseMetrics, parent: np.ndarray, *, keep_exclusive: bool = True
) -> SparseMetrics:
    """Naive per-node walk (the paper's recursive formulation) — test oracle."""
    rows, mids, vals = metrics.triplets()
    out: dict[tuple[int, int], float] = {}
    for r, m, v in zip(rows, mids, vals):
        node = int(r)
        while node != -1:
            key = (node, int(m) | INCLUSIVE_BIT)
            out[key] = out.get(key, 0.0) + float(v)
            node = int(parent[node])
        if keep_exclusive:
            key = (int(r), int(m))
            out[key] = out.get(key, 0.0) + float(v)
    if not out:
        return metrics
    ks = np.array([k for k in out], dtype=np.int64)
    vs = np.array([out[tuple(k)] for k in ks], dtype=np.float64)
    return SparseMetrics.from_triplets(ks[:, 0], ks[:, 1], vs)


def redistribute_placeholders(
    metrics: SparseMetrics,
    routes: dict[int, tuple[np.ndarray, np.ndarray]],
) -> SparseMetrics:
    """GPU-context-reconstruction redistribution (paper §4.1.3).

    ``routes`` maps a placeholder context id ("in superposition") to
    ``(leaf_ctx_ids, weights)``; the placeholder's costs are split across the
    reconstructed leaf contexts proportionally to observed/approximated call
    counts, before inclusive propagation so the split costs flow up their
    full reconstructed call paths.
    """
    if not routes:
        return metrics
    rows, mids, vals = metrics.triplets()
    is_ph = np.isin(rows, np.fromiter(routes.keys(), dtype=np.int64))
    leaf_ctx, e_lens, norm_w = expand_routes(rows[is_ph], routes)
    return SparseMetrics.from_triplets(
        np.concatenate([rows[~is_ph], leaf_ctx]),
        np.concatenate([mids[~is_ph], np.repeat(mids[is_ph], e_lens)]),
        np.concatenate([vals[~is_ph], np.repeat(vals[is_ph], e_lens) * norm_w]),
    )


def expand_routes(
    ph_rows: np.ndarray, routes: dict[int, tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized route-expansion core, shared with the fused pipeline.

    For placeholder context ids ``ph_rows`` (stream order, duplicates
    allowed), returns ``(leaf_ctx, lens, norm_w)``: the flattened route
    targets per entry, each entry's target count, and the per-route
    normalized weights gathered per target — one ``np.repeat``/
    ``np.concatenate`` pass instead of a Python loop per placeholder row.
    Per-element arithmetic matches the historical loop — the caller applies
    ``value * norm_w`` where ``norm_w = w / w.sum()`` — and expansion order
    is (entry order, then route order), so downstream summation order is
    unchanged.
    """
    ph_ids = np.fromiter(routes.keys(), dtype=np.int64)
    targets = [np.asarray(routes[int(c)][0], dtype=np.int64) for c in ph_ids]
    weights = [np.asarray(routes[int(c)][1], dtype=np.float64) for c in ph_ids]
    weights = [w / w.sum() for w in weights]
    lens = np.array([t.size for t in targets], dtype=np.int64)
    flat_tgt = np.concatenate(targets) if targets else np.empty(0, np.int64)
    flat_w = np.concatenate(weights) if weights else np.empty(0, np.float64)
    route_off = np.concatenate([[0], np.cumsum(lens)])

    order = np.argsort(ph_ids, kind="stable")
    ridx = order[np.searchsorted(ph_ids[order], ph_rows)]
    e_lens = lens[ridx]
    total = int(e_lens.sum())
    starts = np.repeat(route_off[ridx], e_lens)
    local = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(e_lens)])[:-1], e_lens)
    gather = starts + local
    return flat_tgt[gather], e_lens, flat_w[gather]
