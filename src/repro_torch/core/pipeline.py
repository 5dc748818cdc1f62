"""Fused phase-2 kernel: remap + redistribute + propagate + assemble in one
pass over a single sorted triplet buffer.

The legacy hot path re-materializes every profile three times::

    remap_contexts          -> from_triplets  (argsort #1)
    redistribute_placeholders -> from_triplets  (argsort #2)
    propagate_inclusive     -> dense (n_ctx x m) cumsum -> from_triplets (#3)

:func:`fused_transform` produces the **byte-identical** ``SparseMetrics``
with one stable argsort over the remapped triplet stream, inclusive values
computed by sparse segment sums over preorder intervals (``searchsorted`` on
``end``), and the final plane assembled by a linear two-stream merge — no
third sort, and no O(n_ctx x m) matrix unless density warrants it.

Bit-identity argument (the executor parity contract rides on this):

* duplicate (ctx, metric) keys are summed left-to-right in stable-sorted
  key order — exactly ``SparseMetrics.from_triplets``'s ``argsort(stable)``
  + ``add.at`` order.  Collapsing the legacy path's two combine passes into
  one is exact: the first pass sums each key's duplicates left-to-right and
  the second appends route contributions after the kept value, which is the
  same total order the single stable sort produces (non-placeholder entries
  precede route expansions in the concatenated stream);
* inclusive values are differences of prefix sums taken in preorder
  position order.  The legacy dense cumsum interleaves ``+0.0`` terms for
  empty positions; IEEE-754 guarantees ``x + 0.0 == x`` bit-for-bit unless
  ``x`` is ``-0.0``, and partial sums of stored (non-zero) values can
  produce ``+0.0`` but never ``-0.0`` — so the sparse prefix sum over only
  the non-empty positions is bitwise the same;
* the inclusive stream comes out ordered by (position, metric) — the same
  row-major order ``np.nonzero`` yields on the dense matrix — and inclusive
  keys (bit 15 set) never collide with exclusive keys, so the final legacy
  ``from_triplets`` is a pure merge of two sorted streams: reproduced here
  with two ``searchsorted`` scatters instead of an argsort.

The dense fallback (high observed density) runs the cumsum formulation on
the fused exclusive stream; both branches are bit-identical, so the cutoff
is a pure performance knob that cannot perturb output bytes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import INCLUSIVE_BIT
from repro_torch.core.propagate import (expand_routes, propagate_inclusive,
                                        redistribute_placeholders)
from repro_torch.core.sparse import (CTX_DTYPE, IDX_DTYPE, MID_DTYPE, VAL_DTYPE,
                                     SparseMetrics)
from repro_torch.core.stats import check_key_ranges

_KEY_SHIFT = 16

# use the dense (n_ctx x m) cumsum when the profile touches at least this
# fraction of the unified tree (the ancestor closure would approach n_ctx
# anyway), or when the matrix is trivially small
DENSE_FRACTION = 0.25
DENSE_SMALL = 4096


def _combine_sorted(keys: np.ndarray, vals: np.ndarray):
    """Stable-sort ``ctx << 16 | mid`` keys, sum duplicate keys left-to-right
    and drop zero sums — ``from_triplets``'s exact FP accumulation order.

    ``bincount(weights=...)`` accumulates strictly sequentially over the
    sorted stream — bit-identical to the ``np.add.at`` the legacy path uses
    (``np.add.reduceat`` is *not*: it sums segments pairwise).
    """
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    flags = np.diff(keys, prepend=-1) != 0
    ukeys = keys[flags]
    seg = np.cumsum(flags) - 1
    sums = np.bincount(seg, weights=vals, minlength=ukeys.size) if vals.size \
        else vals
    keep = sums != 0.0
    return ukeys[keep], sums[keep]


def _expand_route_keys(ph_keys: np.ndarray, ph_vals: np.ndarray, routes: dict):
    """Placeholder redistribution (paper §4.1.3) on packed keys.

    ``ph_keys`` are combined placeholder entries in ascending key order (the
    order the legacy path iterates them); each expands to its route's leaf
    contexts with the per-route normalized weights applied to the combined
    value — ``v * (w / w.sum())`` per element, the legacy arithmetic.
    """
    leaf_ctx, e_lens, norm_w = expand_routes(ph_keys >> _KEY_SHIFT, routes)
    r_mid = np.repeat(ph_keys & 0xFFFF, e_lens)
    r_vals = np.repeat(ph_vals, e_lens) * norm_w
    return leaf_ctx * (1 << _KEY_SHIFT) + r_mid, r_vals


def _inclusive_sparse(ectx, evals, col, m, prof_mids, parent, end):
    """Per-interval inclusive sums without densifying to (n_ctx x m).

    Candidates are the ancestor closure of the touched preorder positions —
    the only contexts whose interval ``[i, end[i])`` can contain a non-zero;
    per metric column, a prefix sum over the (position-sorted) non-zeros
    gives ``inclusive = csum[searchsorted(end)] - csum[searchsorted(i)]``.
    """
    n = end.size
    mark = np.zeros(n, dtype=bool)
    frontier = np.unique(ectx)
    mark[frontier] = True
    while frontier.size:
        p = parent[frontier]
        p = p[p >= 0]
        if p.size:
            p = np.unique(p)
            p = p[~mark[p]]
        if p.size == 0:
            break
        mark[p] = True
        frontier = p
    cand = np.flatnonzero(mark)

    # group entries by metric column; masking by boolean class preserves the
    # ascending-position order within each column (entries are ctx-sorted)
    grp = np.argsort(col, kind="stable")
    counts = np.bincount(col, minlength=m)
    cstart = np.concatenate([[0], np.cumsum(counts)])
    incl = np.empty((cand.size, m), dtype=np.float64)
    endc = end[cand]
    for c in range(m):
        seg = grp[cstart[c]:cstart[c + 1]]
        pc = ectx[seg]
        csum = np.concatenate([[0.0], np.cumsum(evals[seg])])
        lo = np.searchsorted(pc, cand, side="left")
        hi = np.searchsorted(pc, endc, side="left")
        incl[:, c] = csum[hi] - csum[lo]
    ir, ic = np.nonzero(incl)
    ikeys = cand[ir] * (1 << _KEY_SHIFT) + (prof_mids[ic] | INCLUSIVE_BIT)
    return ikeys, incl[ir, ic]


def _combine_sorted_device(keys: np.ndarray, vals: np.ndarray, device):
    """Device formulation of :func:`_combine_sorted`: the stable argsort
    stays on the CPU (it defines the dense ranks), the duplicate-key
    segment sums run on the ``segstats`` kernel in f32 (exact for
    "exact"-class planes — see repro_torch.kernels.batch's dtype contract)."""
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    flags = np.diff(keys, prepend=-1) != 0
    ukeys = keys[flags]
    seg = (np.cumsum(flags) - 1).astype(np.int32)
    sums = device.combine_sums(seg, vals.astype(np.float32))
    keep = sums != 0.0
    return ukeys[keep], sums[keep]


def _inclusive_device(ectx, evals, col, m, prof_mids, end, device):
    """Inclusive propagation on device: densify the combined exclusive
    stream to (n, m) f32 and batch it through the blockscan launch — the
    cumsum formulation of :func:`_inclusive_dense`, with f32 accumulation
    (byte-identical for "exact"-class planes, documented f32 rounding
    otherwise)."""
    n = end.size
    dense = np.zeros((n, m), dtype=np.float32)
    dense[ectx, col] = evals  # combined keys are unique: plain assignment
    incl = device.inclusive(dense)
    ir, ic = np.nonzero(incl)
    ikeys = ir.astype(np.int64) * (1 << _KEY_SHIFT) \
        + (prof_mids[ic] | INCLUSIVE_BIT)
    return ikeys, incl[ir, ic].astype(np.float64)


def _inclusive_dense(ectx, evals, col, m, prof_mids, end):
    """The legacy cumsum formulation, on the fused exclusive stream."""
    n = end.size
    dense = np.zeros((n, m), dtype=np.float64)
    dense[ectx, col] = evals
    ps = np.zeros((n + 1, m), dtype=np.float64)
    np.cumsum(dense, axis=0, out=ps[1:])
    incl = ps[end] - ps[np.arange(n)]
    ir, ic = np.nonzero(incl)
    ikeys = ir * (1 << _KEY_SHIFT) + (prof_mids[ic] | INCLUSIVE_BIT)
    return ikeys, incl[ir, ic]


def _assemble(keys: np.ndarray, vals: np.ndarray) -> SparseMetrics:
    """Key-sorted triplets -> the CSR plane, ``from_triplets``'s exact tail."""
    if keys.size == 0:
        return SparseMetrics.empty()
    ctx = keys >> _KEY_SHIFT
    bounds = np.flatnonzero(np.diff(ctx, prepend=-1))
    starts = np.concatenate([bounds, [ctx.size]]).astype(IDX_DTYPE)
    return SparseMetrics(
        ctx[bounds].astype(CTX_DTYPE), starts,
        (keys & 0xFFFF).astype(MID_DTYPE), vals.astype(VAL_DTYPE, copy=False),
    )


def transform_plane(
    metrics: SparseMetrics,
    remap: np.ndarray,
    routes: dict,
    parent: np.ndarray,
    end: np.ndarray,
    *,
    pipeline: str = "fused",
    keep_exclusive: bool = True,
    device=None,
) -> SparseMetrics:
    """The one phase-2 transform dispatch, shared by every executor path
    (in-process bodies, sharded workers, the ranks driver).

    The cross-executor byte-parity contract requires all paths to run the
    exact same transform for a given config — routing them through this
    helper makes divergence structurally impossible.  ``device`` (a
    :class:`repro_torch.kernels.batch.DeviceAggregator` or None) selects the
    ``compute="device"`` backend; it requires the fused pipeline.
    """
    if pipeline == "fused":
        return fused_transform(metrics, remap, routes, parent, end,
                               keep_exclusive=keep_exclusive, device=device)
    if device is not None:
        raise ValueError("device compute requires pipeline='fused'")
    sm = metrics.remap_contexts(np.asarray(remap, dtype=np.int64))
    if routes:
        sm = redistribute_placeholders(sm, routes)
    return propagate_inclusive(sm, np.arange(end.size), end,
                               keep_exclusive=keep_exclusive)


def fused_transform(
    metrics: SparseMetrics,
    remap: np.ndarray,
    routes: dict,
    parent: np.ndarray,
    end: np.ndarray,
    *,
    keep_exclusive: bool = True,
    device=None,
) -> SparseMetrics:
    """Remap + redistribute + propagate + assemble one profile's plane.

    ``remap`` maps profile-local context ids to final *preorder* ids;
    ``routes`` maps placeholder preorder ids to ``(leaf_preorder_ids,
    weights)``; ``parent``/``end`` describe the unified tree in preorder
    space.  Returns bytes-identical output to the legacy chain
    ``propagate_inclusive(redistribute_placeholders(remap_contexts(...)))``.

    With ``device`` set (:class:`repro_torch.kernels.batch.DeviceAggregator`),
    the combine's segment sums (large planes) and the inclusive propagation
    dispatch to the port's kernels under that module's per-plane dtype
    contract; everything else — and the decision *what* to offload — is a
    pure function of the plane, preserving cross-executor byte parity.
    """
    rows, mids, vals = metrics.triplets()
    if rows.size == 0:
        return SparseMetrics.empty()
    rows = np.asarray(remap, dtype=np.int64)[rows]
    # loud failure instead of silent key corruption: bit 15 of a raw mid is
    # INCLUSIVE_BIT, and huge remapped ctx ids would wrap the int64 keys
    check_key_ranges(rows, mids)
    keys = rows * (1 << _KEY_SHIFT) + mids

    if routes:
        ph_ids = np.fromiter(routes.keys(), dtype=np.int64)
        is_ph = np.isin(rows, ph_ids)
        # placeholder entries combine *before* weighting — (v1+v2)*w, the
        # legacy order — then expand; everything else stays a raw stream
        ph_keys, ph_vals = _combine_sorted(keys[is_ph], vals[is_ph])
        r_keys, r_vals = _expand_route_keys(ph_keys, ph_vals, routes)
        keys = np.concatenate([keys[~is_ph], r_keys])
        vals = np.concatenate([vals[~is_ph], r_vals])

    # the one big argsort: raw remapped stream (+ route expansions) -> the
    # combined exclusive plane, sorted by (ctx, mid) key
    if device is not None and device.wants_combine(keys.size):
        ekeys, evals = _combine_sorted_device(keys, vals, device)
    else:
        ekeys, evals = _combine_sorted(keys, vals)
    if ekeys.size == 0:
        return SparseMetrics.empty()

    ectx = (ekeys >> _KEY_SHIFT).astype(np.int64)
    emid = (ekeys & 0xFFFF).astype(np.int64)
    prof_mids = np.unique(emid)
    m = prof_mids.size
    col = np.searchsorted(prof_mids, emid)

    n = end.size
    if device is not None:
        ikeys, ivals = _inclusive_device(ectx, evals, col, m, prof_mids, end,
                                         device)
        return _assemble_final(ekeys, evals, ikeys, ivals, keep_exclusive)
    u = np.count_nonzero(np.diff(ectx, prepend=-1))  # distinct touched ctxs
    if n * m <= DENSE_SMALL or u >= max(1, int(n * DENSE_FRACTION)):
        ikeys, ivals = _inclusive_dense(ectx, evals, col, m, prof_mids, end)
    else:
        ikeys, ivals = _inclusive_sparse(ectx, evals, col, m, prof_mids,
                                         np.asarray(parent, np.int64), end)
    return _assemble_final(ekeys, evals, ikeys, ivals, keep_exclusive)


def _assemble_final(ekeys, evals, ikeys, ivals, keep_exclusive: bool
                    ) -> SparseMetrics:
    if not keep_exclusive:
        return _assemble(ikeys, ivals)

    # linear merge of the two key-sorted streams (no collisions: bit 15)
    na, nb = ekeys.size, ikeys.size
    fkeys = np.empty(na + nb, dtype=np.int64)
    fvals = np.empty(na + nb, dtype=np.float64)
    ia = np.arange(na) + np.searchsorted(ikeys, ekeys)
    ib = np.arange(nb) + np.searchsorted(ekeys, ikeys)
    fkeys[ia], fvals[ia] = ekeys, evals
    fkeys[ib], fvals[ib] = ikeys, ivals
    return _assemble(fkeys, fvals)
