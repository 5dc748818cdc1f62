"""Context-Major Sparse (CMS) analysis-results format (paper §3.2, §4.3.2).

Same sparse 3-tensor as PMS, ordered context-major: an array of context
offsets (exclusive scan over per-context plane sizes) followed by one CSR
plane per non-empty context::

    plane(ctx) = mids u16[m], mstart u64[m+1], prof u32[x], vals f64[x]

A (ctx, metric) "stripe" — the values of one metric for *all* profiles — is
a single contiguous read, which is the access pattern CMS exists to serve.

The builder follows paper §4.3.2: CMS is generated *from the completed PMS
file*; sizes are known, so offsets come from an exclusive scan, and workers
each assemble contiguous context groups and write at precomputed offsets
without coordination.  Both the faithful **heap-merge** per-group gather and
the **vectorized transpose** (sort by (ctx, mid, profile)) are implemented;
they produce byte-identical planes.

With ``compute="device"`` the size census and the offset scan run on the
port's ``histogram`` and ``blockscan`` kernels (on the CUDA card, or their
plain versions with ``device="cpu"``); both are exact integer operations,
so the file bytes never depend on the backend.  The workers that gather
planes run in-process (``serial``/``threads``: GLB dynamic assignment) or
in worker processes (``processes``/``ranks``: static contiguous shards of
context groups); the census and the offsets always run in the caller's
process, so gather workers launch no kernel.
"""
from __future__ import annotations

import heapq
import os
import struct

import numpy as np

from repro_torch.core import loadbalance
from repro_torch.core.pms import PMSReader
from repro_torch.utils import binio

CMS_MAGIC = b"RCMS"
_HEADER = 24

# exact plane size for m non-empty metrics and x values (binio 1-D block = 13 + data)
def plane_nbytes(m: int, x: int) -> int:
    return 60 + 10 * m + 12 * x if x else 0


def _encode_plane(mids, mstart, prof, vals) -> bytes:
    return (binio.pack_array(mids) + binio.pack_array(mstart)
            + binio.pack_array(prof) + binio.pack_array(vals))


def empty_plane():
    """The canonical shape of a context with no data."""
    return (np.empty(0, np.uint16), np.zeros(1, np.uint64),
            np.empty(0, np.uint32), np.empty(0, np.float64))


def decode_plane(buf) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Wire format -> ``(mids, mstart, prof, vals)``; the single decoder
    shared by :class:`CMSReader` and the query engine's mmap path."""
    mids, off = binio.unpack_array(buf, 0)
    mstart, off = binio.unpack_array(buf, off)
    prof, off = binio.unpack_array(buf, off)
    vals, off = binio.unpack_array(buf, off)
    return mids, mstart, prof, vals


def stripe_from_plane(plane, mid: int) -> tuple[np.ndarray, np.ndarray]:
    """Slice one metric's (profiles, values) stripe out of a decoded plane."""
    mids, mstart, prof, vals = plane
    j = int(np.searchsorted(mids, mid))
    if j >= mids.size or mids[j] != mid:
        return np.empty(0, np.uint32), np.empty(0, np.float64)
    a, b = int(mstart[j]), int(mstart[j + 1])
    return prof[a:b], vals[a:b]


def stripe_from_buffer(buf, off: int, mid: int
                       ) -> tuple[np.ndarray, np.ndarray] | None:
    """Predicate-pushdown stripe read: decode ONE metric's (profiles,
    values) slice from an encoded plane at ``buf[off:]`` without
    materializing the other metrics.

    Only the tiny ``mids``/``mstart`` header arrays are parsed; the metric
    is binary-searched, and the matching sub-ranges of the ``prof`` and
    ``vals`` blocks are returned as zero-copy views over ``buf`` (the page
    cache, when ``buf`` is an mmap).  Returns ``None`` when the plane does
    not carry ``mid`` — the caller learns the predicate failed for the
    price of the header alone, never the plane.
    """
    mids, pos = binio.unpack_array(buf, off)
    mstart, pos = binio.unpack_array(buf, pos)
    j = int(np.searchsorted(mids, mid))
    if j >= mids.size or int(mids[j]) != int(mid):
        return None
    a, b = int(mstart[j]), int(mstart[j + 1])
    x = int(mstart[-1])
    # prof block (u32[x]) starts at pos; vals block (f64[x]) right after.
    # Each 1-D binio array block is a 13-byte header + payload (see
    # plane_nbytes); slice the [a, b) sub-range of each payload directly.
    # The dtype codes guard the hardcoded layout: a format drift must fail
    # loudly here, never mis-slice silently.
    if bytes(buf[pos:pos + 4]) != b"u32 ":
        raise ValueError("CMS plane layout drift: prof block is not u32")
    prof = np.frombuffer(buf, np.uint32, count=b - a, offset=pos + 13 + 4 * a)
    vals_block = pos + 13 + 4 * x
    if bytes(buf[vals_block:vals_block + 4]) != b"f64 ":
        raise ValueError("CMS plane layout drift: vals block is not f64")
    vals = np.frombuffer(buf, np.float64, count=b - a,
                         offset=vals_block + 13 + 8 * a)
    return prof, vals


# ---------------------------------------------------------------------------
# pass 1: size census over the PMS planes
# ---------------------------------------------------------------------------

def census(pms: PMSReader, n_ctx: int, compute: str = "device",
           device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-context (x_c, m_c): total values and distinct non-empty metrics.

    ``compute="device"`` counts x_c with the ``histogram`` kernel on
    ``device`` (int64 counts: byte-identical to the numpy count).  The
    concatenated row ids are int32 below 2^31 contexts, as the reference
    hands them to its kernel, so the copy to the card is half as large.
    """
    key_chunks: list[np.ndarray] = []
    uniq = np.empty(0, dtype=np.uint64)
    row_chunks: list[np.ndarray] = []
    row_type = np.int32 if n_ctx < 2 ** 31 else np.int64
    for pid in range(pms.n_profiles):
        sm = pms.plane(pid)
        rows = np.repeat(sm.ctx.astype(row_type),
                         np.diff(sm.start.astype(np.int64)))
        if rows.size == 0:
            continue
        row_chunks.append(rows)
        key_chunks.append((rows.astype(np.uint64) << np.uint64(16)) | sm.mid.astype(np.uint64))
        if sum(k.size for k in key_chunks) > 1 << 22:
            uniq = np.unique(np.concatenate([uniq] + key_chunks))
            key_chunks = []
    if key_chunks:
        uniq = np.unique(np.concatenate([uniq] + key_chunks))
    rows_all = (np.concatenate(row_chunks) if row_chunks
                else np.empty(0, row_type))
    if compute == "device":
        from repro_torch.kernels import batch
        x_c = batch.device_census_counts(rows_all, n_ctx, device)
    else:
        x_c = np.bincount(rows_all, minlength=n_ctx).astype(np.int64)
    m_c = np.bincount((uniq >> np.uint64(16)).astype(np.int64), minlength=n_ctx)
    return x_c, m_c.astype(np.int64)


# ---------------------------------------------------------------------------
# pass 2: per-group gather (two strategies)
# ---------------------------------------------------------------------------

def _gather_group_vectorized(pms: PMSReader, lo: int, hi: int) -> dict[int, bytes]:
    """Transpose by sort (the reference's DESIGN.md §4)."""
    rs, ms, ps, vs = [], [], [], []
    for pid in range(pms.n_profiles):
        sm = pms.plane(pid)
        k0, k1 = np.searchsorted(sm.ctx, [lo, hi])
        if k0 == k1:
            continue
        i0, i1 = int(sm.start[k0]), int(sm.start[k1])
        rows = np.repeat(sm.ctx[k0:k1].astype(np.int64),
                         np.diff(sm.start[k0:k1 + 1].astype(np.int64)))
        rs.append(rows)
        ms.append(sm.mid[i0:i1].astype(np.int64))
        ps.append(np.full(i1 - i0, pid, dtype=np.int64))
        vs.append(sm.val[i0:i1])
    out: dict[int, bytes] = {}
    if not rs:
        return out
    rows = np.concatenate(rs); mids = np.concatenate(ms)
    pids = np.concatenate(ps); vals = np.concatenate(vs)
    order = np.lexsort((pids, mids, rows))
    rows, mids, pids, vals = rows[order], mids[order], pids[order], vals[order]
    ctx_bounds = np.flatnonzero(np.diff(rows, prepend=-1))
    ctx_ends = np.append(ctx_bounds[1:], rows.size)
    for b, e in zip(ctx_bounds, ctx_ends):
        out[int(rows[b])] = _encode_ctx_plane(mids[b:e], pids[b:e], vals[b:e])
    return out


def _encode_ctx_plane(mids, pids, vals) -> bytes:
    mb = np.flatnonzero(np.diff(mids, prepend=-1))
    umids = mids[mb].astype(np.uint16)
    mstart = np.append(mb, mids.size).astype(np.uint64)
    return _encode_plane(umids, mstart, pids.astype(np.uint32), vals.astype(np.float64))


def _gather_group_heap(pms: PMSReader, lo: int, hi: int) -> dict[int, bytes]:
    """Faithful heap-merge over profiles (paper §4.3.2)."""
    planes = []
    heap: list[tuple[int, int]] = []
    cursors = {}
    for pid in range(pms.n_profiles):
        sm = pms.plane(pid)
        k0, k1 = np.searchsorted(sm.ctx, [lo, hi])
        if k0 == k1:
            continue
        planes.append((pid, sm))
        cursors[pid] = (int(k0), int(k1), sm)
        heapq.heappush(heap, (int(sm.ctx[k0]), pid))
    out: dict[int, bytes] = {}
    acc_m: list[np.ndarray] = []
    acc_p: list[np.ndarray] = []
    acc_v: list[np.ndarray] = []
    cur_ctx = -1

    def flush():
        if cur_ctx < 0 or not acc_m:
            return
        mids = np.concatenate(acc_m); pids = np.concatenate(acc_p)
        vals = np.concatenate(acc_v)
        order = np.lexsort((pids, mids))
        out[cur_ctx] = _encode_ctx_plane(mids[order], pids[order], vals[order])

    while heap:
        ctx, pid = heapq.heappop(heap)
        if ctx != cur_ctx:
            flush()
            acc_m, acc_p, acc_v = [], [], []
            cur_ctx = ctx
        k0, k1, sm = cursors[pid]
        i0, i1 = int(sm.start[k0]), int(sm.start[k0 + 1])
        acc_m.append(sm.mid[i0:i1].astype(np.int64))
        acc_p.append(np.full(i1 - i0, pid, dtype=np.int64))
        acc_v.append(sm.val[i0:i1])
        k0 += 1
        cursors[pid] = (k0, k1, sm)
        if k0 < k1:
            heapq.heappush(heap, (int(sm.ctx[k0]), pid))
    flush()
    return out


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _cms_shard_worker(task) -> int:
    """Out-of-process CMS gather: one worker, one contiguous run of groups.

    Offsets are *not* shipped with the task — the parent has already
    written the header + offset table to the output file, so the worker
    re-reads them from there (the §4.3.2 property: once sizes are known,
    workers coordinate through precomputed offsets alone).  Returns the
    number of planes written (progress/debug only).
    """
    pms_path, out_path, strategy, groups = task
    pms = PMSReader(pms_path)
    f = open(str(out_path), "r+b")
    fd = f.fileno()
    head = os.pread(fd, _HEADER, 0)
    assert head[:4] == CMS_MAGIC, "CMS header not yet written"
    (n_ctx,) = struct.unpack_from("<Q", head, 8)
    raw = os.pread(fd, 8 * (int(n_ctx) + 1), _HEADER)
    offsets = np.frombuffer(raw, dtype=np.uint64)
    gather = (_gather_group_vectorized if strategy == "vectorized"
              else _gather_group_heap)
    written = 0
    for lo, hi in groups:
        planes = gather(pms, lo, hi)
        if not planes:
            continue
        buf = b"".join(planes[c] for c in sorted(planes))
        os.pwrite(fd, buf, int(offsets[min(planes)]))
        written += len(planes)
    f.close()
    pms.close()
    return written


def _shard_groups(groups, sizes: np.ndarray, n_workers: int):
    """Contiguous size-balanced split of groups across workers (static LB:
    dynamic assignment cannot cross address spaces without a server)."""
    gsz = np.array([int(np.sum(sizes[lo:hi])) for lo, hi in groups],
                   dtype=np.int64)
    csum = np.cumsum(gsz)
    total = int(csum[-1]) if gsz.size else 0
    shards: list[list[tuple[int, int]]] = [[] for _ in range(n_workers)]
    for g, grp in enumerate(groups):
        w = (min(int((csum[g] - 1) * n_workers // max(total, 1)),
                 n_workers - 1) if total else 0)
        shards[w].append(grp)
    return [s for s in shards if s]


def build_cms(pms_path, out_path, *, n_workers: int = 4, strategy: str = "vectorized",
              balance: str = "dynamic", group_target_bytes: int = 1 << 20,
              executor: str | None = None, compute: str = "device",
              device="cuda") -> int:
    """Generate the CMS file from a completed PMS file (paper §4.3.2).

    ``executor`` selects the worker substrate (default ``threads``):
    in-process backends run the gather workers through their own
    ``parallel_for`` (GLB dynamic assignment; ``serial`` drains every group
    inline), out-of-process backends (``processes``, ``ranks``) shard
    context groups statically across a worker pool, which starts with
    ``spawn`` when ``compute="device"`` (the census may have put CUDA in
    this process).  Output bytes land at offsets fixed by the exclusive
    scan, so every substrate produces a byte-identical file.

    ``compute="device"`` runs the census histogram and the §4.3.2 offset
    scan through the port's kernels on ``device``; both are exact integer
    ops, so the file bytes never depend on the backend.
    """
    pms = PMSReader(pms_path)
    n_ctx = len(pms.tree.parent) if pms.tree is not None else (
        int(max((int(pms.plane(p).ctx.max()) for p in range(pms.n_profiles)
                 if pms.plane(p).n_contexts), default=-1)) + 1)
    x_c, m_c = census(pms, n_ctx, compute=compute, device=device)
    sizes = np.where(x_c > 0, 60 + 10 * m_c + 12 * x_c, 0).astype(np.int64)
    offsets = np.zeros(n_ctx + 1, dtype=np.uint64)
    if compute == "device":
        from repro_torch.kernels import batch
        offsets[:] = batch.device_offsets(sizes, device)  # int64 blockscan
    else:
        np.cumsum(sizes, out=offsets[1:])  # exclusive scan (paper §4.3.2)
    data_start = _HEADER + 8 * (n_ctx + 1)
    offsets += np.uint64(data_start)

    groups = loadbalance.make_groups(sizes, group_target_bytes)
    gather = _gather_group_vectorized if strategy == "vectorized" else _gather_group_heap

    from repro_torch.runtime import executor_for
    ex = executor_for(executor or "threads", n_workers, compute)

    f = open(str(out_path), "w+b")
    fd = f.fileno()
    f.write(CMS_MAGIC + struct.pack("<I", 1))
    f.write(struct.pack("<QQ", n_ctx, 0))
    f.write(offsets.tobytes())
    f.flush()  # workers use positional pwrites from here on

    if not ex.in_process:
        tasks = [(str(pms_path), str(out_path), strategy, shard)
                 for shard in _shard_groups(groups, sizes, n_workers)]
        with ex:
            for _ in ex.map_unordered(_cms_shard_worker, tasks):
                pass
    else:
        assigner = loadbalance.make_assigner(balance, groups, sizes, n_workers)

        def worker(w: int):
            # every worker opens its own reader: no shared file positions
            wpms = PMSReader(pms_path)
            while True:
                g = assigner.next_group(w)
                if g is None:
                    break
                lo, hi = g
                planes = gather(wpms, lo, hi)
                if not planes:
                    continue
                # group planes are contiguous: one buffer, one pwrite
                buf = b"".join(planes[c] for c in sorted(planes))
                os.pwrite(fd, buf, int(offsets[min(planes)]))
            wpms.close()

        with ex:
            ex.parallel_for(n_workers, worker)

    meta_off = int(offsets[-1])
    blob = binio.pack_json({"n_profiles": pms.n_profiles,
                            "registry": pms.meta.get("registry", [])})
    os.pwrite(fd, blob, meta_off)
    os.pwrite(fd, struct.pack("<Q", meta_off), 16)
    f.truncate(meta_off + len(blob))
    f.close()
    pms.close()
    return meta_off + len(blob)


class CMSReader:
    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "rb")
        self._fd = self._f.fileno()
        head = os.pread(self._fd, _HEADER, 0)
        assert head[:4] == CMS_MAGIC, "not a CMS file"
        self.n_ctx, self.meta_off = struct.unpack_from("<QQ", head, 8)
        self.n_ctx = int(self.n_ctx)
        raw = os.pread(self._fd, 8 * (self.n_ctx + 1), _HEADER)
        self.offsets = np.frombuffer(raw, dtype=np.uint64)
        blob = os.pread(self._fd, os.fstat(self._fd).st_size - int(self.meta_off),
                        int(self.meta_off))
        self.meta, _ = binio.unpack_json(blob, 0)

    def plane(self, ctx: int):
        """(mids, mstart, prof, vals) for one context; empty if no data."""
        lo, hi = int(self.offsets[ctx]), int(self.offsets[ctx + 1])
        if lo == hi:
            return empty_plane()
        return decode_plane(os.pread(self._fd, hi - lo, lo))

    def stripe(self, ctx: int, mid: int) -> tuple[np.ndarray, np.ndarray]:
        """All (profile, value) pairs of one metric for one context —
        the contiguous read CMS is designed for (paper §3.2)."""
        return stripe_from_plane(self.plane(ctx), mid)

    def query(self, ctx: int, mid: int, pid: int) -> float:
        prof, vals = self.stripe(ctx, mid)
        k = int(np.searchsorted(prof, pid))
        if k < prof.size and prof[k] == pid:
            return float(vals[k])
        return 0.0

    def nbytes(self) -> int:
        return os.fstat(self._fd).st_size

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
