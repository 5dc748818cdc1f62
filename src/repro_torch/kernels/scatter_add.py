"""Scatter-add over unsorted ids, and its histogram: the ``scatter_add``
kernels.

Port of :mod:`repro.kernels.scatter_add` (``scatter_add_pallas``) and its
wrappers ``ops.scatter_add``/``ops.histogram``.  Ids outside ``[0, S)`` are
dropped.

* :func:`scatter_add` — ``out[s, :] = sum(vals[ids == s, :])`` in f32.  On a
  card the port's own stable radix sort orders the rows by id (a count, a
  ``blockscan`` of the count table and a stable scatter a pass), each
  segment's bounds come from its neighbours' keys, and each segment's rows
  are added in ascending row order (long segments in fixed chunks, added
  in chunk order), so the result depends on that segment's rows alone and
  no float atomics are used (``csrc/scatter_add.cu``).
* :func:`histogram_cuda`/:func:`histogram_plain` — per-id counts in int64,
  behind :func:`repro_torch.kernels.ops.histogram`.  Integer atomics are
  exact, so the reference's 2^24 f32-count guard is gone.  One launch
  zeroes the counts behind a barrier and adds each run of equal
  neighbouring ids once; its barrier counters live in a buffer per (card,
  stream), zeroed once (:class:`_Barrier`).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_ID_TYPES = (torch.int32, torch.int64)
# (rows a radix tile, digit bits a pass, rows a reduce chunk): the
# constants of csrc/scatter_add.cu, checked against the library's own
_LAYOUT = (2048, 9, 128)
_layout_checked = False
_fns: dict = {}


def scatter_add(ids: torch.Tensor, vals: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(S,) for (N,) ``vals``, (S, M) for (N, M)."""
    if _build.on_cuda(ids, vals):
        return scatter_add_cuda(ids, vals, num_segments)
    return scatter_add_plain(ids, vals, num_segments)


def _check_ids(ids: torch.Tensor, num_segments: int, what: str) -> int:
    _build.expect(ids, f"{what} ids", _ID_TYPES, (1,))
    s = int(num_segments)
    if s < 0:
        raise ValueError(f"{what}: negative num_segments {s}")
    return s


def radix_plan(n: int, num_segments: int) -> tuple[tuple, int]:
    """``(passes, tiles)`` of the radix sort over ``n`` ids into
    ``num_segments`` segments: one ``(shift, bits)`` a pass, 9 bits a pass
    over the ``ceil(log2(S + 1))`` bits that keys in ``[0, S]`` use, and
    the count of ``kTile``-row tiles.  Raises ``ValueError`` past the
    kernels' 32-bit keys, rows and offsets."""
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"scatter_add: {n} ids; the CUDA kernel takes "
                         f"fewer than 2^31")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"scatter_add: num_segments {num_segments} outside "
                         f"[0, 2^31)")
    tile, max_bits, _ = _LAYOUT
    key_bits = max(1, int(num_segments).bit_length())
    passes = tuple((shift, min(max_bits, key_bits - shift))
                   for shift in range(0, key_bits, max_bits))
    return passes, -(-n // tile)


def _check_layout() -> None:
    """Raise unless the library's constants are ``_LAYOUT``; once."""
    global _layout_checked
    if not _layout_checked:
        buf = (ctypes.c_int64 * 3)()
        _build.function("scatter_add", "scatter_add_layout", (_build.PTR,),
                        None)(ctypes.addressof(buf))
        if tuple(buf) != _LAYOUT:
            raise RuntimeError(f"scatter_add.cu's layout {tuple(buf)} is "
                               f"not {_LAYOUT}")
        _layout_checked = True


class _Scratch:
    """One int32 buffer a (card, stream), grown at need and carved into the
    sort's keys and rows (two of each), its count table, the segment
    offsets and the chunk sums; ``lock`` keeps one call's launches
    together."""

    def __init__(self, device):
        self.device = device
        self.buf = torch.empty(0, dtype=torch.int32, device=device)
        self.lock = threading.Lock()

    def carve(self, sizes: list[int]) -> list[torch.Tensor]:
        aligned = [-(-k // 64) * 64 for k in sizes]  # 256-byte aligned
        need = sum(aligned)
        if self.buf.numel() < need:
            self.buf = torch.empty(max(need, 2 * self.buf.numel()),
                                   dtype=torch.int32, device=self.device)
        out, at = [], 0
        for k, a in zip(sizes, aligned):
            out.append(self.buf[at:at + k])
            at += a
        return out


_scratch: dict[tuple[int, int], _Scratch] = {}
_scratch_lock = threading.Lock()


def _scratch_for(device: int, stream: int) -> _Scratch:
    key = (device, stream)
    sc = _scratch.get(key)
    if sc is None:
        with _scratch_lock:
            sc = _scratch.setdefault(key, _Scratch(torch.device("cuda",
                                                                device)))
    return sc


def _fn(name: str, argtypes: tuple):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.function("scatter_add", name, argtypes)
    return fn


_P, _I, _L = _build.PTR, ctypes.c_int, _build.I64
_COUNT_ARGS = (_P, _L, _L, _I, _I, _I, _P, _P)
_SCATTER_ARGS = (_P, _P, _L, _L, _I, _I, _I, _P, _P, _P, _P)
_SEGSUM_ARGS = (_P, _P, _P, _L, _L, _L, _P, _P, _P, _P)


def scatter_add_cuda(ids: torch.Tensor, vals: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """The CUDA scatter-add: ids int32 or int64 in any order, ``vals`` f32
    (N,) or (N, M), contiguous.  Launches, on the current stream: a count,
    a ``blockscan`` down its (tiles, 512) table and a stable scatter for
    each radix pass (two at S = 196,049), then the segment bounds, the
    long segments' chunk sums and the segment sums: nine launches at the
    census shape."""
    if not _build.on_cuda(ids, vals):
        raise ValueError("scatter_add_cuda takes CUDA tensors")
    s = _check_ids(ids, num_segments, "scatter_add")
    _build.expect(vals, "scatter_add vals", (torch.float32,), (1, 2))
    if vals.shape[0] != ids.shape[0]:
        raise ValueError(f"scatter_add: {ids.shape[0]} ids for "
                         f"{vals.shape[0]} value rows")
    n = ids.shape[0]
    m = 1 if vals.dim() == 1 else vals.shape[1]
    passes, tiles = radix_plan(n, s)
    _check_layout()
    out = torch.empty((s,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    if s == 0 or m == 0:
        return out
    device = ids.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device != torch._C._cuda_getDevice():
        with torch.cuda.device(device):
            return _scatter_add(ids, vals, n, m, s, passes, tiles, device,
                                stream, out)
    return _scatter_add(ids, vals, n, m, s, passes, tiles, device, stream,
                        out)


def _scatter_add(ids, vals, n, m, s, passes, tiles, device, stream, out):
    from repro_torch.kernels import blockscan as bs
    chunk = _LAYOUT[2]
    buckets = 1 << max(bits for _, bits in passes)
    sc = _scratch_for(device, stream)
    with sc.lock:
        keys_a, keys_b, rows_a, rows_b, table, off, chunks = sc.carve(
            [n, n, n, n, buckets * tiles, s + 1, (n // chunk + 1) * m])
        keys, rows = ids, None
        suffix = "i32" if ids.dtype == torch.int32 else "i64"
        for shift, bits in (passes if n else ()):
            counts = table[:tiles << bits].view(tiles, 1 << bits)
            _build.check(_fn(f"radix_count_{suffix}", _COUNT_ARGS)(
                keys.data_ptr(), n, s, shift, bits, tiles, counts.data_ptr(),
                stream), "scatter_add count")
            scanned = bs.blockscan_cuda(counts)
            _build.check(_fn(f"radix_scatter_{suffix}", _SCATTER_ARGS)(
                keys.data_ptr(), rows.data_ptr() if rows is not None else None,
                n, s, shift, bits, tiles, scanned.data_ptr(),
                keys_a.data_ptr(), rows_a.data_ptr(), stream),
                "scatter_add scatter")
            keys, rows, suffix = keys_a, rows_a, "u32"
            keys_a, keys_b, rows_a, rows_b = keys_b, keys_a, rows_b, rows_a
        ptr = (lambda t: t.data_ptr() if n else None)
        _build.check(_fn("segsum_f32", _SEGSUM_ARGS)(
            ptr(keys), ptr(rows), vals.data_ptr(), n, m, s, off.data_ptr(),
            chunks.data_ptr(), out.data_ptr(), stream), "scatter_add")
    _build.launch_counts.add("scatter_add")
    return out


def scatter_add_plain(ids: torch.Tensor, vals: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The same function in plain PyTorch."""
    s = int(num_segments)
    ids = ids.long()
    keep = (ids >= 0) & (ids < s)
    out = torch.zeros((s,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, ids[keep], vals[keep].float())


class _Barrier:
    """The histogram's zeroing barrier on one stream (``csrc/
    scatter_add.cu``): ``sync`` holds two (claims, done) counter pairs,
    zero when allocated; call k uses pair k % 2 and zeroes the other for
    call k + 1.  ``calls`` counts the calls enqueued on the stream, under
    ``lock``."""

    def __init__(self, device):
        self.sync = torch.zeros(4, dtype=torch.int64, device=device)
        self.calls = 0
        self.lock = threading.Lock()


_barriers: dict[tuple[int, int], _Barrier] = {}
_hist_layout: tuple | None = None  # histogram_layout(), read once a process
_HIST_ARGS = (_P, _L, _L, _P, _P, _I, _L, _I, _P)


def _histogram_layout() -> tuple[int, int, int]:
    """``(vectors a tile, counts a zeroing chunk, blocks the card holds at
    once)`` from the library, once."""
    global _hist_layout
    if _hist_layout is None:
        buf = (ctypes.c_int64 * 3)()
        _build.check(_build.function("scatter_add", "histogram_layout",
                                     (_build.PTR,))(ctypes.addressof(buf)),
                     "histogram_layout")
        _hist_layout = tuple(buf)
    return _hist_layout


def histogram_plan(n: int, num_segments: int, itemsize: int, address: int,
                   layout: tuple[int, int, int]) -> tuple[int, int]:
    """``(grid, zero_chunks)`` of the histogram launch over ``n`` ids of
    ``itemsize`` bytes at ``address`` into ``num_segments`` counts, for
    ``layout = (vectors a tile, counts a zeroing chunk, blocks the card
    holds at once)``.  Tiles are counted in 16-byte vectors from the
    boundary at or below ``address``; the grid is a block a tile or a
    zeroing chunk, whichever is more, and at most what the card holds at
    once.  Grid 0 (no launch) for ``num_segments == 0``."""
    tile, chunk, resident = layout
    if num_segments == 0:
        return 0, 0
    per_vector = 16 // itemsize
    vectors = -(-(n + (address % 16) // itemsize) // per_vector) if n else 0
    chunks = -(-num_segments // chunk)
    return min(resident, max(-(-vectors // tile), chunks)), chunks


def histogram_cuda(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The CUDA histogram: int64 counts of int32 or int64 ids (contiguous,
    any alignment), ids outside ``[0, num_segments)`` dropped.  One launch
    on the current stream zeroes the counts and counts; none for
    ``num_segments == 0``."""
    if ids.device.type != "cuda":
        raise ValueError("histogram_cuda takes a CUDA tensor")
    s = _check_ids(ids, num_segments, "histogram")
    counts = torch.empty(s, dtype=torch.int64, device=ids.device)
    n = ids.shape[0]
    grid, chunks = histogram_plan(n, s, ids.element_size(), ids.data_ptr(),
                                  _histogram_layout())
    if grid == 0:
        return counts
    fn = _fn("histogram_i32" if ids.dtype == torch.int32 else "histogram_i64",
             _HIST_ARGS)
    device = ids.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    key = (device, stream)
    bar = _barriers.get(key)
    if bar is None:
        with _scratch_lock:
            bar = _barriers.setdefault(key, _Barrier(ids.device))
    with bar.lock:
        args = (ids.data_ptr(), n, s, counts.data_ptr(), bar.sync.data_ptr(),
                bar.calls & 1, chunks, grid, stream)
        if device == torch._C._cuda_getDevice():
            status = fn(*args)
        else:
            with torch.cuda.device(device):
                status = fn(*args)
        if status == 0:
            bar.calls += 1
        else:  # whether the kernel ran is unknown: start a fresh barrier
            _barriers.pop(key, None)
    if status < 0:
        raise RuntimeError(f"histogram: the plan ({grid} blocks, {chunks} "
                           f"zeroing chunks) disagrees with the library")
    _build.check(status, "histogram")
    _build.launch_counts.add("histogram")
    return counts


def histogram_plain(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The same function in plain PyTorch."""
    s = int(num_segments)
    ids = ids.long()
    keep = (ids >= 0) & (ids < s)
    return torch.bincount(ids[keep], minlength=s)[:s]
