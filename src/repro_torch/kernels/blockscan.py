"""Inclusive prefix sum along axis 0: the ``blockscan`` kernel.

Port of :mod:`repro.kernels.blockscan` (``blockscan_pallas``) and its
wrapper ``ops.blockscan``: (N,) or row-major (N, M) in f32, f64, int32 or
int64, scanned down each column, in the input's type.  f32 input is
accumulated in f64 and each prefix rounded once to f32, so every prefix is
within half an ulp and a difference of two prefixes over an all-zero run
is exactly 0.  A column's result depends only on that
column and on N, never on the other columns of the launch or on timing
(see ``csrc/blockscan.cu``), which is what keeps batched f32 planes
bit-identical however the funnel groups them.

:func:`blockscan` launches the hand-written CUDA kernel on CUDA tensors and
runs :func:`blockscan_plain` on CPU tensors.  The kernel is one launch; it
keeps its ticket and flags in a buffer per (card, stream) that is zeroed
once when allocated and never reset (calls are told their number on it
instead), and its totals in a second one, so a call makes one ctypes call
and allocates only its output.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.int32: "i32", torch.int64: "i64"}
_DTYPES = tuple(_SUFFIX)
# the type the sums are carried in (the input's own, except f32)
_ACC = {torch.float32: torch.float64}
_ERRORS = {-1: "scratch too small for the shape",
           -2: "more tiles than one grid may hold"}

_layout: tuple | None = None      # blockscan_layout(), read once a process
_fns: dict = {}                   # dtype -> the launcher, its C signature set


class _Scratch:
    """The kernel's scratch on one stream (``csrc/blockscan.cu``): ``sync``,
    zeroed once, holds the ticket counter and the flags, ``data`` the
    totals.  Calls are numbered (``tag``) and their blocks, one ticket
    each, counted (``base``) in the order they are enqueued on the stream,
    under ``lock``."""

    def __init__(self, sync_words: int, data_words: int, device):
        self.sync = torch.zeros(sync_words, dtype=torch.int64, device=device)
        self.data = torch.empty(data_words, dtype=torch.int64, device=device)
        self.tag = 0
        self.base = 0
        self.lock = threading.Lock()

    def fits(self, sync_words: int, data_words: int) -> bool:
        return (self.sync.numel() >= sync_words
                and self.data.numel() >= data_words)


# (device index, stream handle) -> its _Scratch
_scratch: dict[tuple[int, int], _Scratch] = {}
_scratch_lock = threading.Lock()


def blockscan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 of (N,) or (N, M)."""
    if _build.on_cuda(x):
        return blockscan_cuda(x)
    return blockscan_plain(x)


def _constants() -> tuple:
    """``(header words, tile columns, tile rows by element size, column
    rows by dtype, chunks a super-chunk covers)`` from the library,
    once."""
    global _layout
    if _layout is None:
        buf = (ctypes.c_int64 * 7)()
        _build.function("blockscan", "blockscan_layout", (_build.PTR,),
                        None)(ctypes.addressof(buf))
        _layout = (buf[0], buf[1], {4: buf[2], 8: buf[3]},
                   {torch.int32: buf[4], torch.int64: buf[5]}, buf[6])
    return _layout


@functools.lru_cache(maxsize=256)
def plan(n: int, m: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """``(blocks, sync words, data words)`` of a launch on (n, m) of
    ``dtype``: a block per tile; the header and one flag per tile, plus
    for tiles one per super-chunk and column tile; one total per chunk and
    column, plus for tiles one per super-chunk and column."""
    header, tile_cols, tile_rows, column_rows, per_super = _constants()
    if m == 1 and dtype in column_rows:
        chunks = -(-n // column_rows[dtype])
        return chunks, header + chunks, chunks
    chunks = -(-n // tile_rows[dtype.itemsize])
    col_tiles = -(-m // tile_cols)
    supers = chunks // per_super
    blocks = chunks * col_tiles
    return (blocks, header + blocks + supers * col_tiles,
            (chunks + supers) * m)


def _scratch_for(device: int, stream: int, sync_words: int,
                 data_words: int) -> _Scratch:
    key = (device, stream)
    sc = _scratch.get(key)
    if sc is None or not sc.fits(sync_words, data_words):
        with _scratch_lock:
            sc = _scratch.get(key)
            if sc is None or not sc.fits(sync_words, data_words):
                if sc is not None:  # grow both, at least twofold
                    sync_words = max(sync_words, 2 * sc.sync.numel())
                    data_words = max(data_words, 2 * sc.data.numel())
                sc = _Scratch(sync_words, data_words,
                              torch.device("cuda", device))
                _scratch[key] = sc
    return sc


def _launcher(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = _build.function("blockscan", f"blockscan_{_SUFFIX[dtype]}",
                             (_build.PTR, _build.I64, _build.I64, _build.PTR,
                              _build.I64, _build.PTR, _build.I64,
                              ctypes.c_uint64, ctypes.c_uint64, _build.PTR,
                              _build.PTR))
        _fns[dtype] = fn
    return fn


def blockscan_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: one launch; ``x`` contiguous on a card, of a type
    in ``_SUFFIX``."""
    if x.device.type != "cuda":
        raise ValueError("blockscan_cuda takes a CUDA tensor")
    _build.expect(x, "blockscan input", _DTYPES, (1, 2))
    out = torch.empty_like(x)
    n = x.shape[0]
    m = 1 if x.dim() == 1 else x.shape[1]
    if n == 0 or m == 0:
        return out
    fn = _launcher(x.dtype)
    device = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    blocks, sync_words, data_words = plan(n, m, x.dtype)
    sc = _scratch_for(device, stream, sync_words, data_words)
    name = f"blockscan_{_SUFFIX[x.dtype]}"
    with sc.lock:
        args = (x.data_ptr(), n, m, sc.sync.data_ptr(), sc.sync.numel(),
                sc.data.data_ptr(), sc.data.numel(), sc.tag + 1, sc.base,
                out.data_ptr(), stream)
        if device == torch._C._cuda_getDevice():
            status = fn(*args)
        else:
            with torch.cuda.device(device):
                status = fn(*args)
        if status == 0:
            sc.tag += 1
            sc.base += blocks
        else:  # whether the kernel ran is unknown: start a fresh scratch
            _scratch.pop((device, stream), None)
    if status < 0:
        raise RuntimeError(f"{name}: {_ERRORS[status]} ({n} x {m})")
    _build.check(status, name)
    _build.launch_counts.add(name)
    return out


def blockscan_plain(x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, with the same accumulation
    type."""
    return torch.cumsum(x, dim=0, dtype=_ACC.get(x.dtype, x.dtype)).to(x.dtype)
