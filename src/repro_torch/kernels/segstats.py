"""Segmented statistics over sorted segment ids: the ``segstats`` kernel.

Port of :mod:`repro.kernels.segstats` (``segstats_pallas``) together with
its wrapper's empty-segment finalisation.  For ids sorted ascending (int32)
and f32 values, row ``s`` of the (S, 8) f32 result is
``[sum, count, min, max, sumsq, 0, 0, 0]`` over ``vals[ids == s]``; ids
outside ``[0, S)`` are sentinels and contribute nothing, and empty segments
are all zero.

:func:`segstats` launches the hand-written CUDA kernel
(``csrc/segstats.cu``: one launch, one coalesced pass in which each run is
found from its neighbours' ids and summed in an order fixed by the run
alone) on CUDA tensors and runs :func:`segstats_plain` on CPU tensors.  A
segment holding a NaN has NaN sum, min, max and sumsq; a sentinel's value
reaches no segment.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

N_STATS = 8

_fn = None  # the launcher, its C signature set


def _launcher():
    global _fn
    if _fn is None:
        _fn = _build.function("segstats", "segstats_f32",
                              (_build.PTR, _build.PTR, _build.I64,
                               _build.I32, _build.PTR, _build.PTR))
    return _fn


def segstats(ids: torch.Tensor, vals: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """(S, 8) ``[sum, cnt, min, max, sumsq, 0, 0, 0]`` per segment."""
    if _build.on_cuda(ids, vals):
        return segstats_cuda(ids, vals, num_segments)
    return segstats_plain(ids, vals, num_segments)


def segstats_cuda(ids: torch.Tensor, vals: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """The CUDA kernel.  ``ids`` int32 sorted ascending, ``vals`` f32, both
    1-D, contiguous and of one length on one card."""
    if not _build.on_cuda(ids, vals):
        raise ValueError("segstats_cuda takes CUDA tensors")
    _build.expect(ids, "segstats ids", (torch.int32,), (1,))
    _build.expect(vals, "segstats vals", (torch.float32,), (1,))
    if ids.shape != vals.shape:
        raise ValueError(f"segstats: ids {tuple(ids.shape)} and vals "
                         f"{tuple(vals.shape)} differ in length")
    s = int(num_segments)
    if not 0 <= s < 2 ** 31:
        raise ValueError(f"segstats: num_segments {s} outside [0, 2^31)")
    out = torch.empty((s, N_STATS), dtype=torch.float32, device=ids.device)
    if s == 0:
        return out
    device = ids.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    args = (ids.data_ptr(), vals.data_ptr(), ids.numel(), s, out.data_ptr(),
            stream)
    if device == torch._C._cuda_getDevice():
        status = _launcher()(*args)
    else:
        with torch.cuda.device(device):
            status = _launcher()(*args)
    _build.check(status, "segstats")
    _build.launch_counts.add("segstats")
    return out


def segstats_plain(ids: torch.Tensor, vals: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """The same function in plain PyTorch: the reference the kernel is
    held against, and what CPU tensors run."""
    s = int(num_segments)
    ids = ids.long()
    vals = vals.float()
    keep = (ids >= 0) & (ids < s)
    sid, v = ids[keep], vals[keep]
    zeros = torch.zeros(s, dtype=torch.float32, device=vals.device)
    total = zeros.clone().index_add_(0, sid, v)
    cnt = zeros.clone().index_add_(0, sid, torch.ones_like(v))
    sumsq = zeros.clone().index_add_(0, sid, v * v)
    vmin = torch.full_like(zeros, float("inf")).scatter_reduce_(
        0, sid, v, "amin")
    vmax = torch.full_like(zeros, float("-inf")).scatter_reduce_(
        0, sid, v, "amax")
    empty = cnt == 0
    vmin[empty] = 0.0
    vmax[empty] = 0.0
    return torch.stack([total, cnt, vmin, vmax, sumsq, zeros, zeros, zeros],
                       dim=1)
