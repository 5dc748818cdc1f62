"""The composite operations the port calls, over the kernels.

Counterparts of ``repro.kernels.ops``' ``exclusive_scan``, ``histogram``,
``inclusive_from_exclusive``, ``int8_quant`` and ``int8_dequant``.  The
reference's block clamps and padding are TPU tiling rules, and the CUDA
kernels take any shape, with one exception: ``int8_quant``'s clamp decides
the quantization blocks, so it is kept to give the reference's payloads.
Every function runs the CUDA kernels on CUDA tensors and their plain
versions on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import blockscan as _bs
from repro_torch.kernels import int8_quant as _q8
from repro_torch.kernels import scatter_add as _sc


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive scan with the total appended: (N,) -> (N+1,); the CMS
    stripe offsets."""
    inc = _bs.blockscan(x)
    return torch.cat([torch.zeros((1,) + tuple(x.shape[1:]), dtype=inc.dtype,
                                  device=inc.device), inc])


def histogram(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 counts of each id in ``[0, num_segments)``; the CMS census."""
    if _build.on_cuda(ids):
        return _sc.histogram_cuda(ids, num_segments)
    return _sc.histogram_plain(ids, num_segments)


def inclusive_from_exclusive(dense_preorder: torch.Tensor,
                             end: torch.Tensor) -> torch.Tensor:
    """``inclusive[i] = cumsum[end[i]] - cumsum[i]`` over preorder values
    (N, M): the preorder-interval propagation (paper §4.1.2).  The scan is
    the kernel; the gather and difference are glue."""
    inc = _bs.blockscan(dense_preorder)
    ps = torch.cat([torch.zeros((1, dense_preorder.shape[1]), dtype=inc.dtype,
                                device=inc.device), inc])
    return ps[end] - ps[:-1]


LANE = 128  # the reference's TPU lane multiple, kept for int8_quant's clamp


def _clamp_block(requested: int, n: int, align: int) -> int:
    """The reference's block clamp (``repro.kernels.ops._clamp_block``):
    ``min(requested, max(align, n))`` rounded up to ``align``."""
    b = min(int(requested), max(align, int(n)))
    return max(align, -(-b // align) * align)


def int8_quant(x: torch.Tensor, block_n: int = _q8.DEFAULT_BLOCK_N):
    """Block-scaled int8 quantization of a 1-D tensor: ``(q, scales, err)``
    with ``q``/``err`` of its length, in the reference's blocks."""
    x = x.reshape(-1).to(torch.float32).contiguous()
    return _q8.int8_quant(x, _clamp_block(block_n, x.numel(), LANE))


def int8_dequant(q: torch.Tensor, scales: torch.Tensor, n: int,
                 block_n: int = _q8.DEFAULT_BLOCK_N) -> torch.Tensor:
    """Invert :func:`int8_quant`: ``q`` are the first ``n`` quantized
    values, ``scales`` one f32 per block; the same ``n`` gives the same
    clamped ``block_n``."""
    block_n = _clamp_block(block_n, n, LANE)
    npad = scales.shape[0] * block_n
    pad = npad - q.shape[0]
    if pad < 0:
        raise ValueError(
            f"int8_dequant: {q.shape[0]} quantized values exceed the "
            f"capacity of {scales.shape[0]} scale blocks x block_n="
            f"{block_n} ({npad}); scales/block_n do not match the "
            f"int8_quant call that produced them")
    qp = torch.nn.functional.pad(q, (0, pad)) if pad else q
    return _q8.int8_dequant(qp, scales, block_n)[:n]
