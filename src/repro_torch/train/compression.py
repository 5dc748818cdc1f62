"""Gradient compression for the slow cross-pod hop.

Port of :mod:`repro.train.compression`.  Two error-feedback schemes:

* **top-k** — keep the k largest-magnitude entries, carry the remainder in
  a residual that is added back next time;
* **block int8** — the hand-written ``int8_quant`` kernel
  (``csrc/int8_quant.cu``; block-scaled symmetric quantization), whose
  quantization error is the residual.

:func:`compressed_psum_pod` is the collective: each rank quantizes its
tensor to int8 in fixed blocks of 2048, all ranks all-gather the int8
values and the per-block scales (about a quarter of the bytes of an f32
all-reduce), and each dequantizes and averages locally.  The reference
does this inside a ``shard_map`` over the mesh's ``pod`` axis; here the
ranks are the members of a ``torch.distributed`` process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import int8_quant as _q8
from repro_torch.kernels import ops as kops

PSUM_BLOCK = 2048  # the reference's fixed wire block, never clamped


# -- error-feedback top-k ------------------------------------------------------

def topk_compress(g: torch.Tensor, frac: float, residual: torch.Tensor):
    """Returns ``((idx, vals, n), new_residual)``; g and residual flat f32."""
    g = g + residual
    n = g.shape[0]
    k = max(int(n * frac), 1)
    _, idx = torch.topk(g.abs(), k)
    picked = g[idx]
    dense = torch.zeros_like(g).index_put_((idx,), picked)
    return (idx, picked, n), g - dense


def topk_decompress(payload, n: int) -> torch.Tensor:
    idx, vals, _ = payload
    return torch.zeros(n, dtype=vals.dtype,
                       device=vals.device).index_put_((idx,), vals)


# -- error-feedback int8 -------------------------------------------------------

def int8_compress(g: torch.Tensor, residual: torch.Tensor):
    """Returns ``((q, scales), err)``: the payload of ``g + residual`` and
    the quantization error, the next call's residual."""
    q, scales, err = kops.int8_quant(g + residual)
    return (q, scales), err


def int8_decompress(payload, n: int) -> torch.Tensor:
    q, scales = payload
    return kops.int8_dequant(q, scales, n)


# -- compressed cross-pod all-reduce ------------------------------------------

def compressed_psum_pod(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` (default: the world), f32,
    with int8 on the wire.  Wire bytes per rank: n (q) + 4 per 2048-value block
    (scale), against 4n for an f32 all-reduce.  Every rank gets the same
    result; it is within ``amax / 127`` of the exact mean, where ``amax`` is
    the largest magnitude in any rank's block."""
    npods = dist.get_world_size(group)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    q, scale, _ = _q8.int8_quant(flat.contiguous(), PSUM_BLOCK)
    qg = [torch.empty_like(q) for _ in range(npods)]
    sg = [torch.empty_like(scale) for _ in range(npods)]
    dist.all_gather(qg, q, group=group)          # int8 on the wire
    dist.all_gather(sg, scale, group=group)
    qs = torch.nn.functional.pad(torch.stack(qg), (0, (-n) % PSUM_BLOCK))
    deq = (qs.float().view(npods, -1, PSUM_BLOCK)
           * torch.stack(sg)[..., None]).sum(dim=0) / npods
    return deq.reshape(-1)[:n].reshape(x.shape)
