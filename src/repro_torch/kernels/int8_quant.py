"""Block-scaled symmetric int8 quantization: the ``int8_quant`` kernel.

Port of :mod:`repro.kernels.int8_quant` (``int8_quant_pallas``), with the
zero padding of its wrapper ``ops.int8_quant`` folded in.  For each block
of ``block_n`` values of a 1-D f32 ``x``, a ragged last block padded with
zeros:

* ``scale = amax * INV_127`` if ``amax = max|x| > 0``, else 1 (a NaN in
  the block makes ``amax`` NaN and so ``scale`` 1, as in the reference);
* ``q = int8(clip(round_half_even(x / scale), -127, 127))``, NaN -> 0;
* ``err = x - q * scale`` rounded once.

That is the reference as XLA runs it, bit for bit: XLA multiplies by the
f32 reciprocal of 127 where the source divides, and contracts the residual
into an FMA (``csrc/int8_quant.cu``).  ``q`` and ``err`` have ``len(x)``
values, ``scales`` one per block.

:func:`int8_quant` launches the hand-written CUDA kernel on a CUDA tensor
and runs :func:`int8_quant_plain` on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_N = 2048
# the f32 nearest 1/127; csrc/int8_quant.cu's kInv127 is the same constant
INV_127 = float.fromhex("0x1.020408p-7")


def _blocks(n: int, block_n: int) -> int:
    if block_n <= 0:
        raise ValueError(f"int8_quant: block_n {block_n} must be positive")
    return -(-n // block_n)


def int8_quant(x: torch.Tensor, block_n: int = DEFAULT_BLOCK_N):
    """``(q int8 (N,), scales f32 (ceil(N / block_n),), err f32 (N,))``."""
    if _build.on_cuda(x):
        return int8_quant_cuda(x, block_n)
    return int8_quant_plain(x, block_n)


def int8_quant_cuda(x: torch.Tensor, block_n: int = DEFAULT_BLOCK_N):
    """The CUDA kernel; ``x`` 1-D f32 and contiguous on a card."""
    if not _build.on_cuda(x):
        raise ValueError("int8_quant_cuda takes a CUDA tensor")
    _build.expect(x, "int8_quant input", (torch.float32,), (1,))
    n = x.numel()
    block_n = int(block_n)
    nb = _blocks(n, block_n)
    if block_n >= 2 ** 31 or nb >= 2 ** 31:
        raise ValueError(f"int8_quant: {nb} blocks of {block_n} exceed the "
                         f"kernel's 32-bit grid")
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    err = torch.empty_like(x)
    fn = _build.function("int8_quant", "int8_quant_f32",
                         (_build.PTR, _build.I64, _build.I32, _build.PTR,
                          _build.PTR, _build.PTR, _build.PTR))
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), n, block_n, q.data_ptr(),
                    scales.data_ptr(), err.data_ptr(), _build.stream_of(x))
    _build.check(status, "int8_quant")
    if nb:
        _build.launch_counts.add("int8_quant")
    return q, scales, err


def int8_quant_plain(x: torch.Tensor, block_n: int = DEFAULT_BLOCK_N):
    """The same function in plain PyTorch.  The residual is taken in f64,
    where ``q * scale`` (8 x 24 significant bits) and then ``x - q * scale``
    are exact, and rounded once to f32: the FMA's result."""
    x = x.reshape(-1).float()
    n = x.numel()
    nb = _blocks(n, int(block_n))
    xb = torch.nn.functional.pad(x, (0, nb * block_n - n)).view(nb, block_n)
    amax = xb.abs().amax(dim=1) if nb else xb.new_zeros(0)
    inv = torch.tensor(INV_127, dtype=torch.float32, device=x.device)
    scales = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    r = torch.round(xb / scales[:, None]).clamp(-127, 127)
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    err = (xb.double() - q.double() * scales.double()[:, None]).float()
    return q.view(-1)[:n], scales, err.view(-1)[:n]


def int8_dequant(q: torch.Tensor, scales: torch.Tensor,
                 block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """``q * scale`` per block; ``q`` holds whole blocks."""
    return (q.float().reshape(-1, block_n) * scales[:, None]).reshape(-1)
