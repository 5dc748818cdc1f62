"""The plain reference's shared layers: float32 PyTorch, TF32 off, no
kernel, cache or chunking of the program.  Every matrix product goes
through a ``mm`` that the caller picks: :func:`mm_f32` for the reference,
:func:`mm_fp8` for the control (both operands rounded to float8 e4m3 with
a per-tensor scale, the incoming gradient to e5m2, accumulation in f32).

Imports torch alone: nothing of the program, nothing of JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def no_tf32() -> None:
    """A float32 product on the card is a full float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``fmax``, back in x's dtype."""
    s = fmax / x.detach().abs().amax().clamp_min(1e-30)
    return (x * s).to(dtype).to(x.dtype) / s


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = _fp8(a, torch.float8_e4m3fn, 448.0)
        bq = _fp8(b, torch.float8_e4m3fn, 448.0)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2, 57344.0)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        if bq.dim() == 2 and aq.dim() > 2:     # a weight shared over rows
            gb = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            gb = torch.matmul(aq.transpose(-1, -2), gq)
        return ga, gb


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: ``a @ b`` in float8 (module docstring)."""
    return _FP8MatMul.apply(a, b)


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0..S-1; the two halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, mm, q0: int):
    """Causal softmax attention of queries ``q0..q0+len(q)-1`` over keys
    ``0..len(k)-1``: q (b, s, H, hd), k and v (b, t, H, hd)."""
    s_, t, hd = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))        # (b,H,*,hd)
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    causal = (torch.arange(t, device=q.device)[None, :]
              <= q0 + torch.arange(s_, device=q.device)[:, None])
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(p, vh).transpose(1, 2)                            # (b,s,H,hd)


def causal_attention(q, k, v, mm, rows: int = 2, budget: int = 1 << 31):
    """q (B, S, H, hd); k, v (B, S, KVH, hd), head h reading kv head
    h // (H / KVH).  Blocks of ``rows`` batch rows and of as many queries
    as keep one block's f32 scores within ``budget`` bytes, each
    recomputed in the backward pass, so that one block's scores exist at a
    time."""
    B, S, H, _ = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    qb = max(1, min(S, budget // (min(rows, B) * H * S * 4)))
    outs = []
    for i in range(0, B, rows):
        outs.append(torch.cat([
            checkpoint(_attend, q[i:i + rows, q0:q0 + qb], k[i:i + rows, :q0 + qb],
                       v[i:i + rows, :q0 + qb], mm, q0, use_reentrant=False)
            for q0 in range(0, S, qb)], dim=1))
    return torch.cat(outs, dim=0)


def glu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def _xent_chunk(x, w, labels, mm):
    logits = mm(x, w)
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, labels[..., None])[..., 0]).sum()


def next_token_xent(x, w, tokens, mm, chunk: int = 256):
    """Mean cross-entropy of each next token: labels ``tokens`` shifted by
    one, the last position left out; the logits of ``chunk`` positions at
    a time, recomputed in the backward pass."""
    B, S = tokens.shape
    labels = tokens[:, 1:].long()
    xs = x[:, :S - 1]
    tot = x.new_zeros(())
    for i in range(0, S - 1, chunk):
        tot = tot + checkpoint(_xent_chunk, xs[:, i:i + chunk], w,
                               labels[:, i:i + chunk], mm, use_reentrant=False)
    return tot / (B * (S - 1))


def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int,
               hp: dict) -> None:
    """One AdamW step as the configuration states it: moments and the
    update in float32, the global gradient norm clipped to
    ``grad_clip``, the learning rate warmed up linearly on ``step``,
    weight decay inside the update and multiplied by the rate, and each
    parameter stored back in its own dtype.  In place."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(hp["grad_clip"] / torch.clamp_min(gnorm, 1e-9), max=1.0)
    lr = hp["lr"] * min(step / max(hp["warmup_steps"], 1), 1.0)
    b1, b2 = hp["b1"], hp["b2"]
    b1c, b2c = 1.0 - b1 ** step, 1.0 - b2 ** step
    for n, p in params.items():
        g = grads[n] * scale
        m[n] = b1 * m[n] + (1 - b1) * g
        v[n] = b2 * v[n] + (1 - b2) * g * g
        p32 = p.float()
        delta = (m[n] / b1c) / (torch.sqrt(v[n] / b2c) + hp["eps"]) \
            + hp["weight_decay"] * p32
        params[n] = (p32 - lr * delta).to(p.dtype)
