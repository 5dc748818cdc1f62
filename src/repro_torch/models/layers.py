"""Shared model layers: RMS norm, RoPE, chunked (flash-style) attention,
single-step decode attention over a KV cache, GLU MLPs, sinusoidal
positions and chunked cross-entropy, in plain PyTorch.

Port of :mod:`repro.models.layers`.  None of these was a Pallas kernel in
the reference (XLA compiled them), so library calls are used freely.  The
arithmetic follows the reference step for step, including where it asks
for f32 results from low-precision operands (``preferred_element_type``):
there the operands are upcast to f32 before the product.  TF32 stays off
(PyTorch's default), so an f32 product on the card is a full f32 product.

Memory-critical paths are chunked as in the reference: attention runs
block-wise with an online softmax, and the LM loss walks sequence chunks
so vocab logits exist only as (B, chunk, V) tiles.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S) integer; split halves."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None, None] * freqs  # (..., S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _online_softmax_step(m, l, acc, s, vb):
    """One flash-attention accumulation step; all f32."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bqkgt,btkd->bqkgd", p, vb.float())
    return m_new, l_new, acc_new


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    mode: str = "masked") -> torch.Tensor:
    """Block-wise attention with online softmax.

    q (B, Sq, H, hd); k/v (B, T, KVH, hd); GQA via H = KVH * G.
    ``mode="triangle"`` visits, for each q block, only the kv blocks at or
    before it; ``"masked"`` visits every kv block and masks.  q is scaled
    and cast back to its dtype before QK^T; scores and P.V are f32.
    """
    B, Sq0, H, hd = q.shape
    T0, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qc = min(Sq0, max(q_chunk, Sq0 // 16))
    kvc = min(T0, max(kv_chunk, T0 // 32))
    Sq = -(-Sq0 // qc) * qc
    T = -(-T0 // kvc) * kvc
    if Sq != Sq0:  # pad ragged lengths up to chunk multiples (masked below)
        q = F.pad(q, (0, 0, 0, 0, 0, Sq - Sq0))
    if T != T0:
        k = F.pad(k, (0, 0, 0, 0, 0, T - T0))
        v = F.pad(v, (0, 0, 0, 0, 0, T - T0))
    nq, nk = Sq // qc, T // kvc

    qb = (q.reshape(B, nq, qc, KVH, G, hd) * scale).to(q.dtype)
    kb = k.reshape(B, nk, kvc, KVH, hd)
    vb = v.reshape(B, nk, kvc, KVH, hd)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, qc)
    kv_ar = torch.arange(kvc, device=dev)

    def kv_loop(qi: int, n_blocks: int) -> torch.Tensor:
        q_block = qb[:, qi].float()
        m = torch.full((B, qc, KVH, G), -math.inf, device=dev)
        l = torch.zeros((B, qc, KVH, G), device=dev)
        acc = torch.zeros((B, qc, KVH, G, hd), device=dev)
        for ki in range(n_blocks):
            s = torch.einsum("bqkgd,btkd->bqkgt", q_block, kb[:, ki].float())
            kv_pos = ki * kvc + kv_ar
            valid = kv_pos < T0  # ragged-length padding
            if causal:
                valid = valid[None, :] & (q_pos[qi][:, None]
                                          >= kv_pos[None, :])
                s = s.masked_fill(~valid[None, :, None, None, :], -math.inf)
            else:
                s = s.masked_fill(~valid[None, None, None, None, :],
                                  -math.inf)
            m, l, acc = _online_softmax_step(m, l, acc, s, vb[:, ki])
        l = torch.clamp_min(l, 1e-30)
        return (acc / l[..., None]).to(q.dtype)

    outs = []
    for qi in range(nq):
        n_blocks = nk
        if mode == "triangle" and causal:
            # highest kv block this q block can see
            n_blocks = min(((q_offset + (qi + 1) * qc - 1) // kvc) + 1, nk)
        outs.append(kv_loop(qi, n_blocks))
    out = torch.stack(outs, dim=1)  # (B, nq, qc, KVH, G, hd)
    return out.reshape(B, Sq, H, hd)[:, :Sq0]


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Single-step attention: q (B, 1, H, hd) vs cache (B, T, KVH, hd).

    Head ``h`` reads KV head ``h // G`` (H = KVH * G).  Positions
    ``>= cache_len`` (an int, or a tensor that broadcasts against the
    (B, KVH, G, T) scores, e.g. (B, 1, 1, 1) for ragged rows) are masked
    to ``-inf``; scores and softmax are f32, the probabilities are cast to
    the cache's dtype and multiplied with f32 accumulation."""
    B, _, H, hd = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float())
    mask = torch.arange(T, device=q.device)[None, None, None, :] < cache_len
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def kv_write(kv, k, v, at: int) -> None:
    """Write ``k`` and ``v`` (B, S, KVH, hd) into rows ``at..at+S-1`` of
    the cache buffers ``kv = (k_buf, v_buf)`` (B, T, KVH, hd), in place
    and in the buffers' dtype."""
    kv[0][:, at:at + k.shape[1]] = k
    kv[1][:, at:at + v.shape[1]] = v


def logits_f32(x, w) -> torch.Tensor:
    """``x (..., D) @ w (D, V)`` with f32 logits from operands in their own
    dtype, the reference's ``preferred_element_type=f32``.  On the card a
    low-precision product is one GEMM with an f32 output (``torch.mm``'s
    ``out_dtype``), so the head is read in its own dtype and never copied
    to f32; elsewhere the operands are upcast."""
    if x.dtype == torch.float32 or x.device.type != "cuda":
        return x.float() @ w.float()
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def glu_mlp(x, wg, wu, wd, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU block; x (B, S, D); w* 2-D."""
    h = (F.silu(x @ wg) if act == "silu"
         else F.gelu(x @ wg, approximate="tanh"))
    return (h * (x @ wu)) @ wd


def sinusoid_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) f32: ``sin`` of each position over ``10000^(2i/d)`` in the
    first half, ``cos`` in the second."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def chunked_softmax_xent(x, w_out, labels, mask=None, chunk: int = 512
                         ) -> torch.Tensor:
    """Mean cross-entropy without materialising (B, S, V) logits.

    x (B, S, D) final hidden states; w_out (D, V); labels (B, S) integer;
    per-chunk logits are f32 (B, c, V)."""
    B, S, D = x.shape
    c = min(chunk, S)
    n = S // c
    if n * c != S:
        raise ValueError(f"sequence {S} is not a multiple of chunk {c}")
    w = w_out.float()
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for i in range(n):
        xc = x[:, i * c:(i + 1) * c].float()
        lc = labels[:, i * c:(i + 1) * c].long()
        mc = (torch.ones(lc.shape, device=x.device) if mask is None
              else mask[:, i * c:(i + 1) * c].float())
        logits = xc @ w
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        tot = tot + ((logz - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def next_token_xent(x, w_out, tokens) -> torch.Tensor:
    """Mean cross-entropy of each next token of ``tokens`` (B, S) from the
    final hidden states ``x``: the labels are ``tokens`` rolled by one and
    the last position is masked, as the reference's models do."""
    B, S = tokens.shape
    mask = torch.ones((B, S), device=tokens.device)
    mask[:, -1] = 0.0
    return chunked_softmax_xent(x, w_out, torch.roll(tokens, -1, dims=1),
                                mask)
