"""Plain float32 reference of the Zamba2 hybrid as the port runs it: one
shared attention+MLP block (GQA attention with RoPE, a SwiGLU MLP) applied
before every group of ``attn_every`` Mamba2 layers, the final norm, the
untied head and the mean next-token cross-entropy.

A Mamba2 layer: the input projection split into z, x, B, C and dt; a
depthwise causal convolution of x; SiLU on x, B and C; ``dt = softplus(dt
+ dt_bias)``; per head the recurrence ``H_t = exp(-exp(A_log) dt_t) H_{t-1}
+ (x_t dt_t) (x) B_t``, read out as ``y_t = H_t . C_t``, with B and C
shared by the heads; ``y + D x``, gated by SiLU(z), normed, projected out.
The recurrence is computed here in its quadratic form over the whole
sequence (``y_t = sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) x_s dt_s``),
not in chunks as the program does.

Parameters are a flat dict in the port's names.  Imports torch, this
folder and the benchmark's counts (``portbench/roofline.py``) alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import roofline
from portbench.reference.common import (causal_attention, glu,
                                        next_token_xent, rms_norm, rope)


def param_specs(run: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every leaf, in the port's names."""
    D, V, N, K = run["d_model"], run["vocab_size"], run["ssm_state"], run["ssm_conv"]
    DI = run["ssm_expand"] * D
    H = DI // 64
    H_attn, KVH = run["n_heads"], run["n_kv_heads"]
    hd = D // H_attn
    F_ = run["d_ff"]
    specs = [("embed", (V, D), "embed"), ("final_norm", (D,), "zeros"),
             ("lm_head", (D, V), "normal")]
    for i in range(run["n_layers"]):
        p = f"layers.{i}."
        specs += [(p + "ln", (D,), "zeros"),
                  (p + "in_proj", (D, 2 * DI + 2 * N + H), "normal"),
                  (p + "conv_w", (K, DI), "normal"), (p + "conv_b", (DI,), "zeros"),
                  (p + "A_log", (H,), "zeros"), (p + "D_skip", (H,), "ones"),
                  (p + "dt_bias", (H,), "zeros"), (p + "norm", (DI,), "zeros"),
                  (p + "out_proj", (DI, D), "normal")]
    s = "shared_attn."
    specs += [(s + "ln_attn", (D,), "zeros"), (s + "wq", (D, H_attn * hd), "normal"),
              (s + "wk", (D, KVH * hd), "normal"), (s + "wv", (D, KVH * hd), "normal"),
              (s + "wo", (H_attn * hd, D), "normal"), (s + "ln_mlp", (D,), "zeros"),
              (s + "w_gate", (D, F_), "normal"), (s + "w_up", (D, F_), "normal"),
              (s + "w_down", (F_, D), "normal")]
    return specs


def _ssd_heads(cum, G, v, mm):
    """y (B, S, h, P) of h heads: cum (B, S, h) cumulative log decay, G
    (B, S, S) the products C_t . B_s, v (B, S, h, P)."""
    S = cum.shape[1]
    ct = cum.transpose(1, 2)                                     # (B,h,S)
    diff = ct[:, :, :, None] - ct[:, :, None, :]                 # (B,h,t,s)
    causal = torch.ones((S, S), dtype=torch.bool, device=cum.device).tril()
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    return mm(L * G[:, None], v.transpose(1, 2)).transpose(1, 2)


def ssd(log_a, v, Bm, Cm, mm, heads: int = 16):
    """The recurrence's output (B, S, H, P) from the zero state: log_a
    (B, S, H), v (B, S, H, P), B and C (B, S, N); ``heads`` heads at a
    time, each block recomputed in the backward pass."""
    cum = torch.cumsum(log_a, dim=1)
    G = mm(Cm, Bm.transpose(1, 2))                               # (B,t,s)
    ys = [checkpoint(_ssd_heads, cum[:, :, i:i + heads], G, v[:, :, i:i + heads],
                     mm, use_reentrant=False)
          for i in range(0, v.shape[2], heads)]
    return torch.cat(ys, dim=2)


def mamba2(x, p, run: dict, mm):
    B, S, D = x.shape
    N, eps = run["ssm_state"], run["norm_eps"]
    DI = run["ssm_expand"] * D
    H = DI // 64
    h = rms_norm(x, p["ln"], eps)
    z, xs, Bm, Cm, dt = torch.split(mm(h, p["in_proj"]), [DI, DI, N, N, H], dim=-1)
    Kc = p["conv_w"].shape[0]
    xp = F.pad(xs, (0, 0, Kc - 1, 0))
    conv = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(Kc)) + p["conv_b"]
    xs = F.silu(conv)
    dt = F.softplus(dt + p["dt_bias"])
    log_a = -torch.exp(p["A_log"]) * dt
    xh = xs.reshape(B, S, H, DI // H)
    y = ssd(log_a, xh * dt[..., None], F.silu(Bm), F.silu(Cm), mm)
    y = (y + p["D_skip"][None, None, :, None] * xh).reshape(B, S, DI)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    return x + mm(y, p["out_proj"])


def shared_block(x, p, run: dict, mm):
    B, S, D = x.shape
    H, KVH, eps = run["n_heads"], run["n_kv_heads"], run["norm_eps"]
    hd = D // H
    h = rms_norm(x, p["ln_attn"], eps)
    q = rope(mm(h, p["wq"]).view(B, S, H, hd), run["rope_theta"])
    k = rope(mm(h, p["wk"]).view(B, S, KVH, hd), run["rope_theta"])
    v = mm(h, p["wv"]).view(B, S, KVH, hd)
    x = x + mm(causal_attention(q, k, v, mm).reshape(B, S, H * hd), p["wo"])
    return x + glu(rms_norm(x, p["ln_mlp"], eps), p["w_gate"], p["w_up"],
                   p["w_down"], mm)


def _apply(fn, x, names, mm, run, *leaves):
    return fn(x, dict(zip(names, leaves)), run, mm)


def _sub(params: dict, pre: str):
    names = [n[len(pre):] for n in params if n.startswith(pre)]
    return names, [params[pre + n] for n in names]


def loss(params: dict, tokens, run: dict, mm):
    """The training loss of ``tokens`` (B, S) under float32 ``params``;
    each block is recomputed in the backward pass."""
    x = params["embed"][tokens.long()]
    every = run["attn_every"]
    sn, sl = _sub(params, "shared_attn.")
    for i in range(run["n_layers"]):
        if i % every == 0:
            x = checkpoint(_apply, shared_block, x, sn, mm, run, *sl,
                           use_reentrant=False)
        names, leaves = _sub(params, f"layers.{i}.")
        x = checkpoint(_apply, mamba2, x, names, mm, run, *leaves,
                       use_reentrant=False)
    x = rms_norm(x, params["final_norm"], run["norm_eps"])
    return next_token_xent(x, params["lm_head"], tokens, mm)


def step_flops(run: dict, B: int, S: int) -> float:
    """A training step's nominal operations: 6 x the parameters that take
    part in products (each Mamba2 layer's projections, the shared block as
    often as it is applied, the head; not the lookup or the convolution) x
    tokens, plus the shared block's attention scores and every layer's
    scan at its chunk."""
    tokens = B * S
    D, V = run["d_model"], run["vocab_size"]
    H, KVH = run["n_heads"], run["n_kv_heads"]
    hd = D // H
    attn_params = D * H * hd * 2 + D * KVH * hd * 2
    DI = run["ssm_expand"] * D
    Hs, N = DI // 64, run["ssm_state"]
    mamba = D * (2 * DI + 2 * N + Hs) + DI * D
    n_attn = -(-run["n_layers"] // run["attn_every"])
    shared = attn_params + 3 * D * run["d_ff"]
    params = run["n_layers"] * mamba + n_attn * shared + D * V
    scores = n_attn * roofline.attention(B, S, H, KVH, hd)[0]
    extra = run["n_layers"] * roofline.scan(B, S, Hs, 64, N, run["ssm_chunk"])[0]
    return 6.0 * params * tokens + scores + extra
