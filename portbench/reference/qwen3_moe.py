"""Plain float32 reference of the MoE transformer (qwen3-moe-30b-a3b as
the port runs it): pre-norm layers of qk-normed GQA attention with RoPE
and a top-k routed expert MLP, the experts' capacity and drop rule of the
configuration, the final norm, the untied head and the mean next-token
cross-entropy plus the router's load-balancing term.

Parameters are a flat dict in the port's parameter names (``embed``,
``layers.<i>.wq``, ...), each (D, X) product ``x @ w``.  Imports torch,
this folder and the benchmark's counts (``portbench/roofline.py``) alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import roofline
from portbench.reference.common import (causal_attention, next_token_xent,
                                        rms_norm, rope)


def param_specs(run: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every leaf, in the port's names."""
    D, H, KVH, hd = run["d_model"], run["n_heads"], run["n_kv_heads"], run["head_dim"]
    E, Fe, V = run["n_experts"], run["moe_d_ff"], run["vocab_size"]
    specs = [("embed", (V, D), "embed"), ("final_norm", (D,), "zeros"),
             ("lm_head", (D, V), "normal")]
    for i in range(run["n_layers"]):
        p = f"layers.{i}."
        specs += [(p + "ln_attn", (D,), "zeros"), (p + "wq", (D, H * hd), "normal"),
                  (p + "wk", (D, KVH * hd), "normal"), (p + "wv", (D, KVH * hd), "normal"),
                  (p + "wo", (H * hd, D), "normal"), (p + "ln_mlp", (D,), "zeros"),
                  (p + "q_norm", (hd,), "zeros"), (p + "k_norm", (hd,), "zeros"),
                  (p + "router", (D, E), "normal"), (p + "we_gate", (E, D, Fe), "normal"),
                  (p + "we_up", (E, D, Fe), "normal"), (p + "we_down", (E, Fe, D), "normal")]
    return specs


def capacity(n_tokens: int, top_k: int, factor: float, n_experts: int) -> int:
    """Slots an expert keeps: ``int(N * K * factor / E + 0.5)``, at least 8,
    rounded up to a multiple of 32, at most ``max(N, 32)``."""
    C = max(int(n_tokens * top_k * factor / n_experts + 0.5), 8)
    return min(-(-C // 32) * 32, max(n_tokens, 32))


def route(x, router, top_k: int, mm):
    """Router probabilities (N, E), the top-k gates renormalised to sum to
    one, and their expert ids (N, K)."""
    probs = torch.softmax(mm(x, router), dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def kept_copies(eidx, C: int, E: int):
    """Each routed copy (token n, choice k) is copy ``n * K + k``.  An
    expert keeps the first ``C`` of its copies in that order and drops the
    rest.  Returns the kept copies sorted by expert (copy order within
    one) and the count each expert keeps."""
    flat = eidx.reshape(-1)
    onehot = F.one_hot(flat, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat[:, None])[:, 0]
    kept = torch.nonzero(pos < C)[:, 0]
    order = torch.sort(flat[kept], stable=True).indices
    kept = kept[order]
    counts = torch.bincount(flat[kept], minlength=E)
    return kept, counts


def moe(h, p, run: dict, mm):
    """The expert sublayer of one layer: ``(out (B, S, D), probs (N, E))``."""
    B, S, D = h.shape
    E, K = run["n_experts"], run["top_k"]
    x = h.reshape(B * S, D)
    probs, gates, eidx = route(x, p["router"], K, mm)
    C = capacity(B * S, K, run["capacity_factor"], E)
    kept, counts = kept_copies(eidx, C, E)
    tok = kept // K
    w = gates.reshape(-1)[kept]
    out = torch.zeros_like(x)
    lo = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            t = tok[lo:lo + n]
            xe = x[t]
            ye = mm(F.silu(mm(xe, p["we_gate"][e])) * mm(xe, p["we_up"][e]),
                    p["we_down"][e])
            out = out.index_add(0, t, ye * w[lo:lo + n, None])
        lo += n
    return out.reshape(B, S, D), probs


def layer(x, p, run: dict, mm):
    """One layer: ``(x, aux)``, aux the router's load-balancing term."""
    B, S, D = x.shape
    H, KVH, hd, eps = run["n_heads"], run["n_kv_heads"], run["head_dim"], run["norm_eps"]
    h = rms_norm(x, p["ln_attn"], eps)
    q = rms_norm(mm(h, p["wq"]).view(B, S, H, hd), p["q_norm"], eps)
    k = rms_norm(mm(h, p["wk"]).view(B, S, KVH, hd), p["k_norm"], eps)
    v = mm(h, p["wv"]).view(B, S, KVH, hd)
    q, k = rope(q, run["rope_theta"]), rope(k, run["rope_theta"])
    o = causal_attention(q, k, v, mm)
    x = x + mm(o.reshape(B, S, H * hd), p["wo"])
    out, probs = moe(rms_norm(x, p["ln_mlp"], eps), p, run, mm)
    me = probs.mean(dim=0)
    return x + out, probs.shape[-1] * torch.sum(me * me)


def _layer_flat(x, names, mm, run, *leaves):
    return layer(x, dict(zip(names, leaves)), run, mm)


def loss(params: dict, tokens, run: dict, mm):
    """The training loss of ``tokens`` (B, S) under float32 ``params``;
    each layer is recomputed in the backward pass."""
    x = params["embed"][tokens.long()]
    auxes = []
    for i in range(run["n_layers"]):
        pre = f"layers.{i}."
        names = [n[len(pre):] for n in params if n.startswith(pre)]
        x, aux = checkpoint(_layer_flat, x, names, mm, run,
                            *(params[pre + n] for n in names),
                            use_reentrant=False)
        auxes.append(aux)
    x = rms_norm(x, params["final_norm"], run["norm_eps"])
    return (next_token_xent(x, params["lm_head"], tokens, mm)
            + 0.01 * sum(auxes) / run["n_layers"])


def step_flops(run: dict, B: int, S: int) -> float:
    """A training step's nominal operations: 6 x the parameters that take
    part in products (the attention's projections, the router, the top-k
    experts a token visits, the head; the embedding lookup is not a
    product) x tokens, plus every layer's attention scores."""
    tokens = B * S
    D, V = run["d_model"], run["vocab_size"]
    H, KVH, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    attn_params = D * H * hd * 2 + D * KVH * hd * 2
    E, K, F = run["n_experts"], run["top_k"], run["moe_d_ff"]
    per_layer = attn_params + D * E + K * 3 * D * F
    params = run["n_layers"] * per_layer + D * V
    scores = run["n_layers"] * roofline.attention(B, S, H, KVH, hd)[0]
    return 6.0 * params * tokens + scores
