"""Mixture-of-Experts block: top-k routing and capacity dispatch.

Port of :mod:`repro.models.moe`: ``moe_block`` (the sorted dispatch),
``moe_aux_loss`` and ``moe_block_rowwise`` (the row-local dispatch), plain
functions on tensors with the reference's shapes, capacities and drop
rule.  Every shape is static, and every op has a ``meta`` implementation:
the launcher traces the train step on ``meta`` tensors to attribute it
(``launch/train.py::attribute_step``), so expert counts come from a
``scatter_add_`` of ones, not ``torch.bincount``.

No float atomics decide a value, so a step gives the same bits run after
run on the card:

* the router's logits are an f32 product of f32 operands (TF32 stays off),
  since a flipped top-k choice changes a token's output;
* a token's K copies are ``xf`` expanded over K, so their gradient is a
  sum over K, not a scatter;
* a kept copy owns its (expert, slot); a dropped copy is zeroed and sent
  to a slot that is discarded or that it shares only with zeros, so each
  accumulation adds one value to zeros;
* the combine sums an ``(N, K, D)`` view over K (the reference's
  ``segment_sum`` over ``repeat(arange(N), K)``), and the rowwise combine
  is a gather of each kept copy's own slot (the reference scatter-adds
  each slot into its token).

The sharding constraints of the reference belong to the mesh slice
(``ROADMAP.md`` §1) and are not here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """f32 router probabilities over the last axis, the top-k gates
    (renormalised) and their expert ids."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def sorted_capacity(n_tokens: int, top_k: int, capacity_factor: float,
                    n_experts: int) -> int:
    """Slots per expert of :func:`moe_block`: the reference's integer
    arithmetic, 32-aligned."""
    C = max(int(n_tokens * top_k * capacity_factor / n_experts + 0.5), 8)
    return min(-(-C // 32) * 32, max(n_tokens, 32))


def rowwise_capacity(seq_len: int, top_k: int, capacity_factor: float,
                     n_experts: int) -> int:
    """Slots per (row, expert) of :func:`moe_block_rowwise`, 8-aligned."""
    T = seq_len * top_k
    C = max(int(T * capacity_factor / n_experts + 0.5), 8)
    return min(-(-C // 8) * 8, T)


def moe_block(x, router_w, wg, wu, wd, *, top_k: int, capacity_factor: float,
              act: str = "silu"):
    """x (B, S, D); router_w (D, E); wg/wu (E, D, F); wd (E, F, D).
    Returns ``(out (B, S, D) in x's dtype, probs (B*S, E) f32)``."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    N, K = B * S, top_k
    C = sorted_capacity(N, K, capacity_factor, E)

    xf = x.reshape(N, D)
    probs, gates, eidx = _route(xf, router_w, K)          # (N, E), (N, K)

    flat_e = eidx.reshape(-1)                              # (N*K,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    # position of each routed copy within its expert: rank - expert start
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(N * K, device=x.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)

    keep = pos < C
    slot = flat_e * C + torch.clamp_max(pos, C - 1)        # (N*K,)

    # dispatch: (E, C, D) expert buffers; dropped copies add zeros to
    # slot C-1 of their expert, so the accumulation must add, not overwrite
    tok = xf[:, None, :].expand(N, K, D).reshape(N * K, D)
    tok = torch.where(keep[:, None], tok, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device).index_put_(
        (slot,), tok, accumulate=True).reshape(E, C, D)

    h = _act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    y = torch.bmm(h, wd)                                   # (E, C, D)

    # combine: gather each routed copy back and weight it by its gate
    y_tok = y.reshape(E * C, D)[slot]
    y_tok = torch.where(keep[:, None], y_tok, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))
    w = gates.reshape(-1)[:, None].to(y_tok.dtype)
    out = (y_tok * w).reshape(N, K, D).sum(dim=1)
    return out.reshape(B, S, D).to(x.dtype), probs


def moe_aux_loss(probs: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (mean prob * fraction routed proxy)."""
    me = probs.mean(dim=0)
    return probs.shape[-1] * torch.sum(me * me)


def moe_block_rowwise(x, router_w, wg, wu, wd, *, top_k: int,
                      capacity_factor: float, act: str = "silu",
                      pos_chunk: int = 2048):
    """Row-local dispatch: capacity per (row, expert), positions from
    running counts over chunks of ``pos_chunk`` copies (no sort), a
    (B, E*C) slot -> copy map as the only scatter, and the dispatch and
    combine as gathers.  Returns ``(out (B, S, D), probs (B*S, E) f32)``."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    K = top_k
    T = S * K
    C = rowwise_capacity(S, K, capacity_factor, E)
    dev = x.device

    probs, gates, eidx = _route(x, router_w, K)            # (B, S, K)
    flat_e = eidx.reshape(B, T)
    gates_flat = gates.reshape(B, T)

    # positions via chunked running counts (B, E); pad copies carry id E
    nck = -(-T // pos_chunk)
    fe = F.pad(flat_e, (0, nck * pos_chunk - T), value=E)
    experts = torch.arange(E, device=dev)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    pos_chunks = []
    for i in range(nck):
        e_chunk = fe[:, i * pos_chunk:(i + 1) * pos_chunk]
        oh = (e_chunk[..., None] == experts).long()        # (B, ck, E)
        run = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        pos_chunks.append(torch.gather(
            run, 2, torch.clamp_max(e_chunk, E - 1)[..., None])[..., 0])
        counts = counts + oh.sum(dim=1)
    pos = torch.cat(pos_chunks, dim=1)[:, :T]
    keep = pos < C

    # slot -> copy map, (B, E*C+1); dropped copies collide only on the
    # sentinel slot E*C, which is cut off
    slot = torch.where(keep, flat_e * C + torch.clamp_max(pos, C - 1),
                       E * C)
    copy_ids = torch.arange(T, device=dev).expand(B, T)
    slot_src = torch.full((B, E * C + 1), T, dtype=torch.int64,
                          device=dev).scatter_(1, slot, copy_ids)[:, :E * C]

    # dispatch: each slot gathers its copy (a zero row for an empty slot)
    copies = x[:, :, None, :].expand(B, S, K, D).reshape(B, T, D)
    copies = torch.cat([copies, x.new_zeros((B, 1, D))], dim=1)
    buf = torch.gather(copies, 1, slot_src[..., None].expand(B, E * C, D))
    # experts lead: (E, B*C, D), each expert's rows of every batch row
    buf = buf.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)

    h = _act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    y = torch.bmm(h, wd).reshape(E, B, C, D).transpose(0, 1)
    y = y.reshape(B, E * C, D)

    # combine: each copy gathers its own slot back (a dropped one the zero
    # sentinel row), weighted by its gate, summed over its token's K copies
    y = torch.cat([y, y.new_zeros((B, 1, D))], dim=1)
    y_copy = torch.gather(y, 1, slot[..., None].expand(B, T, D))
    out = (y_copy * gates_flat[..., None].to(y.dtype)).reshape(B, S, K, D)
    return out.sum(dim=2).to(x.dtype), probs.reshape(-1, E)
