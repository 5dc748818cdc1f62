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

On DTensors (under :func:`~repro_torch.sharding.set_rules`) both
dispatches keep the reference's constrain points and run under either
expert placement that ``rules_for`` picks: EP (``experts`` on ``model``)
or TP-in-expert (``expert_ff`` on ``model``, the sorted dispatch's
``moe_cap`` over the token axes).  DTensor has no useful strategy for a
sort, ``topk`` or an accumulating scatter on a split token axis, so the
routing and the index arithmetic run shard by shard:

* the router's product and softmax are DTensor ops; each rank takes the
  top-k of its own tokens;
* the sorted dispatch makes the (N, K) expert ids whole (an all-gather of
  small integers) and every rank computes the reference's global
  positions, capacity and drop rule from them, so that a shard's tokens
  land in the same slots as in the unsharded block;
* each rank fills the part of the (E, C, D) buffer that its placement
  holds from its own tokens, and the parts are summed across the token
  axes (an all-reduce under EP, a reduce-scatter of the capacity under
  TP-in-expert; the rowwise dispatch is local to a row and needs none);
  the combine gathers each copy from the shard that holds its slot and
  sums across the expert (and token) axes in the same way;
* the expert GEMMs are DTensor products, constrained as the reference's.

Each slot, and each gathered copy, has exactly one non-zero contribution
across ranks, so the sums are exact and the values are the unsharded
block's; the weighted sum over K runs on each token's shard, in order.
The sorted dispatch's two sums move whole buffers, mostly zeros, where
an all-to-all would move only the kept copies: a cost of the port, not
of the job, which the dry-run counts apart under the
:func:`~repro_torch.models.layers.cost_scope` ``moe_dispatch``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import cost_scope
from repro_torch.sharding.specs import (constrain, current_rules, from_local,
                                        local_offset, logical_to_spec,
                                        placements, sum_partials)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """f32 router probabilities over the last axis, the top-k gates
    (renormalised) and their expert ids.  On DTensors ``probs`` is a
    DTensor (B, S, E) placed as ``x``'s rows, and the gates and ids are
    the local tokens' (B_local, S, K)."""
    logits = constrain(x.float() @ router_w.float(), "batch", "seq", None)
    probs = torch.softmax(logits, dim=-1)
    p = probs.to_local() if isinstance(probs, DTensor) else probs
    gates, eidx = torch.topk(p, top_k, dim=-1)
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
    Returns ``(out (B, S, D) in x's dtype, probs (B*S, E) f32)``; on
    DTensors ``probs`` is (B, S, E)."""
    if isinstance(x, DTensor) and current_rules() is not None:
        return _moe_block_sharded(x, router_w, wg, wu, wd, top_k=top_k,
                                  capacity_factor=capacity_factor, act=act)
    B, S, D = x.shape
    E = router_w.shape[-1]
    N, K = B * S, top_k
    C = sorted_capacity(N, K, capacity_factor, E)

    xf = x.reshape(N, D)
    probs, gates, eidx = _route(xf, router_w, K)          # (N, E), (N, K)

    flat_e = eidx.reshape(-1)                              # (N*K,)
    pos = _positions(flat_e, E)
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


def _positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each routed copy's position within its expert, in copy order: its
    rank in a stable sort by expert, less its expert's start."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.int64, device=flat_e.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[sorted_e]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def moe_aux_loss(probs: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (mean prob * fraction routed proxy)
    of ``probs`` (N, E), or on DTensors (B, S, E): the mean over tokens
    as a sum and one division, exact when the rows split unevenly."""
    if isinstance(probs, DTensor):
        lead = tuple(range(probs.ndim - 1))
        me = probs.sum(dim=lead) / (probs.numel() // probs.shape[-1])
    else:
        me = probs.mean(dim=0)
    return probs.shape[-1] * torch.sum(me * me)


def moe_block_rowwise(x, router_w, wg, wu, wd, *, top_k: int,
                      capacity_factor: float, act: str = "silu",
                      pos_chunk: int = 2048):
    """Row-local dispatch: capacity per (row, expert), positions from
    running counts over chunks of ``pos_chunk`` copies (no sort), a
    (B, E*C) slot -> copy map as the only scatter, and the dispatch and
    combine as gathers.  Returns ``(out (B, S, D), probs (B*S, E) f32)``;
    on DTensors ``probs`` is (B, S, E)."""
    if isinstance(x, DTensor) and current_rules() is not None:
        return _moe_block_rowwise_sharded(
            x, router_w, wg, wu, wd, top_k=top_k,
            capacity_factor=capacity_factor, act=act, pos_chunk=pos_chunk)
    B, S, D = x.shape
    E = router_w.shape[-1]
    K = top_k
    C = rowwise_capacity(S, K, capacity_factor, E)
    probs, gates, eidx = _route(x, router_w, K)            # (B, S, K)
    slot, slot_src = _rowwise_slots(eidx, E, C, pos_chunk)
    experts = (0, E)
    buf = _rowwise_dispatch(x, slot_src, K, experts, C)
    buf = buf.transpose(0, 1).reshape(E, B * C, D)
    h = _act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    y = torch.bmm(h, wd).reshape(E, B, C, D).transpose(0, 1)
    y_copy = _rowwise_gather(y, slot, experts, C)
    out = (y_copy * gates.reshape(B, S * K)[..., None].to(y.dtype))
    return (out.reshape(B, S, K, D).sum(dim=2).to(x.dtype),
            probs.reshape(-1, E))


def _rowwise_slots(eidx, E: int, C: int, pos_chunk: int):
    """Each copy's slot (B, T) in its row's (E*C) buffer, the sentinel
    E*C where dropped, and each slot's copy (B, E*C), T where empty."""
    B = eidx.shape[0]
    T = eidx.shape[1] * eidx.shape[2]
    dev = eidx.device
    flat_e = eidx.reshape(B, T)

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
    return slot, slot_src


def _rowwise_dispatch(x, slot_src, K: int, experts: tuple, C: int):
    """(B, e1 - e0, C, D): each slot of experts ``e0..e1-1`` gathers its
    copy of ``x`` (B, S, D) (a zero row for an empty slot)."""
    B, S, D = x.shape
    T = S * K
    e0, e1 = experts
    src = slot_src[:, e0 * C:e1 * C]
    copies = x[:, :, None, :].expand(B, S, K, D).reshape(B, T, D)
    copies = torch.cat([copies, x.new_zeros((B, 1, D))], dim=1)
    buf = torch.gather(copies, 1, src[..., None].expand(*src.shape, D))
    return buf.reshape(B, e1 - e0, C, D)


def _rowwise_gather(y, slot, experts: tuple, C: int):
    """(B, T, D): each copy's row of ``y`` (B, e1 - e0, C, D), the buffer
    of experts ``e0..e1-1``; zeros for a dropped copy or one whose slot
    another shard holds."""
    B, El, _, D = y.shape
    e0 = experts[0]
    rel = slot - e0 * C
    mine = (rel >= 0) & (rel < El * C)
    y = torch.cat([y.reshape(B, El * C, D), y.new_zeros((B, 1, D))], dim=1)
    idx = torch.where(mine, rel, El * C)
    return torch.gather(y, 1, idx[..., None].expand(*idx.shape, D))


# ---------------------------------------------------------------------------
# the dispatches on DTensors
# ---------------------------------------------------------------------------

def _spec_placements(mesh, *logical) -> tuple:
    return placements(logical_to_spec(tuple(logical)), mesh)


def _token_dims(pl: tuple) -> set:
    """The mesh dims that split the rows (dim 0); every other mesh dim
    must hold the tensor whole."""
    out = set()
    for i, p in enumerate(pl):
        if p == Shard(0):
            out.add(i)
        elif not isinstance(p, Replicate):
            raise NotImplementedError(
                f"a MoE input placed {pl}: the dispatch takes tokens split "
                f"by rows only")
    return out


def _partial_on(pl: tuple, dims: set) -> list:
    return [Partial() if i in dims else p for i, p in enumerate(pl)]


def _moe_block_sharded(x, router_w, wg, wu, wd, *, top_k: int,
                       capacity_factor: float, act: str):
    """:func:`moe_block` on DTensors, shard by shard (module docstring).
    Tokens stay in rows, (B, S), so that a batch split unevenly (16
    microbatch rows on 32 ranks) needs no flattening of a split dim;
    ``probs`` is (B, S, E)."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    N, K = B * S, top_k
    C = sorted_capacity(N, K, capacity_factor, E)
    mesh = x.device_mesh

    # the reference's ("tokens", "embed") constraint: tokens are rows
    x = constrain(x, "batch", "seq", "embed")
    px = tuple(x.placements)
    tok = _token_dims(px)
    probs, gates, eidx = _route(x, router_w, K)
    n_loc = eidx.shape[0] * S
    t0 = local_offset((B, S, D), mesh, px)[1][0] * S

    # the reference's global positions, from every token's expert ids
    flat_e = from_local(eidx, mesh, px, (B, S, K)).full_tensor().reshape(-1)
    dev = flat_e.device
    pos = _positions(flat_e, E)
    keep = pos < C
    copies = torch.arange(t0 * K, (t0 + n_loc) * K, device=dev)

    def held_slot(ids, placed):
        """Which copies ``ids`` have their slot in this rank's part of an
        (E, C, D) buffer placed by ``placed``, and that slot there."""
        (El, Cl, _), (e0, c0, _) = local_offset((E, C, D), mesh, placed)
        e, p = flat_e[ids], pos[ids]
        mine = keep[ids] & (e >= e0) & (e < e0 + El) & (p >= c0) & (
            p < c0 + Cl)
        slot = (torch.clamp(e - e0, 0, El - 1) * Cl
                + torch.clamp(p - c0, 0, Cl - 1))
        return mine, slot, (El, Cl)

    # dispatch: this rank's part of the (E, C, D) buffer from its tokens,
    # summed across the token axes into the buffer's placement
    pb = _spec_placements(mesh, "experts", "moe_cap", "embed")
    split = {i for i, p in enumerate(pb) if p.is_shard()}
    held = tuple(Replicate() if i in tok else p for i, p in enumerate(pb))
    mine, slot, (El, Cl) = held_slot(copies, held)
    xl = x.to_local(grad_placements=_partial_on(px, split - tok))
    toks = xl.reshape(n_loc, 1, D).expand(n_loc, K, D).reshape(n_loc * K, D)
    toks = torch.where(mine[:, None], toks, torch.zeros(
        (), dtype=x.dtype, device=xl.device))
    part = torch.zeros((El * Cl, D), dtype=x.dtype, device=xl.device
                       ).index_put_((slot,), toks, accumulate=True)
    with cost_scope("moe_dispatch"):
        buf = sum_partials(part.reshape(El, Cl, D), mesh,
                           _partial_on(held, tok), pb, (E, C, D))

    h = _act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    h = constrain(h, "experts", "moe_cap", "expert_ff")
    y = constrain(torch.bmm(h, wd), "experts", "moe_cap", "embed")

    # combine: each copy from the shard holding its slot, summed across
    # the axes that split y onto the copies' rows
    py = tuple(y.placements)
    ysplit = {i for i, p in enumerate(py) if p.is_shard()}
    if tok & ysplit and not tok <= ysplit:
        raise NotImplementedError(f"a MoE buffer placed {py} with tokens "
                                  f"placed {px}")
    every = bool(tok & ysplit)  # the capacity split over the token axes
    rows = torch.arange(N * K, device=dev) if every else copies
    mine, slot, _ = held_slot(rows, py)
    yl = y.to_local(grad_placements=_partial_on(py, tok - ysplit))
    y_rows = yl.reshape(-1, D)[slot]
    y_rows = torch.where(mine[:, None], y_rows, torch.zeros(
        (), dtype=y_rows.dtype, device=yl.device))
    source = [Partial() if i in ysplit else
              (Shard(0) if i in tok else Replicate()) for i in range(len(py))]
    y_rows = y_rows.reshape(B if every else n_loc // S, S * K, D)
    with cost_scope("moe_dispatch"):
        y_tok = sum_partials(y_rows, mesh, source, px, (B, S * K, D))
    y_tok = constrain(y_tok, "batch", "seq", "embed").to_local()
    w = gates.reshape(-1, S * K, 1).to(y_tok.dtype)
    out = (y_tok * w).reshape(-1, S, K, D).sum(dim=2)
    out = constrain(from_local(out, mesh, px, (B, S, D)),
                    "batch", "seq", "embed")
    return out.to(x.dtype), probs


def _moe_block_rowwise_sharded(x, router_w, wg, wu, wd, *, top_k: int,
                               capacity_factor: float, act: str,
                               pos_chunk: int):
    """:func:`moe_block_rowwise` on DTensors: a row's dispatch is local
    to the rank holding the row; the combine sums each copy across the
    axes that split the experts.  ``probs`` is (B, S, E)."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    K = top_k
    C = rowwise_capacity(S, K, capacity_factor, E)
    mesh = x.device_mesh

    x = constrain(x, "batch", "seq", "embed")
    px = tuple(x.placements)
    rows = _token_dims(px)
    probs, gates, eidx = _route(x, router_w, K)
    slot, slot_src = _rowwise_slots(eidx, E, C, pos_chunk)

    pb = _spec_placements(mesh, "batch", "experts", None, "embed")
    split = {i for i, p in enumerate(pb) if p == Shard(1)}
    (_, El, _, _), (_, e0, _, _) = local_offset((B, E, C, D), mesh, pb)
    xl = x.to_local(grad_placements=_partial_on(px, split))
    buf = from_local(_rowwise_dispatch(xl, slot_src, K, (e0, e0 + El), C),
                     mesh, pb, (B, E, C, D))
    buf = constrain(buf, "batch", "experts", None, "embed")
    # experts lead: (E, B*C, D), each expert's rows of every batch row
    buf = buf.transpose(0, 1).reshape(E, B * C, D)
    h = _act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    h = constrain(h, "experts", "batch", "expert_ff")
    y = torch.bmm(h, wd).reshape(E, B, C, D).transpose(0, 1)
    y = constrain(y, "batch", "experts", None, "embed")

    py = tuple(y.placements)
    ysplit = {i for i, p in enumerate(py) if p == Shard(1)}
    y_copy = _rowwise_gather(y.to_local(), slot, (e0, e0 + El), C)
    source = [Partial() if i in ysplit else (Shard(0) if i in rows
                                             else Replicate())
              for i in range(len(py))]
    y_copy = sum_partials(y_copy, mesh, source, px, (B, S * K, D)).to_local()
    out = y_copy * gates.reshape(-1, S * K, 1).to(y_copy.dtype)
    out = out.reshape(-1, S, K, D).sum(dim=2)
    out = constrain(from_local(out, mesh, px, (B, S, D)),
                    "batch", "seq", "embed")
    return out.to(x.dtype), probs
