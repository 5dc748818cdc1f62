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

Sharding is annotated with logical names via
``repro_torch.sharding.constrain`` at the reference's points; on plain
tensors, or without rules, each is a no-op.  On DTensors split by
vocab, the embedding lookup and the loss's log-sum-exp and gold logit
run shard by shard and sum (B, S)-sized partials across the mesh, as
XLA partitions them; their values are the plain path's.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.specs import (constrain, from_local, is_sharded,
                                        local_offset)


# ---------------------------------------------------------------------------
# marks for a cost counter: a loop it may count by its trip count, and a
# part of the step whose collectives it counts apart
# ---------------------------------------------------------------------------

# the active cost counters (``analysis.op_cost.OpCostMode`` pushes itself
# here); each has ``loop(n)`` and ``scope(name)`` context managers
COST_COUNTERS: list = []


class Loop:
    """What :func:`counted_loop` yields: ``steps``, the iterations to run,
    and :meth:`carries`."""

    def __init__(self, steps: int):
        self.steps = steps
        self.carried: tuple = ()

    def carries(self, *tensors) -> None:
        """Name the tensors that only carry the state from step to step
        (each replaces the last): a cost counter counts them once in the
        peak."""
        self.carried = tensors


@contextlib.contextmanager
def counted_loop(n: int):
    """Run a loop of ``n`` like iterations: ``for ... in xs[:loop.steps]``.
    ``steps`` is ``n``; an active cost counter may make it 1 and count the
    one iteration ``n`` times."""
    if not COST_COUNTERS:
        yield Loop(n)
        return
    with COST_COUNTERS[-1].loop(n) as loop:
        yield loop


@contextlib.contextmanager
def cost_scope(name: str):
    """An active cost counter counts the collectives run inside, and those
    of their backward, apart under ``name``."""
    if not COST_COUNTERS:
        yield
        return
    with COST_COUNTERS[-1].scope(name):
        yield


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


def _local_placements(q, k):
    """q's and k's placements with every mesh dim that splits anything
    but batch (dim 0) or query heads (dim 2, with kv heads split alike
    or whole) made whole."""
    pq, pk = list(q.placements), list(k.placements)
    heads = False
    for i, (a, b) in enumerate(zip(pq, pk)):
        if a == b == Shard(0):
            continue
        if a == Shard(2) and not heads and b in (Shard(2), Replicate()):
            heads = True
            continue
        pq[i], pk[i] = Replicate(), Replicate()
    return pq, pk


def _shard_local(q, k, v, *, gather: bool = False):
    """Attention on DTensors split only by batch (dim 0) and heads (dim
    2) is local to each shard.  Then the local q, k and v (k and v
    narrowed to the kv heads the local queries read, where they are whole
    on the heads' mesh dim) and a function that places a local output as
    q is placed; else None, and DTensor runs the ops.  With ``gather``
    any other split (head_dim, where the heads do not divide the model
    axis) is first made whole, so the mesh dim computes the attention
    redundantly."""
    if not isinstance(q, DTensor) or not isinstance(k, DTensor) \
            or not isinstance(v, DTensor) or k.placements != v.placements:
        return None
    mesh = q.device_mesh
    if gather:
        pq, pk = _local_placements(q, k)
        q = q.redistribute(mesh, pq)
        k, v = k.redistribute(mesh, pk), v.redistribute(mesh, pk)
    G = q.shape[2] // k.shape[2]
    heads_dim = None
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        if a == b and (isinstance(a, Replicate) or a == Shard(0)):
            continue
        if a == Shard(2) and heads_dim is None and (
                b == Shard(2) or isinstance(b, Replicate)):
            heads_dim = i
            continue
        return None
    for t in (q, k):  # even shards only
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and t.shape[p.dim] % mesh.size(i):
                return None
    ql = q.to_local()
    if heads_dim is not None and isinstance(k.placements[heads_dim],
                                            Replicate):
        # q's heads are split, the kv heads whole: take the local slice
        hl = ql.shape[2]
        if hl % G and G % hl:
            return None
        first = mesh.get_local_rank(heads_dim) * hl // G
        grad_pl = [Partial() if i == heads_dim else p
                   for i, p in enumerate(k.placements)]
        kl, vl = (t.to_local(grad_placements=grad_pl).narrow(
            2, first, max(hl // G, 1)) for t in (k, v))
    else:
        kl, vl = k.to_local(), v.to_local()

    def wrap(out_local):
        return from_local(out_local, mesh, q.placements,
                          (*q.shape[:-1], out_local.shape[-1]))

    return (ql, kl, vl), wrap


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    mode: str = "masked") -> torch.Tensor:
    """Block-wise attention with online softmax.

    q (B, Sq, H, hd); k/v (B, T, KVH, hd); GQA via H = KVH * G.
    ``mode="triangle"`` visits, for each q block, only the kv blocks at or
    before it; ``"masked"`` visits every kv block and masks.  q is scaled
    and cast back to its dtype before QK^T; scores and P.V are f32.
    DTensors attend shard by shard, split by batch and heads only.
    """
    local = _shard_local(q, k, v, gather=True)
    if local is not None:
        (q, k, v), wrap = local
        return wrap(flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk, mode=mode))
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
    the cache's dtype and multiplied with f32 accumulation.  DTensors
    split by batch and heads attend shard by shard; a cache whose
    positions are split (``kv_seq``, the sequence-split decode) attends
    shard by shard too, and the shards' maxima and sums are combined
    across the mesh (:func:`_seq_split_decode`)."""
    if is_sharded(k_cache, 1):
        return _seq_split_decode(q, k_cache, v_cache, cache_len)
    local = _shard_local(q, k_cache, v_cache)
    if local is not None:
        (q, k_cache, v_cache), wrap = local
        return wrap(decode_attention(q, k_cache, v_cache, cache_len))
    if is_sharded(q, 2):
        # the cache split otherwise (head_dim): the one query's heads are
        # made whole, so that grouping them cannot cut a split
        q = q.redistribute(q.device_mesh, [
            Replicate() if p.is_shard(2) else p for p in q.placements])
    B, _, H, hd = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float())
    mask = torch.arange(T, device=q.device)[None, None, None, :] < cache_len
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.reshape(B, 1, H, hd).to(q.dtype)
    if is_sharded(out, 3):
        # split by head_dim (the cache's split): whole again, so that the
        # heads can be flattened into the output projection's rows
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_shard(3) else p for p in out.placements])
    return out


def _seq_split_decode(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """:func:`decode_attention` over a cache split by position (dim 1) on
    some mesh dims: each rank scores the query against its own positions
    (masked past ``cache_len`` by their global index), keeps its maximum,
    its sum of exponentials and its unnormalised product with V, and the
    shards combine them, rescaled to the global maximum, across the
    position dims (the flash-decoding split; a shard with no position
    under ``cache_len`` adds nothing).  Any other split of the cache must
    be batch or heads, matched by the query's; else it is made whole.
    The probabilities are cast to the cache's dtype before they are
    normalised, not after: in f32 the same, in bf16 within its rounding."""
    mesh = k_cache.device_mesh
    pq, pk = list(q.placements), list(k_cache.placements)
    seq = {i for i, p in enumerate(pk) if p == Shard(1)}
    for i, (a, b) in enumerate(zip(pq, pk)):
        if i in seq:
            pq[i] = Replicate()
        elif not (a == b and (isinstance(a, Replicate) or a in (
                Shard(0), Shard(2)))):
            pq[i] = pk[i] = Replicate()
    q = q.redistribute(mesh, pq)
    k_cache = k_cache.redistribute(mesh, pk)
    v_cache = v_cache.redistribute(mesh, pk)
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    B, _, H, hd = ql.shape
    T, KVH = kl.shape[1], kl.shape[2]
    G = H // KVH
    t0 = local_offset(tuple(k_cache.shape), mesh, pk)[1][1]
    qg = ql.reshape(B, KVH, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), kl.float())
    pos = t0 + torch.arange(T, device=ql.device)
    s = s.masked_fill(~(pos[None, None, None, :] < cache_len), -math.inf)
    m = s.amax(dim=-1)                                       # (B,KVH,G)
    p = torch.exp(s - m.masked_fill(m == -math.inf, 0.0)[..., None])
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(vl.dtype).float(),
                       vl.float())
    # (B, KVH, G[, hd]) statistics, placed as the query's batch and heads
    stats = [Shard(1) if pl == Shard(2) else pl for pl in pq]
    shape = (q.shape[0], k_cache.shape[2], G)

    def across(local, op):
        part = [Partial(op) if i in seq else pl for i, pl in enumerate(stats)]
        return from_local(local, mesh, part, shape + tuple(local.shape[3:])
                          ).redistribute(mesh, stats).to_local()

    m_all = across(m, "max")
    corr = torch.exp(m - m_all)                   # 0 where a shard is empty
    l_all = across(p.sum(dim=-1) * corr, "sum")
    acc_all = across(acc * corr[..., None], "sum")
    out = (acc_all / l_all[..., None]).reshape(B, 1, H, hd).to(ql.dtype)
    return from_local(out, mesh, pq, tuple(q.shape))


def kv_write(kv, k, v, at: int) -> None:
    """Write ``k`` and ``v`` (B, S, KVH, hd) into rows ``at..at+S-1`` of
    the cache buffers ``kv = (k_buf, v_buf)`` (B, T, KVH, hd), in place
    and in the buffers' dtype.  A buffer split by position writes only
    the rows its own shard holds, from the new rows placed as the buffer
    is but whole in position: no shard of the cache moves."""
    for buf, new in zip(kv, (k, v)):
        if not is_sharded(buf, 1):
            buf[:, at:at + new.shape[1]] = new
            continue
        mesh = buf.device_mesh
        pb = list(buf.placements)
        local = buf.to_local()
        t0 = local_offset(tuple(buf.shape), mesh, pb)[1][1]
        lo, hi = max(at, t0), min(at + new.shape[1], t0 + local.shape[1])
        new = new.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                      for p in pb]).to_local()
        if lo < hi:
            local[:, lo - t0:hi - t0] = new[:, lo - at:hi - at]


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
    h = constrain(h * (x @ wu), "batch", "seq", "ff")
    return h @ wd


def heads(t: torch.Tensor, n: int, hd: int, axis: str) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor is first constrained
    to keep whole heads on each shard, split by ``axis`` (``"heads"`` or
    ``"kv_heads"``) or not at all, so that the split never cuts a head."""
    t = constrain(t, "batch", "seq", axis)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` by indexing, or on a DTensor table by
    ``F.embedding``.  A table split by vocab rows is looked up on each
    shard: rows outside it give zeros, and the result is a partial sum
    over the vocab's mesh dim (the caller's ``constrain`` adds it up), as
    XLA gathers from a vocab-sharded operand."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if not vocab:
        return F.embedding(tokens.long(), table)
    tok_pl = (tokens.placements if isinstance(tokens, DTensor)
              else (Replicate(),) * mesh.ndim)
    if len(vocab) > 1 or not isinstance(tok_pl[vocab[0]], Replicate):
        raise NotImplementedError(
            f"a lookup with the table placed {table.placements} and the "
            f"tokens {tok_pl}")
    d = vocab[0]
    # the table whole but for its vocab split (FSDP gathers d_model here);
    # each rank's gradient of it is a partial sum over the mesh dims that
    # split the tokens
    pl = [Shard(0) if i == d else Replicate() for i in range(mesh.ndim)]
    local = table.redistribute(mesh, pl).to_local(grad_placements=[
        Partial() if isinstance(t, Shard) else p for t, p in zip(tok_pl, pl)])
    ids = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    rows = local.shape[0]
    rel = ids.long() - mesh.get_local_rank(d) * rows
    hit = (rel >= 0) & (rel < rows)
    out = F.embedding(rel.clamp(0, rows - 1), local) * hit[..., None].to(
        local.dtype)
    return DTensor.from_local(
        out, mesh, [Partial() if i == d else p for i, p in enumerate(tok_pl)],
        run_check=False, shape=(*tokens.shape, table.shape[1]),
        stride=(tokens.shape[1] * table.shape[1], table.shape[1], 1))


def _vocab_parallel_terms(logits, labels):
    """``(logsumexp(logits), logits[labels])``, each (B, c) and whole on
    the vocab's mesh dim, of logits split by vocab (Megatron's
    vocab-parallel cross-entropy): each shard exponentiates and gathers
    its own columns, and only (B, c) partial sums and maxima cross the
    mesh, in both passes.  The max is taken without gradient (it cancels
    in the log-sum-exp's), and an infinite one counts as 0, as in
    ``torch.logsumexp``."""
    mesh = logits.device_mesh
    d = next(i for i, p in enumerate(logits.placements) if p.is_shard(2))
    shape = tuple(logits.shape[:-1])
    pl = list(logits.placements)

    def summed(local, op="sum"):
        part = from_local(local, mesh, pl[:d] + [Partial(op)] + pl[d + 1:],
                          shape)
        return part.redistribute(mesh, pl[:d] + [Replicate()] + pl[d + 1:])

    local = logits.to_local()
    m = summed(local.detach().amax(dim=-1), "max").to_local()
    m = m.masked_fill(m.abs() == math.inf, 0.0)
    sumexp = summed(torch.exp(local - m[..., None]).sum(dim=-1))
    ids = labels.to_local() if isinstance(labels, DTensor) else labels
    cols = local.shape[-1]
    rel = ids - mesh.get_local_rank(d) * cols
    hit = (rel >= 0) & (rel < cols)
    gold = torch.gather(local, -1, rel.clamp(0, cols - 1)[..., None])[..., 0]
    gold = summed(gold * hit.to(gold.dtype))
    m = from_local(m, mesh, pl[:d] + [Replicate()] + pl[d + 1:], shape)
    return torch.log(sumexp) + m, gold


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
        # (B, c, V), and its gradient, kept split by vocab as XLA keeps it
        logits = constrain(xc @ w, "batch", "seq", "vocab")
        if is_sharded(logits, -1):
            logz, gold = _vocab_parallel_terms(logits, lc)
        else:
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
    return chunked_softmax_xent(x, w_out, _roll_left(tokens), mask)


def _roll_left(tokens: torch.Tensor) -> torch.Tensor:
    """``torch.roll(tokens, -1, dims=1)``; on a DTensor whose sequence is
    whole on each shard (torch has no sharding strategy for ``roll``),
    each shard rolls its own rows."""
    if not isinstance(tokens, DTensor):
        return torch.roll(tokens, -1, dims=1)
    if is_sharded(tokens, 1):
        raise NotImplementedError("roll over a sequence split across the mesh")
    return from_local(torch.roll(tokens.to_local(), -1, dims=1),
                      tokens.device_mesh, tokens.placements,
                      tuple(tokens.shape))
