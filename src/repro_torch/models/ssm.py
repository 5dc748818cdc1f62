"""SSM-family models: Mamba2 (SSD), xLSTM (mLSTM + sLSTM), the Zamba2 hybrid.

Port of :mod:`repro.models.ssm`: training, and serving through
``prefill``/``decode_step`` over the reference's cache layout.  Every
recurrence shares one chunked linear-RNN core (the SSD duality): state
``H_t = a_t * H_{t-1} + v_t (x) k_t``, readout ``y_t = H_t . q_t``,
computed chunk-parallel: quadratic attention-like products inside a chunk,
the state carried from chunk to chunk by a Python loop (the reference's
``lax.scan``), each chunk's body under ``torch.utils.checkpoint``
(non-reentrant) as the reference's ``jax.checkpoint``.  The sLSTM is a
sequential loop over time on an f32 carry.  A decode step is the same
core at one step (a chunk of length 1), as in the reference.

Two rules of :func:`linear_rnn_chunked` differ from a literal transcription:

* **The decay matrix is masked before its exponential.**  Above the
  diagonal ``cum[j] - cum[i]`` is positive and grows with the chunk: at
  initialisation (log-decay ~ -0.69) it passes f32's ``exp`` range, 88.7,
  once a chunk is longer than ~128 steps.  The reference takes ``exp`` of
  the whole matrix and masks after, so its forward keeps the 0 that
  ``where`` selects but its backward multiplies that zero cotangent by
  ``inf``: NaN, in every parameter upstream, at the published chunk of 256.
  Here the masked entries are ``-inf`` before ``exp``, which gives exactly
  0: the forward values are the reference's and the gradient is the true
  one.
* **No product of more than two operands.**  The decay vectors (``eg``,
  ``rem``) are folded into one operand first, then one batched product
  runs, so nothing depends on ``torch.backends.opt_einsum`` choosing a
  contraction order (left to right, ``"bihp,bin,bih->bhpn"`` would build
  a (b, i, h, p, n) intermediate: 3.76 GB per chunk at zamba2's width).

The blocks keep the reference's ``state=None`` argument and
``(x, new_state)`` result.  Serving keeps the attention families' two
deviations (``ROADMAP.md`` §3): ``decode_step`` copies each layer's new
state into the cache it is given, in place, and returns that cache; and
the hybrid raises ``ValueError`` on a full attention cache (a pure
recurrent model has no positional bound).  The cache's ``"len"`` is a
Python int.  Parameter names and shapes are the reference's:
``layers.<i>.<name>``, ``mlstm.<i>.<name>`` and ``slstm.<i>.<name>`` are
its stacked groups (``models.params``), and the hybrid's ``shared_attn``
is the port's :class:`~repro_torch.models.lm.Block` on the same config,
one parameter set applied before every group.

On DTensors (the dry-run and a mesh of real ranks) the blocks keep the
reference's constraints (the Mamba2 input ``xs`` on ``ssm_inner``, the
residual stream after the embedding) and hold each block's output at the
residual's placement, as :mod:`~repro_torch.models.lm`'s sublayers are.
The scans run shard by shard, on plain local tensors: the chunked scan
over the batch rows, heads and value channels that split its values
(``_rnn_sharded``), the sLSTM's loop over the rows and heads that split
its gate inputs; DTensor plans no einsum inside them.  Heads that do not
split the ``model`` axis (xlstm's 4 on a 16-wide one) are made whole
first.  The sLSTM's loop over positions is a
:func:`~repro_torch.models.layers.counted_loop`: a dry-run of a
serving step traces one position and counts it by the sequence length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (counted_loop, embed, heads,
                                       logits_f32, next_token_xent, rms_norm)
from repro_torch.models.lm import Block, _param, _params
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.sharding.specs import (constrain, from_local, shardwise,
                                        zeros)


# ---------------------------------------------------------------------------
# the chunked linear-RNN core (Mamba2 SSD form / gated linear attention)
# ---------------------------------------------------------------------------

def _chunk(h, lac, vc, kc, qc):
    """One chunk: ``h`` (B, H, P, N) entering state; ``lac`` (B, c, H),
    ``vc`` (B, c, H, P), ``kc``/``qc`` (B, c, Hk, N), all f32.  Returns
    the leaving state and the chunk's ``y`` (B, c, H, P)."""
    c = lac.shape[1]
    cum = torch.cumsum(lac, dim=1)                               # (B,c,H)
    # (B, H, j, i) decay matrix with causal mask i <= j, masked before exp
    dj = cum.transpose(1, 2)                                     # (B,H,c)
    dmat = dj[:, :, :, None] - dj[:, :, None, :]                 # (B,H,j,i)
    mask = torch.ones((c, c), dtype=torch.bool, device=lac.device).tril()
    w = torch.exp(dmat.masked_fill(~mask, float("-inf")))
    tot = cum[:, -1, :]                                          # (B,H)
    eg = torch.exp(cum)[..., None]                               # (B,c,H,1)
    rem = torch.exp(tot[:, None, :] - cum)[..., None]            # (B,c,H,1)
    vr = vc * rem
    if kc.shape[2] == 1:  # Mamba2: B/C shared across heads
        ks = kc[:, :, 0]                                         # (B,c,N)
        A = torch.einsum("bjn,bin->bji", qc[:, :, 0], ks)[:, None] * w
        h_upd = torch.einsum("bihp,bin->bhpn", vr, ks)
    else:                 # mLSTM: per head
        A = torch.einsum("bjhn,bihn->bhji", qc, kc) * w
        h_upd = torch.einsum("bihp,bihn->bhpn", vr, kc)
    y_inter = torch.einsum("bjhn,bhpn->bjhp", qc * eg, h)
    y_intra = torch.einsum("bhji,bihp->bjhp", A, vc)
    h_new = h * torch.exp(tot)[:, :, None, None] + h_upd
    return h_new, y_intra + y_inter


def linear_rnn_chunked(log_a, v, k, q, h0, *, chunk: int):
    """Chunk-parallel linear RNN.

    log_a (B, S, H) f32 per-head log decay (<= 0); v (B, S, H, P) values;
    k/q (B, S, Hk, N) with Hk in {1, H}; h0 (B, H, P, N) entering state.
    Returns ``(y (B, S, H, P) f32, h_out (B, H, P, N) f32)``.  A ragged
    tail is padded with zero log-decay and zero inputs, which leave the
    state unchanged.
    """
    if isinstance(v, DTensor):
        return _rnn_sharded(log_a, v, k, q, h0, chunk=chunk)
    B, S, H, P = v.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        v, k, q = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (v, k, q))
    h = h0.float()
    ys = []
    # checkpoint per chunk: autograd would otherwise keep the (B, H, c, c)
    # decay and attention matrices of every chunk; with it only the chunk
    # inputs and the (B, H, P, N) entering states are saved.  ``split``'s
    # backward is one concatenation (a slice's would fill a whole-sequence
    # gradient for every chunk).
    for chunk_in in zip(*(t.float().split(c, dim=1) for t in (log_a, v, k,
                                                              q))):
        h, y = checkpoint(_chunk, h, *chunk_in, use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def _shard_roles(t: DTensor, dims: dict) -> list:
    """Per mesh dim, the role (a key of ``dims``, which maps roles to
    tensor dims of ``t``) under which ``t`` is split there, or None where
    it must be whole."""
    return [next((r for r, d in dims.items() if p == Shard(d)), None)
            for p in t.placements]


def _local_shard(t, mesh, roles: list, dims: dict):
    """``(local, placed)``: the shard of ``t`` (a DTensor, or a plain
    tensor taken as replicated) placed, on each mesh dim, as
    ``Shard(dims[role])`` for that dim's role, or whole where ``t`` lacks
    the role's dim or the dim has none.  Where ``t`` is whole but the role
    splits the work, its gradient is a partial sum over that dim."""
    pl, grad = [], []
    for role in roles:
        d = dims.get(role)
        pl.append(Replicate() if d is None else Shard(d))
        grad.append(Partial() if role is not None and d is None else pl[-1])
    if not isinstance(t, DTensor):
        t = from_local(t, mesh, (Replicate(),) * mesh.ndim, tuple(t.shape))
    return t.redistribute(mesh, pl).to_local(grad_placements=grad), pl


def _rnn_sharded(log_a, v, k, q, h0, *, chunk: int):
    """:func:`linear_rnn_chunked` on DTensors, run shard by shard: the
    recurrence is independent across batch rows, heads and value
    channels, so each rank scans its own (rows, heads, channels) of ``v``
    as ``v`` is split (a split of the sequence is made whole first), with
    the decays, keys and queries narrowed alike and ``h0`` resharded to
    match.  No DTensor einsum is planned."""
    mesh = v.device_mesh
    B, S, H, P = v.shape
    Hk, N = k.shape[2], k.shape[3]
    roles = _shard_roles(v, {"batch": 0, "heads": 2, "chan": 3})

    def local(t, dims):
        return _local_shard(t, mesh, roles, dims)

    v_l, pv = local(v, {"batch": 0, "heads": 2, "chan": 3})
    la_l, _ = local(log_a, {"batch": 0, "heads": 2})
    kd = {"batch": 0, "heads": 2} if Hk == H else {"batch": 0}
    k_l, _ = local(k, kd)
    q_l, _ = local(q, kd)
    h_l, ph = local(h0, {"batch": 0, "heads": 1, "chan": 2})
    y, h = linear_rnn_chunked(la_l, v_l, k_l, q_l, h_l, chunk=chunk)
    return (from_local(y, mesh, pv, (B, S, H, P)),
            from_local(h, mesh, ph, (B, H, P, N)))


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_defs(cfg: ModelConfig, L: int) -> dict:
    D, DI, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.n_ssm_heads, cfg.ssm_conv)
    proj_out = 2 * DI + 2 * N + H
    return {
        "ln": ParamDef((L, D), ("layers", None), "zeros"),
        "in_proj": ParamDef((L, D, proj_out), ("layers", "fsdp", "ssm_inner")),
        "conv_w": ParamDef((L, K, DI), ("layers", "conv_k", "ssm_inner")),
        "conv_b": ParamDef((L, DI), ("layers", "ssm_inner"), "zeros"),
        "A_log": ParamDef((L, H), ("layers", None), "zeros"),
        "D_skip": ParamDef((L, H), ("layers", None), "ones"),
        "dt_bias": ParamDef((L, H), ("layers", None), "zeros"),
        "norm": ParamDef((L, DI), ("layers", "ssm_inner"), "zeros"),
        "out_proj": ParamDef((L, DI, D), ("layers", "ssm_inner", "fsdp")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv; x (B, S, DI), w (K, DI): the K shifted
    products summed left to right in x's dtype.  ``state`` is the last K-1
    inputs for decode; returns ``(y, new_state)``."""
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, :S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y + b, new_state


def mamba2_block(p, x, cfg: ModelConfig, state=None):
    """Returns ``(x + out, new_state)``; ``p`` maps the block's parameter
    names to tensors.  state = ``{"h": (B, H, P, N), "conv": (B, K-1,
    DI)}``."""
    B, S, D = x.shape
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = DI // H
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xs, Bv, Cv, dt = torch.split(h @ p["in_proj"], [DI, DI, N, N, H],
                                    dim=-1)
    conv_state = None if state is None else state["conv"]
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = constrain(F.silu(xs), "batch", "seq", "ssm_inner")
    Bv = F.silu(Bv).float()
    Cv = F.silu(Cv).float()
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    log_a = -torch.exp(p["A_log"].float()) * dt                  # (B,S,H)
    xh = xs.reshape(B, S, H, P).float()
    v = xh * dt[..., None]
    k = Bv[:, :, None, :]                                        # (B,S,1,N)
    q = Cv[:, :, None, :]
    h0 = (torch.zeros((B, H, P, N), device=x.device) if state is None
          else state["h"].float())
    y, h_out = linear_rnn_chunked(log_a, v, k, q, h0, chunk=cfg.ssm_chunk)
    y = y + p["D_skip"].float()[None, None, :, None] * xh
    y = y.reshape(B, S, DI).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = constrain(y @ p["out_proj"], "batch", "seq", "embed")
    new_state = None
    if state is not None:
        new_state = {"h": h_out, "conv": new_conv.to(state["conv"].dtype)}
    return x + out, new_state


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig, L: int) -> dict:
    D, DI, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "ln": ParamDef((L, D), ("layers", None), "zeros"),
        "up": ParamDef((L, D, 2 * DI), ("layers", "fsdp", "ssm_inner")),
        "wq": ParamDef((L, DI, DI), ("layers", None, "ssm_inner")),
        "wk": ParamDef((L, DI, DI), ("layers", None, "ssm_inner")),
        "wv": ParamDef((L, DI, DI), ("layers", None, "ssm_inner")),
        "w_if": ParamDef((L, DI, 2 * H), ("layers", "ssm_inner", None)),
        "norm": ParamDef((L, DI), ("layers", "ssm_inner"), "zeros"),
        "down": ParamDef((L, DI, D), ("layers", "ssm_inner", "fsdp")),
    }


def mlstm_block(p, x, cfg: ModelConfig, state=None):
    """mLSTM: matrix memory + normalizer, which rides along as value
    channel N + 1.  state = ``{"h": (B, H, N + 1, N)}``."""
    B, S, D = x.shape
    DI, H = cfg.d_inner, cfg.n_heads
    N = DI // H
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xi, z = torch.chunk(h @ p["up"], 2, dim=-1)
    # whole heads on each shard (xlstm's 4 do not split a 16-wide axis)
    q = heads(xi @ p["wq"], H, N, "heads")
    k = heads(xi @ p["wk"], H, N, "heads") / math.sqrt(N)
    v = heads(xi @ p["wv"], H, N, "heads")
    gates = (xi @ p["w_if"]).float()
    i_g = torch.sigmoid(gates[..., :H])                          # (B,S,H)
    log_f = shardwise(F.logsigmoid, gates[..., H:])
    # fold normalizer: value channel N+1 carries the input gate itself
    v_aug = torch.cat([v.float() * i_g[..., None], i_g[..., None]], dim=-1)
    h0 = (torch.zeros((B, H, N + 1, N), device=x.device) if state is None
          else state["h"].float())
    y_aug, h_out = linear_rnn_chunked(log_f, v_aug, k, q, h0,
                                      chunk=cfg.ssm_chunk)
    denom = torch.maximum(y_aug[..., N].abs(),
                          torch.ones((), device=x.device))[..., None]
    # whole heads again, so that the gradient's view back to heads holds
    y = constrain((y_aug[..., :N] / denom).reshape(B, S, DI),
                  "batch", "seq", "heads").to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = constrain(y @ p["down"], "batch", "seq", "embed")
    new_state = None if state is None else {"h": h_out}
    return x + out, new_state


def slstm_defs(cfg: ModelConfig, L: int) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    return {
        "ln": ParamDef((L, D), ("layers", None), "zeros"),
        "w_gates": ParamDef((L, D, 4 * D), ("layers", "fsdp", "ssm_inner")),
        "r_gates": ParamDef((L, H, hd, 4 * hd), ("layers", None, None, None)),
        "out": ParamDef((L, D, D), ("layers", "ssm_inner", "fsdp")),
    }


def slstm_block(p, x, cfg: ModelConfig, state=None):
    """sLSTM: per-head scalar memory with recurrent gate contributions, a
    sequential loop over time on the f32 carry ``(c, n, hp)``, ``n``
    starting at 1.  state = ``{"c", "n", "hp"}``, each (B, H, hd)."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    pre = heads(h_in @ p["w_gates"], H, 4 * hd, "heads").float()
    if state is None:
        c = torch.zeros((B, H, hd), device=x.device)
        n = torch.ones((B, H, hd), device=x.device)
        hp = torch.zeros((B, H, hd), device=x.device)
    else:
        c, n, hp = (state[k].float() for k in ("c", "n", "hp"))
    y, c, n, hp = _slstm_scan(pre, p["r_gates"].float(), c, n, hp)
    y = constrain(y.reshape(B, S, D), "batch", "seq", "heads")
    out = constrain(y.to(x.dtype) @ p["out"], "batch", "seq", "embed")
    new_state = None if state is None else {"c": c, "n": n, "hp": hp}
    return x + out, new_state


def _slstm_scan(pre, R, c, n, hp):
    """The sLSTM recurrence over time: ``pre`` (B, S, H, 4hd) f32 gate
    inputs, ``R`` (H, hd, 4hd) the recurrent weights, the carry ``c``,
    ``n``, ``hp`` (B, H, hd).  Returns ``(y (B, S, H, hd), c, n, hp)``.
    On DTensors it runs shard by shard over the rows and heads that split
    ``pre`` (the recurrence mixes a head's channels, so nothing else)."""
    if isinstance(pre, DTensor):
        mesh = pre.device_mesh
        B, S, H, G = pre.shape
        roles = _shard_roles(pre, {"batch": 0, "heads": 2})

        def local(t, dims):
            return _local_shard(t, mesh, roles, dims)

        pre_l, pp = local(pre, {"batch": 0, "heads": 2})
        R_l, _ = local(R, {"heads": 0})
        (c, pc), (n, _), (hp, _) = (local(t, {"batch": 0, "heads": 1})
                                    for t in (c, n, hp))
        y, c, n, hp = _slstm_scan(pre_l, R_l, c, n, hp)
        carry = (B, H, G // 4)
        return (from_local(y, mesh, pp, (B, S, H, G // 4)),
                *(from_local(t, mesh, pc, carry) for t in (c, n, hp)))
    one = torch.ones((), device=pre.device)
    ys = []
    # ``unbind``'s backward is one stack; indexing ``pre[:, t]`` would fill
    # and add a whole (B, S, H, 4hd) gradient at every step
    steps = pre.unbind(1)
    with counted_loop(len(steps)) as loop:  # the dry-run may trace one
        for pre_t in steps[:loop.steps]:
            g = pre_t + torch.einsum("bhd,hdk->bhk", hp, R)     # (B,H,4hd)
            i_g, f_g, z_g, o_g = torch.chunk(g, 4, dim=-1)
            i_g = torch.sigmoid(i_g)
            f_g = torch.sigmoid(f_g)
            c = f_g * c + i_g * torch.tanh(z_g)
            n = f_g * n + i_g
            hp = torch.sigmoid(o_g) * c / torch.maximum(n, one)
            ys.append(hp)
        loop.carries(c, n)
    return torch.stack(ys * (len(steps) // len(ys)), dim=1), c, n, hp


# ---------------------------------------------------------------------------
# the blocks as modules, and the models
# ---------------------------------------------------------------------------

class _SSMBlock(nn.Module):
    """One layer of a stacked group: its parameters are the reference's
    ``defs`` names with the layer axis dropped; ``forward(x, state=None)``
    is the block function's ``(x, new_state)``."""

    def __init__(self, cfg: ModelConfig, defs, fn, device, dtype):
        super().__init__()
        self.cfg = cfg
        self._fn = fn
        _params(self, [(n, d.shape[1:]) for n, d in defs(cfg, 1).items()],
                device, dtype)

    def forward(self, x: torch.Tensor, state=None):
        return self._fn(dict(self.named_parameters(recurse=False)), x,
                        self.cfg, state)


class Mamba2Block(_SSMBlock):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(cfg, mamba2_defs, mamba2_block, device, dtype)


class MLSTMBlock(_SSMBlock):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(cfg, mlstm_defs, mlstm_block, device, dtype)


class SLSTMBlock(_SSMBlock):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(cfg, slstm_defs, slstm_block, device, dtype)


class _RecurrentLM(nn.Module):
    """What the two SSM models share: the embedding, the final norm, the
    untied head, the loss, and the serving entry points over the
    subclass's ``_empty_cache`` and ``_backbone``.
    Parameters are allocated uninitialised on ``device`` in ``dtype``
    (default ``cfg.dtype``), as :class:`~repro_torch.models.lm.
    TransformerLM`'s are."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self._dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = _param((V, D), device, self._dtype)
        self.final_norm = _param((D,), device, self._dtype)
        self.lm_head = _param((D, V), device, self._dtype)

    def _head_defs(self) -> dict:
        D, V = self.cfg.d_model, self.cfg.vocab_size
        return {"embed": ParamDef((V, D), ("vocab", "fsdp"), "embed"),
                "final_norm": ParamDef((D,), (None,), "zeros"),
                "lm_head": ParamDef((D, V), ("fsdp", "vocab"))}

    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        x = constrain(embed(tokens, self.embed), "batch", "seq", "embed")
        return x.to(torch_dtype(self.cfg.dtype))

    def _layer(self, blk: nn.Module, x: torch.Tensor, states=None,
               i: int = 0, remat: bool = True) -> torch.Tensor:
        """``blk(x)``'s output.  In training (``states`` None) it is
        checkpointed when ``remat`` and ``cfg.remat``.  In serving
        ``states`` maps names to layer-stacked state tensors: ``blk``
        reads row ``i`` of each, and its new state is copied into that
        row after it has run."""
        if states is not None:
            x, new = blk(x, {k: v[i] for k, v in states.items()})
            for k, v in new.items():
                states[k][i].copy_(v)
        elif remat and self.cfg.remat:
            x, _ = checkpoint(blk, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, _ = blk(x)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` (B, S)."""
        x = rms_norm(self._backbone(self._embed_in(tokens)), self.final_norm,
                     self.cfg.norm_eps)
        return next_token_xent(x, self.lm_head, tokens)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        return self(batch["tokens"])

    # -- serving -------------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, V) of the last hidden states ``x`` (B, D)."""
        return logits_f32(rms_norm(x, self.final_norm, self.cfg.norm_eps),
                          self.lm_head)

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """``(logits (B, V) f32 of the last position, cache)`` of the
        prompt ``batch["tokens"]`` (B, S): every layer's state starts at
        the reference's zero state and its state after the prompt is
        written into the cache (and, in the hybrid, each application's
        keys and values into a cache of ``max(S, max_len)`` positions)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed_in(tokens)
        cache = self._empty_cache(B, max(S, max_len or 0), x.device)
        x = self._backbone(x, cache)
        cache["len"] = S
        return self._logits(x[:, -1]), cache

    @torch.inference_mode()
    def decode_step(self, cache: dict, batch: dict):
        """One token for every sequence, ``batch["tokens"]`` (B, 1):
        ``(logits (B, V) f32, cache)``.  Every layer's new state is copied
        into ``cache`` in place, and ``cache`` itself is returned with
        ``"len"`` one more.  Only the hybrid's attention cache can be
        full, and then it raises ``ValueError``: a recurrent state has no
        positional bound."""
        clen = int(cache["len"])
        if "attn_k" in cache and clen >= cache["attn_k"].shape[2]:
            raise ValueError(f"decode_step: the cache is full ({clen} of "
                             f"{cache['attn_k'].shape[2]} positions)")
        x = self._backbone(self._embed_in(batch["tokens"]), cache, clen)
        cache["len"] = clen + 1
        return self._logits(x[:, -1]), cache


class MambaLM(_RecurrentLM):
    """Mamba2 LM; with ``cfg.attn_every`` > 0 it is the Zamba2 hybrid: one
    *shared* attention+MLP block (a single parameter set, ``shared_attn``)
    applied before every group of ``attn_every`` Mamba2 layers, the last
    group partial when ``attn_every`` does not divide ``n_layers``, each
    application with its own KV cache in serving.  ``cfg.remat``
    checkpoints each Mamba2 layer, never the shared block."""

    def __init__(self, cfg: ModelConfig, *, device="cpu", dtype=None):
        super().__init__(cfg, device, dtype)
        self.groups = []
        step = cfg.attn_every or cfg.n_layers
        lo = 0
        while lo < cfg.n_layers:
            self.groups.append((lo, min(lo + step, cfg.n_layers)))
            lo += step
        self.layers = nn.ModuleList(Mamba2Block(cfg, device, self._dtype)
                                    for _ in range(cfg.n_layers))
        if cfg.attn_every:
            self.shared_attn = Block(cfg, device, self._dtype)

    @property
    def n_attn_apps(self) -> int:
        return len(self.groups) if self.cfg.attn_every else 0

    def param_defs(self) -> dict:
        """The reference's ParamDef tree."""
        cfg = self.cfg
        defs = {**self._head_defs(), "layers": mamba2_defs(cfg, cfg.n_layers)}
        if cfg.attn_every:
            D, H, KVH, hd, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd, cfg.d_ff)
            defs["shared_attn"] = {
                "ln_attn": ParamDef((D,), (None,), "zeros"),
                "wq": ParamDef((D, H * hd), ("fsdp", "heads")),
                "wk": ParamDef((D, KVH * hd), ("fsdp", "kv_heads")),
                "wv": ParamDef((D, KVH * hd), ("fsdp", "kv_heads")),
                "wo": ParamDef((H * hd, D), ("heads", "fsdp")),
                "ln_mlp": ParamDef((D,), (None,), "zeros"),
                "w_gate": ParamDef((D, F_), ("fsdp", "ff")),
                "w_up": ParamDef((D, F_), ("fsdp", "ff")),
                "w_down": ParamDef((F_, D), ("ff", "fsdp")),
            }
        return defs

    def _backbone(self, x: torch.Tensor, cache: dict | None = None,
                  cache_len: int | None = None) -> torch.Tensor:
        """Every group over ``x``.  In serving ``cache`` is read and
        written in place: application ``g`` of the shared block writes
        ``attn_k[g]``/``attn_v[g]`` (the prompt's rows in prefill,
        ``cache_len`` None; row ``cache_len`` in decode), and Mamba2
        layer ``i`` row ``i`` of ``cache["ssm"]``."""
        B, S, _ = x.shape
        positions = (torch.arange(S, device=x.device)[None, :]
                     if cache_len is None else
                     torch.full((B, 1), cache_len, device=x.device))
        states = None if cache is None else cache["ssm"]
        for g, (lo, hi) in enumerate(self.groups):
            if self.cfg.attn_every:
                kv = (None if cache is None
                      else (cache["attn_k"][g], cache["attn_v"][g]))
                x, _ = self.shared_attn(x, positions, kv, cache_len)
            for i in range(lo, hi):
                x = self._layer(self.layers[i], x, states, i)
        return x

    def _empty_cache(self, B: int, max_len: int, device) -> dict:
        """The cache a prefill starts from: the reference's zero states
        (``_zero_states``: ``h`` f32, ``conv`` in ``cfg.dtype``) and the
        hybrid's attention caches, zeros in ``cfg.dtype`` at ``max_len``
        positions."""
        cfg = self.cfg
        H, P, N = cfg.n_ssm_heads, cfg.d_inner // cfg.n_ssm_heads, cfg.ssm_state
        L, K, DI = cfg.n_layers, cfg.ssm_conv, cfg.d_inner
        dt = torch_dtype(cfg.dtype)
        cache = {"ssm": {
            "h": zeros((L, B, H, P, N), ("layers", "batch", None,
                                         "ssm_inner", "ssm_state"),
                       torch.float32, device),
            "conv": zeros((L, B, K - 1, DI), ("layers", "batch", None,
                                              "ssm_inner"), dt, device)}}
        if cfg.attn_every:
            shape = (self.n_attn_apps, B, max_len, cfg.n_kv_heads, cfg.hd)
            cache["attn_k"], cache["attn_v"] = (
                zeros(shape, (None, "batch", "kv_seq", "kv_heads",
                              "head_dim"), dt, device) for _ in range(2))
        return cache

    def cache_defs(self, batch_size: int, max_len: int) -> dict:
        """The reference's cache layout: ``ssm`` ``h`` (L, B, H, P, N) and
        ``conv`` (L, B, K-1, DI); the hybrid adds ``attn_k`` and
        ``attn_v``, each (applications, B, max_len, KVH, hd)."""
        cfg = self.cfg
        H, P, N = cfg.n_ssm_heads, cfg.d_inner // cfg.n_ssm_heads, cfg.ssm_state
        L, K, DI = cfg.n_layers, cfg.ssm_conv, cfg.d_inner
        defs = {
            "ssm": {
                "h": ParamDef((L, batch_size, H, P, N),
                              ("layers", "batch", None, "ssm_inner",
                               "ssm_state"), "zeros"),
                "conv": ParamDef((L, batch_size, K - 1, DI),
                                 ("layers", "batch", None, "ssm_inner"),
                                 "zeros"),
            },
            "len": ParamDef((), (), "zeros"),
        }
        if cfg.attn_every:
            A, KVH, hd = self.n_attn_apps, cfg.n_kv_heads, cfg.hd
            kv = ParamDef((A, batch_size, max_len, KVH, hd),
                          (None, "batch", "kv_seq", "kv_heads", "head_dim"),
                          "zeros")
            defs["attn_k"] = kv
            defs["attn_v"] = kv
        return defs


class XLSTMLM(_RecurrentLM):
    """xLSTM: ``n_layers // slstm_every`` groups, each ``slstm_every - 1``
    mLSTM blocks then one sLSTM block; ``cfg.remat`` checkpoints only the
    mLSTM blocks.  As in the reference, when ``slstm_every`` does not
    divide ``n_layers`` the last mLSTM blocks are defined but never run
    (their gradients are zero), and ``cache_defs`` declares a state for
    each while ``prefill`` carries only those that run (``ROADMAP.md``
    §3): ``decode_step`` then writes the rows that run of whichever cache
    it is given."""

    def __init__(self, cfg: ModelConfig, *, device="cpu", dtype=None):
        super().__init__(cfg, device, dtype)
        e = cfg.slstm_every or 0
        self.n_slstm = cfg.n_layers // e if e else 0
        self.n_mlstm = cfg.n_layers - self.n_slstm
        self.per_group = (e - 1) if e else cfg.n_layers
        self.mlstm = nn.ModuleList(MLSTMBlock(cfg, device, self._dtype)
                                   for _ in range(self.n_mlstm))
        if self.n_slstm:
            self.slstm = nn.ModuleList(SLSTMBlock(cfg, device, self._dtype)
                                       for _ in range(self.n_slstm))

    def param_defs(self) -> dict:
        """The reference's ParamDef tree."""
        defs = {**self._head_defs(), "mlstm": mlstm_defs(self.cfg,
                                                          self.n_mlstm)}
        if self.n_slstm:
            defs["slstm"] = slstm_defs(self.cfg, self.n_slstm)
        return defs

    def _backbone(self, x: torch.Tensor, cache: dict | None = None,
                  cache_len: int | None = None) -> torch.Tensor:
        """Every group over ``x``.  In serving mLSTM block ``i`` reads and
        writes row ``i`` of ``cache["ssm"]["m"]`` and sLSTM block ``g``
        row ``g`` of ``cache["ssm"]["s"]``, in place."""
        m = s = None
        if cache is not None:
            m, s = cache["ssm"]["m"], cache["ssm"]["s"]
        for g in range(max(self.n_slstm, 1)):
            lo = g * self.per_group
            for i in range(lo, min(lo + self.per_group, self.n_mlstm)):
                x = self._layer(self.mlstm[i], x, m, i)
            if self.n_slstm:
                x = self._layer(self.slstm[g], x, s, g, remat=False)
        return x

    def _empty_cache(self, B: int, max_len: int, device) -> dict:
        """The cache a prefill starts from, the reference's zero states:
        f32, ``n`` at ones, the mLSTM state only for the blocks that run (``n_slstm *
        (slstm_every - 1)`` of them, or all without sLSTM blocks)."""
        cfg = self.cfg
        H = cfg.n_heads
        N, hd = cfg.d_inner // H, cfg.d_model // H
        n_run = (min(self.n_slstm * self.per_group, self.n_mlstm)
                 if self.n_slstm else self.n_mlstm)
        s_shape = (self.n_slstm, B, H, hd)
        s_log = ("layers", "batch", None, None)
        return {"ssm": {
            "m": {"h": zeros((n_run, B, H, N + 1, N),
                             ("layers", "batch", None, None, None),
                             torch.float32, device)},
            "s": {"c": zeros(s_shape, s_log, torch.float32, device),
                  "n": zeros(s_shape, s_log, torch.float32, device) + 1.0,
                  "hp": zeros(s_shape, s_log, torch.float32, device)}}}

    def cache_defs(self, batch_size: int, max_len: int) -> dict:
        """The reference's cache layout: ``ssm`` ``m`` ``h`` (n_mlstm, B,
        H, N+1, N) and ``s`` ``c``/``n``/``hp`` (n_slstm, B, H, hd), ``n``
        initialised to ones."""
        cfg = self.cfg
        H = cfg.n_heads
        N, hd = cfg.d_inner // H, cfg.d_model // H
        return {
            "ssm": {
                # dim 3 is N+1 (the normalizer channel): never sharded
                "m": {"h": ParamDef((self.n_mlstm, batch_size, H, N + 1, N),
                                    ("layers", "batch", None, None, None),
                                    "zeros")},
                "s": {k: ParamDef((self.n_slstm, batch_size, H, hd),
                                  ("layers", "batch", None, None),
                                  "ones" if k == "n" else "zeros")
                      for k in ("c", "n", "hp")},
            },
            "len": ParamDef((), (), "zeros"),
        }
