"""Decoder-only transformer LM: dense GQA (yi / codeqwen / gemma / qwen3),
MoE (grok / qwen3-moe), and VLM with interleaved gated cross-attention
(llama-3.2-vision).

Port of :mod:`repro.models.lm`: training, and serving through
``prefill``/``decode_step`` over the reference's cache layout.  One
:class:`Block` module per layer sits in a ``ModuleList`` and a Python loop
takes the place of the reference's ``lax.scan``; in training ``cfg.remat``
checkpoints each block (``torch.utils.checkpoint``, non-reentrant), never
the VLM's cross-attention, as the reference does.  For the VLM the layers
run in ``cross_attn_every``-sized groups, each after its group's
:class:`CrossAttention`, in prefill and decode too (the vision keys and
values are recomputed each step, as the reference does).  Parameter names
and shapes are the reference's (``models.params`` converts the stacked
layout), and weights multiply as ``x @ w``.

Serving differs from the reference in two ways (``ROADMAP.md`` §3):
``decode_step`` writes the new token's keys and values into the cache it
is given, in place, and returns that cache; and it raises ``ValueError``
on a full cache, where the reference overwrites the last row.  The cache's
``"len"`` is a Python int, so that check costs no device sync.

Under sharding rules (``repro_torch.sharding.set_rules``) and on
DTensor parameters the model constrains its activations at the
reference's points, and expands GQA keys and values to the query heads
where the kv heads cannot shard the model axis (:func:`_kv_expand`).
Each sublayer's output is also constrained to the residual stream's
(batch, seq, embed) placement: XLA's propagation holds it there, while
DTensor would carry a partial sum down the stream.  Without rules every
constraint is a no-op and nothing expands.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (decode_attention, embed,
                                       flash_attention, glu_mlp, heads,
                                       kv_write, logits_f32, next_token_xent,
                                       rms_norm, rope)
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.sharding.specs import (constrain, current_rules,
                                        is_sharded, zeros)


def _kv_expand(cfg: ModelConfig) -> bool:
    """GQA -> MHA expansion when kv heads can't shard the model axis.

    Expanding K/V to the full head count keeps every device's attention
    local: the repeat is sharded on `heads`, so each device materialises
    only its own slice (reference ``lm.py:27-40``)."""
    r = current_rules()
    return (r is not None and cfg.n_kv_heads < cfg.n_heads
            and r.size("kv_heads") == 1 and r.size("heads") > 1
            and r.size("head_dim") == 1)


def _expand(cfg: ModelConfig, t: torch.Tensor, seq: str) -> torch.Tensor:
    """(B, T, KVH, hd) -> (B, T, H, hd), each kv head repeated for its
    queries (``jnp.repeat`` on axis 2) and sharded on `heads`."""
    t = t.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
    return constrain(t, "batch", seq, "heads", "head_dim")


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def _params(module: nn.Module, shapes, device, dtype) -> None:
    for name, shape in shapes:
        setattr(module, name, _param(shape, device, dtype))


class Block(nn.Module):
    """One pre-norm layer: GQA self-attention, then the GLU MLP or, in the
    MoE family, the expert sublayer.  ``forward`` returns ``(x, aux)``:
    aux is the MoE load-balancing loss, ``None`` without experts."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        D, H, KVH, hd, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.d_ff)
        _params(self, [("ln_attn", (D,)), ("wq", (D, H * hd)),
                       ("wk", (D, KVH * hd)), ("wv", (D, KVH * hd)),
                       ("wo", (H * hd, D)), ("ln_mlp", (D,))], device, dtype)
        if cfg.qk_norm:
            _params(self, [("q_norm", (hd,)), ("k_norm", (hd,))], device,
                    dtype)
        if cfg.n_experts:
            E, Fe = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
            _params(self, [("router", (D, E)), ("we_gate", (E, D, Fe)),
                           ("we_up", (E, D, Fe)), ("we_down", (E, Fe, D))],
                    device, dtype)
        else:
            _params(self, [("w_gate", (D, F_)), ("w_up", (D, F_)),
                           ("w_down", (F_, D))], device, dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, kv=None,
                cache_len: int | None = None):
        """``(x, aux)``; in serving ``kv`` is this layer's cache buffers
        (:meth:`attention`)."""
        return self.mlp(self.attention(x, positions, kv, cache_len))

    def attention(self, x, positions, kv=None, cache_len: int | None = None):
        """``x`` + causal self-attention.  ``kv``, in serving, is this
        layer's ``(k_buf, v_buf)`` cache, each (B, T, KVH, hd).  Prefill
        (``cache_len`` None) writes the prompt's keys and values into rows
        0..S-1 and attends over the prompt; decode (S = 1) writes row
        ``cache_len`` in place and attends over the first ``cache_len + 1``
        rows."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h = rms_norm(x, self.ln_attn, cfg.norm_eps)
        q = heads(h @ self.wq, H, hd, "heads")
        k = heads(h @ self.wk, KVH, hd, "kv_heads")
        v = heads(h @ self.wv, KVH, hd, "kv_heads")
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        q = constrain(q, "batch", "seq", "heads", "head_dim")
        k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
        v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
        if kv is not None:
            kv_write(kv, k, v, cache_len or 0)
        expand = _kv_expand(cfg)
        if cache_len is None:
            ka, va = k, v
            if expand:
                ka, va = _expand(cfg, k, "seq"), _expand(cfg, v, "seq")
            attn = flash_attention(q, ka, va, causal=True,
                                   q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                   mode=cfg.causal_mode)
        else:
            n = cache_len + 1
            # a cache split by position attends whole, masked past n
            ka, va = ((kv[0], kv[1]) if is_sharded(kv[0], 1)
                      else (kv[0][:, :n], kv[1][:, :n]))
            if expand:
                ka, va = _expand(cfg, ka, "kv_seq"), _expand(cfg, va, "kv_seq")
            attn = decode_attention(q, ka, va, n)
        out = constrain(attn.reshape(B, S, H * hd) @ self.wo,
                        "batch", "seq", "embed")
        return x + out

    def mlp(self, x):
        cfg = self.cfg
        h = rms_norm(x, self.ln_mlp, cfg.norm_eps)
        if cfg.n_experts:
            block_fn = (moe_mod.moe_block_rowwise
                        if cfg.moe_dispatch == "rowwise" else moe_mod.moe_block)
            out, probs = block_fn(h, self.router, self.we_gate, self.we_up,
                                  self.we_down, top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  act=cfg.act)
            return (x + constrain(out, "batch", "seq", "embed"),
                    moe_mod.moe_aux_loss(probs))
        return x + constrain(glu_mlp(h, self.w_gate, self.w_up, self.w_down,
                                     cfg.act), "batch", "seq", "embed"), None


class CrossAttention(nn.Module):
    """Gated cross-attention over the vision embeddings (llama-3.2-vision
    style): ``x + tanh(gate) * attn(x, memory)``, the gate's tanh in f32."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        _params(self, [("ln", (D,)), ("wq", (D, H * hd)),
                       ("wk", (D, KVH * hd)), ("wv", (D, KVH * hd)),
                       ("wo", (H * hd, D)), ("gate", ())], device, dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h = rms_norm(x, self.ln, cfg.norm_eps)
        q = heads(h @ self.wq, H, hd, "heads")
        k = heads(memory @ self.wk, KVH, hd, "kv_heads")
        v = heads(memory @ self.wv, KVH, hd, "kv_heads")
        q = constrain(q, "batch", "seq", "heads", "head_dim")
        attn = flash_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                               kv_chunk=cfg.kv_chunk)
        out = attn.reshape(B, S, H * hd) @ self.wo
        gate = torch.tanh(self.gate.float()).to(x.dtype)
        return x + gate * constrain(out, "batch", "seq", "embed")


class TransformerLM(nn.Module):
    """The dense, MoE and VLM LMs.  Parameters are allocated uninitialised
    on ``device`` in ``dtype`` (default ``cfg.dtype``); fill them with
    :func:`repro_torch.models.params.init_params` and
    :func:`~repro_torch.models.params.from_reference`."""

    def __init__(self, cfg: ModelConfig, *, device="cpu", dtype=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            from repro_torch.models.api import model_class
            raise ValueError(
                f"{cfg.family} family: TransformerLM holds the dense, MoE "
                f"and VLM families; {model_class(cfg).__name__} holds this "
                f"one (models.api.build_model)")
        if cfg.family == "vlm" and cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"cross_attn_every {cfg.cross_attn_every}")
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = _param((V, D), device, dtype)
        self.layers = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param((D,), device, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param((D, V), device, dtype)
        if cfg.family == "vlm":
            self.cross = nn.ModuleList(
                CrossAttention(cfg, device, dtype)
                for _ in range(cfg.n_layers // cfg.cross_attn_every))

    # -- parameters ----------------------------------------------------------
    def param_defs(self) -> dict:
        """The reference's ParamDef tree."""
        cfg = self.cfg
        L, D, H, KVH, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd)
        V, F_ = cfg.vocab_size, cfg.d_ff
        layer = {
            "ln_attn": ParamDef((L, D), ("layers", None), "zeros"),
            "wq": ParamDef((L, D, H * hd), ("layers", "fsdp", "heads")),
            "wk": ParamDef((L, D, KVH * hd), ("layers", "fsdp", "kv_heads")),
            "wv": ParamDef((L, D, KVH * hd), ("layers", "fsdp", "kv_heads")),
            "wo": ParamDef((L, H * hd, D), ("layers", "heads", "fsdp")),
            "ln_mlp": ParamDef((L, D), ("layers", None), "zeros"),
        }
        if cfg.qk_norm:
            layer["q_norm"] = ParamDef((L, hd), ("layers", None), "zeros")
            layer["k_norm"] = ParamDef((L, hd), ("layers", None), "zeros")
        if cfg.n_experts:
            E, Fe = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
            layer.update({
                "router": ParamDef((L, D, E), ("layers", None, None)),
                "we_gate": ParamDef((L, E, D, Fe), ("layers", "experts", "fsdp", "expert_ff")),
                "we_up": ParamDef((L, E, D, Fe), ("layers", "experts", "fsdp", "expert_ff")),
                "we_down": ParamDef((L, E, Fe, D), ("layers", "experts", "expert_ff", "fsdp")),
            })
        else:
            layer.update({
                "w_gate": ParamDef((L, D, F_), ("layers", "fsdp", "ff")),
                "w_up": ParamDef((L, D, F_), ("layers", "fsdp", "ff")),
                "w_down": ParamDef((L, F_, D), ("layers", "ff", "fsdp")),
            })
        defs = {
            "embed": ParamDef((V, D), ("vocab", "fsdp"), "embed"),
            "layers": layer,
            "final_norm": ParamDef((D,), (None,), "zeros"),
        }
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((D, V), ("fsdp", "vocab"))
        if cfg.family == "vlm":
            nC = cfg.n_layers // cfg.cross_attn_every
            defs["cross"] = {
                "ln": ParamDef((nC, D), (None, None), "zeros"),
                "wq": ParamDef((nC, D, H * hd), (None, "fsdp", "heads")),
                "wk": ParamDef((nC, D, KVH * hd), (None, "fsdp", "kv_heads")),
                "wv": ParamDef((nC, D, KVH * hd), (None, "fsdp", "kv_heads")),
                "wo": ParamDef((nC, H * hd, D), (None, "heads", "fsdp")),
                "gate": ParamDef((nC,), (None,), "zeros"),
            }
        return defs

    # -- forward -------------------------------------------------------------
    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        x = constrain(embed(tokens, self.embed), "batch", "seq", "embed")
        return x.to(torch_dtype(self.cfg.dtype))

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _blocks(self, first: int, last: int, x, positions, aux: list,
                kv=None, cache_len: int | None = None):
        """Layers ``first..last-1`` over ``x``; their MoE aux losses are
        appended to ``aux``.  In serving ``kv`` is the whole cache's
        ``(k, v)``, each (L, B, T, KVH, hd), and layer ``i`` gets its
        slice; ``cfg.remat`` applies in training only."""
        for i in range(first, last):
            blk = self.layers[i]
            if kv is not None:
                x, a = blk(x, positions, (kv[0][i], kv[1][i]), cache_len)
            elif self.cfg.remat:
                x, a = checkpoint(blk, x, positions, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = blk(x, positions)
            if a is not None:
                aux.append(a)
        return x

    def _backbone(self, x, positions, vision_embed, aux: list, kv=None,
                  cache_len: int | None = None) -> torch.Tensor:
        """Every layer over ``x``; the VLM's groups each after their
        cross-attention to ``vision_embed``."""
        cfg = self.cfg
        if cfg.family != "vlm":
            return self._blocks(0, cfg.n_layers, x, positions, aux, kv,
                                cache_len)
        every = cfg.cross_attn_every
        vis = vision_embed.to(x.dtype)
        for g, cross in enumerate(self.cross):
            x = cross(x, vis)
            x = self._blocks(g * every, (g + 1) * every, x, positions, aux,
                             kv, cache_len)
        return x

    def forward(self, tokens: torch.Tensor,
                vision_embed: torch.Tensor | None = None) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` (B, S), plus the MoE
        load-balancing term; the VLM attends to ``vision_embed`` (B, T, D)."""
        cfg = self.cfg
        S = tokens.shape[1]
        x = self._embed_in(tokens)
        positions = torch.arange(S, device=tokens.device)[None, :]
        aux: list[torch.Tensor] = []
        x = self._backbone(x, positions, vision_embed, aux)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        loss = next_token_xent(x, self._head(), tokens)
        if aux:  # the reference adds 0.01 * aux / n_layers, 0 without MoE
            loss = loss + 0.01 * sum(aux) / max(cfg.n_layers, 1)
        return loss

    def loss_fn(self, batch: dict) -> torch.Tensor:
        vision = batch["vision_embed"] if self.cfg.family == "vlm" else None
        return self(batch["tokens"], vision)

    # -- serving -------------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, V) of the last hidden states ``x`` (B, D)."""
        return logits_f32(rms_norm(x, self.final_norm, self.cfg.norm_eps),
                          self._head())

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """``(logits (B, V) f32 of the last position, cache)`` of the
        prompt ``batch["tokens"]`` (B, S) (and the VLM's
        ``batch["vision_embed"]``).  Each layer's keys and values are
        written once into a cache preallocated at ``max(S, max_len)``
        positions, zeros past S."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed_in(tokens)
        kv = tuple(zeros(d.shape, d.logical, torch_dtype(cfg.dtype), x.device)
                   for d in self.cache_defs(B, max(S, max_len or 0))["kv"])
        positions = torch.arange(S, device=x.device)[None, :]
        vision = batch["vision_embed"] if cfg.family == "vlm" else None
        x = self._backbone(x, positions, vision, [], kv)
        cache = {"kv": kv, "len": S}
        if cfg.family == "vlm":
            cache["vision_embed"] = vision
        return self._logits(x[:, -1]), cache

    @torch.inference_mode()
    def decode_step(self, cache: dict, batch: dict):
        """One token for every sequence, ``batch["tokens"]`` (B, 1):
        ``(logits (B, V) f32, cache)``.  The token's keys and values are
        written into row ``cache["len"]`` of ``cache`` in place, and
        ``cache`` itself is returned with ``"len"`` one more; a full cache
        raises ``ValueError``."""
        clen = int(cache["len"])
        T = cache["kv"][0].shape[2]
        if clen >= T:
            raise ValueError(f"decode_step: the cache is full ({clen} of {T} "
                             f"positions)")
        tokens = batch["tokens"]
        x = self._embed_in(tokens)
        positions = torch.full((tokens.shape[0], 1), clen, device=x.device)
        x = self._backbone(x, positions, cache.get("vision_embed"), [],
                           cache["kv"], clen)
        cache["len"] = clen + 1
        return self._logits(x[:, -1]), cache

    def cache_defs(self, batch_size: int, max_len: int) -> dict:
        """The reference's cache layout: ``kv`` is (k, v), each
        (L, B, max_len, KVH, hd); the VLM adds ``vision_embed``."""
        cfg = self.cfg
        L, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        kv = ParamDef((L, batch_size, max_len, KVH, hd),
                      ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                      "zeros")
        defs = {"kv": (kv, kv), "len": ParamDef((), (), "zeros")}
        if cfg.family == "vlm":
            defs["vision_embed"] = ParamDef(
                (batch_size, cfg.vision_tokens, cfg.d_model),
                ("batch", None, "embed"), "zeros")
        return defs
