"""Whisper-style encoder-decoder (audio backbone only).

Port of :mod:`repro.models.whisper`: training and serving.  As in the
reference the conv frontend is a stub: the batch carries precomputed frame
embeddings ``frames`` (B, S_enc, d_model).  The encoder is non-causal
self-attention over frames with sinusoidal positions; the decoder is
causal self-attention, cross-attention over the encoder output and the GLU
MLP with learned positions and no rope.  With ``cfg.remat`` every layer is
checkpointed while gradients are recorded (the reference checkpoints the
encoder in every mode, which changes no value).  Parameter names are the
reference's: ``enc.<i>.<name>`` and ``dec.<i>.<name>`` are its stacked
``enc/<name>`` and ``dec/<name>`` (``models.params``).

Serving keeps the reference's cache: ``prefill`` encodes the frames once
and caches the decoder's self keys and values, always padded to
``cfg.max_decoder_len``, and each layer's cross keys and values over all
the frames; ``cache_defs`` takes the encoder length where the other
families take ``max_len``.  As in :mod:`repro_torch.models.lm`,
``decode_step`` writes the cache it is given in place and raises
``ValueError`` on a full cache (``ROADMAP.md`` §3).

Under sharding rules the encoder's input and its queries are constrained
as in the reference (``whisper.py:74, 82``), and the decoder's embedded
tokens and each sublayer's output to the residual stream's placement (as
in ``models.lm``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (decode_attention, embed,
                                       flash_attention, glu_mlp, heads,
                                       kv_write, logits_f32, next_token_xent,
                                       rms_norm, sinusoid_positions)
from repro_torch.models.lm import _param, _params
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.sharding.specs import constrain, zeros


def _attn_defs(L, D, H, KVH, hd, prefix=""):
    return {
        prefix + "ln": ParamDef((L, D), ("layers", None), "zeros"),
        prefix + "wq": ParamDef((L, D, H * hd), ("layers", "fsdp", "heads")),
        prefix + "wk": ParamDef((L, D, KVH * hd), ("layers", "fsdp", "kv_heads")),
        prefix + "wv": ParamDef((L, D, KVH * hd), ("layers", "fsdp", "kv_heads")),
        prefix + "wo": ParamDef((L, H * hd, D), ("layers", "heads", "fsdp")),
    }


def _mlp_defs(L, D, F):
    return {
        "ln_mlp": ParamDef((L, D), ("layers", None), "zeros"),
        "w_gate": ParamDef((L, D, F), ("layers", "fsdp", "ff")),
        "w_up": ParamDef((L, D, F), ("layers", "fsdp", "ff")),
        "w_down": ParamDef((L, F, D), ("layers", "ff", "fsdp")),
    }


class _Layer(nn.Module):
    """One encoder layer, or with ``cross`` one decoder layer; its
    parameters are named as in the reference's stacked groups."""

    def __init__(self, cfg: ModelConfig, device, dtype, *, cross: bool):
        super().__init__()
        self.cfg = cfg
        D, H, KVH, hd, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.d_ff)
        for prefix in ("", "x_") if cross else ("",):
            _params(self, [(prefix + "ln", (D,)), (prefix + "wq", (D, H * hd)),
                           (prefix + "wk", (D, KVH * hd)),
                           (prefix + "wv", (D, KVH * hd)),
                           (prefix + "wo", (H * hd, D))], device, dtype)
        _params(self, [("ln_mlp", (D,)), ("w_gate", (D, F_)),
                       ("w_up", (D, F_)), ("w_down", (F_, D))], device, dtype)

    def _attend(self, x, memory, prefix: str, causal: bool, store=None):
        """``x`` + attention of ``x`` over ``memory`` (``x`` itself when
        None) with the ``prefix`` weights; the keys and values are also
        written into rows 0.. of the cache buffers ``store``, if given."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        p = lambda n: getattr(self, prefix + n)
        h = rms_norm(x, p("ln"), cfg.norm_eps)
        src = h if memory is None else memory
        q = heads(h @ p("wq"), H, hd, "heads")
        k = heads(src @ p("wk"), KVH, hd, "kv_heads")
        v = heads(src @ p("wv"), KVH, hd, "kv_heads")
        if memory is None and not causal:  # the encoder
            q = constrain(q, "batch", "seq", "heads", "head_dim")
        if store is not None:
            kv_write(store, k, v, 0)
        a = flash_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
        return x + constrain(a.reshape(B, S, H * hd) @ p("wo"),
                             "batch", "seq", "embed")

    def _mlp(self, x):
        cfg = self.cfg
        h2 = rms_norm(x, self.ln_mlp, cfg.norm_eps)
        return x + constrain(glu_mlp(h2, self.w_gate, self.w_up, self.w_down,
                                     cfg.act), "batch", "seq", "embed")

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                store=None) -> torch.Tensor:
        """An encoder layer without ``memory``, a decoder layer with it.
        In prefill ``store`` is the decoder layer's ``(k, v, xk, xv)``
        cache buffers: the prompt's self keys and values fill rows 0..S-1,
        the cross keys and values every row."""
        if memory is None:
            x = self._attend(x, None, "", causal=False)
        else:
            x = self._attend(x, None, "", causal=True,
                             store=None if store is None else store[:2])
            x = self._attend(x, memory, "x_", causal=False,
                             store=None if store is None else store[2:])
        return self._mlp(x)

    def decode(self, x: torch.Tensor, store, cache_len: int) -> torch.Tensor:
        """One decoder step, ``x`` (B, 1, D): the self keys and values go
        into row ``cache_len`` of ``store``'s ``(k, v)`` in place and the
        query attends over ``cache_len + 1`` rows; the cross-attention
        reads the cached ``(xk, xv)`` over every frame."""
        cfg = self.cfg
        B = x.shape[0]
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        k_buf, v_buf, xk, xv = store
        h = rms_norm(x, self.ln, cfg.norm_eps)
        q = heads(h @ self.wq, H, hd, "heads")
        kv_write((k_buf, v_buf), heads(h @ self.wk, KVH, hd, "kv_heads"),
                 heads(h @ self.wv, KVH, hd, "kv_heads"), cache_len)
        n = cache_len + 1
        a = decode_attention(q, k_buf[:, :n], v_buf[:, :n], n)
        x = x + constrain(a.reshape(B, 1, H * hd) @ self.wo,
                          "batch", "seq", "embed")
        h = rms_norm(x, self.x_ln, cfg.norm_eps)
        q = heads(h @ self.x_wq, H, hd, "heads")
        a = decode_attention(q, xk, xv, xk.shape[1])
        x = x + constrain(a.reshape(B, 1, H * hd) @ self.x_wo,
                          "batch", "seq", "embed")
        return self._mlp(x)


class WhisperModel(nn.Module):
    """The audio encoder-decoder.  Parameters are allocated uninitialised
    on ``device`` in ``dtype`` (default ``cfg.dtype``), as
    :class:`~repro_torch.models.lm.TransformerLM`'s are."""

    def __init__(self, cfg: ModelConfig, *, device="cpu", dtype=None):
        super().__init__()
        if cfg.encoder_layers <= 0:
            raise ValueError("the audio family needs encoder_layers > 0")
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = _param((V, D), device, dtype)
        self.pos_dec = _param((cfg.max_decoder_len, D), device, dtype)
        self.enc = nn.ModuleList(_Layer(cfg, device, dtype, cross=False)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(_Layer(cfg, device, dtype, cross=True)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = _param((D,), device, dtype)
        self.final_norm = _param((D,), device, dtype)
        self.lm_head = _param((D, V), device, dtype)

    def param_defs(self) -> dict:
        """The reference's ParamDef tree."""
        cfg = self.cfg
        D, H, KVH, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.d_ff, cfg.vocab_size)
        Le, Ld = cfg.encoder_layers, cfg.n_layers
        enc = {**_attn_defs(Le, D, H, KVH, hd), **_mlp_defs(Le, D, F)}
        dec = {**_attn_defs(Ld, D, H, KVH, hd),
               **_attn_defs(Ld, D, H, KVH, hd, prefix="x_"),
               **_mlp_defs(Ld, D, F)}
        return {
            "embed": ParamDef((V, D), ("vocab", "fsdp"), "embed"),
            "pos_dec": ParamDef((cfg.max_decoder_len, D), (None, None)),
            "enc": enc,
            "dec": dec,
            "enc_norm": ParamDef((D,), (None,), "zeros"),
            "final_norm": ParamDef((D,), (None,), "zeros"),
            "lm_head": ParamDef((D, V), ("fsdp", "vocab")),
        }

    def _run(self, layer, x, memory=None):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer, x, memory, use_reentrant=False,
                              preserve_rng_state=False)
        return layer(x, memory)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        _, S, D = frames.shape
        x = frames.to(torch_dtype(cfg.dtype))
        x = x + sinusoid_positions(S, D, x.device).to(x.dtype)[None]
        x = constrain(x, "batch", "seq", "embed")
        for layer in self.enc:
            x = self._run(layer, x)
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _embed_dec(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """Decoder inputs: the tokens' embeddings plus the learned
        positions ``first..first+S-1``."""
        x = constrain(embed(tokens, self.embed), "batch", "seq", "embed")
        x = x.to(torch_dtype(self.cfg.dtype))
        return x + self.pos_dec[None, first:first + tokens.shape[1]].to(
            x.dtype)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """Mean next-token cross-entropy of the decoder ``tokens`` (B, S)
        given the encoder ``frames`` (B, S_enc, D)."""
        cfg = self.cfg
        memory = self.encode(frames)
        x = self._embed_dec(tokens, 0)
        for layer in self.dec:
            x = self._run(layer, x, memory)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return next_token_xent(x, self.lm_head, tokens)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        return self(batch["frames"], batch["tokens"])

    # -- serving -------------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, V) of the last hidden states ``x`` (B, D)."""
        return logits_f32(rms_norm(x, self.final_norm, self.cfg.norm_eps),
                          self.lm_head)

    @torch.inference_mode()
    def prefill(self, batch: dict, max_len: int | None = None):
        """Encode ``batch["frames"]`` and run the decoder prompt
        ``batch["tokens"]`` (B, S): ``(logits (B, V) f32 of the last
        position, cache)``.  The self keys and values are cached padded to
        ``cfg.max_decoder_len`` whatever ``max_len`` says (accepted for
        the families' common API, as in the reference), and each layer's
        cross keys and values over every frame."""
        cfg = self.cfg
        memory = self.encode(batch["frames"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        if S > cfg.max_decoder_len:
            raise ValueError(f"prefill: {S} decoder tokens, more than "
                             f"max_decoder_len {cfg.max_decoder_len}")
        dt, dev = torch_dtype(cfg.dtype), memory.device
        cache = {n: zeros(d.shape, d.logical, dt, dev) for n, d in
                 self.cache_defs(B, memory.shape[1]).items() if d.shape}
        cache["len"] = S
        x = self._embed_dec(tokens, 0)
        for i, layer in enumerate(self.dec):
            x = layer(x, memory, _layer_cache(cache, i))
        return self._logits(x[:, -1]), cache

    @torch.inference_mode()
    def decode_step(self, cache: dict, batch: dict):
        """One token for every sequence, ``batch["tokens"]`` (B, 1):
        ``(logits (B, V) f32, cache)``, ``cache`` written in place and
        returned with ``"len"`` one more; a full cache (``len`` at
        ``max_decoder_len``) raises ``ValueError``."""
        clen = int(cache["len"])
        T = cache["k"].shape[2]
        if clen >= T:
            raise ValueError(f"decode_step: the cache is full ({clen} of {T} "
                             f"positions)")
        x = self._embed_dec(batch["tokens"], clen)
        for i, layer in enumerate(self.dec):
            x = layer.decode(x, _layer_cache(cache, i), clen)
        cache["len"] = clen + 1
        return self._logits(x[:, -1]), cache

    def cache_defs(self, batch_size: int, enc_len: int) -> dict:
        """The reference's cache layout: self ``k``/``v`` (Ld, B,
        max_decoder_len, KVH, hd), cross ``xk``/``xv`` (Ld, B, enc_len,
        KVH, hd)."""
        cfg = self.cfg
        Ld, KVH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        self_kv = ParamDef((Ld, batch_size, cfg.max_decoder_len, KVH, hd),
                           ("layers", "batch", None, "kv_heads", "head_dim"),
                           "zeros")
        cross_kv = ParamDef((Ld, batch_size, enc_len, KVH, hd),
                            ("layers", "batch", "kv_seq", "kv_heads",
                             "head_dim"), "zeros")
        return {"k": self_kv, "v": self_kv, "xk": cross_kv, "xv": cross_kv,
                "len": ParamDef((), (), "zeros")}


def _layer_cache(cache: dict, i: int) -> tuple:
    """Decoder layer ``i``'s ``(k, v, xk, xv)`` cache buffers (views)."""
    return tuple(cache[n][i] for n in ("k", "v", "xk", "xv"))
