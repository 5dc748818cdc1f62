"""Whisper-style encoder-decoder (audio backbone only).

Port of :mod:`repro.models.whisper`, train mode.  As in the reference the
conv frontend is a stub: the batch carries precomputed frame embeddings
``frames`` (B, S_enc, d_model).  The encoder is non-causal self-attention
over frames with sinusoidal positions, each layer checkpointed in every
mode; the decoder is causal self-attention, cross-attention over the
encoder output and the GLU MLP with learned positions, each layer
checkpointed in train when ``cfg.remat``.  Parameter names are the
reference's: ``enc.<i>.<name>`` and ``dec.<i>.<name>`` are its stacked
``enc/<name>`` and ``dec/<name>`` (``models.params``).

``prefill`` and ``decode_step`` (serving, ``ROADMAP.md`` §1 item 5) are not
ported yet.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (flash_attention, glu_mlp,
                                       next_token_xent, rms_norm,
                                       sinusoid_positions)
from repro_torch.models.lm import _SERVING, _param, _params
from repro_torch.models.params import ParamDef, torch_dtype


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

    def _attend(self, x, memory, prefix: str, causal: bool):
        """``x`` + attention of ``x`` over ``memory`` (``x`` itself when
        None) with the ``prefix`` weights."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        p = lambda n: getattr(self, prefix + n)
        h = rms_norm(x, p("ln"), cfg.norm_eps)
        src = h if memory is None else memory
        q = (h @ p("wq")).reshape(B, S, H, hd)
        k = (src @ p("wk")).reshape(B, -1, KVH, hd)
        v = (src @ p("wv")).reshape(B, -1, KVH, hd)
        a = flash_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
        return x + a.reshape(B, S, H * hd) @ p("wo")

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None
                ) -> torch.Tensor:
        """An encoder layer without ``memory``, a decoder layer with it."""
        cfg = self.cfg
        if memory is None:
            x = self._attend(x, None, "", causal=False)
        else:
            x = self._attend(x, None, "", causal=True)
            x = self._attend(x, memory, "x_", causal=False)
        h2 = rms_norm(x, self.ln_mlp, cfg.norm_eps)
        return x + glu_mlp(h2, self.w_gate, self.w_up, self.w_down, cfg.act)


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
        if self.cfg.remat:
            return checkpoint(layer, x, memory, use_reentrant=False,
                              preserve_rng_state=False)
        return layer(x, memory)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        _, S, D = frames.shape
        x = frames.to(torch_dtype(cfg.dtype))
        x = x + sinusoid_positions(S, D, x.device).to(x.dtype)[None]
        for layer in self.enc:
            x = self._run(layer, x)
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """Mean next-token cross-entropy of the decoder ``tokens`` (B, S)
        given the encoder ``frames`` (B, S_enc, D)."""
        cfg = self.cfg
        S = tokens.shape[1]
        memory = self.encode(frames)
        x = self.embed[tokens.long()].to(torch_dtype(cfg.dtype))
        x = x + self.pos_dec[None, :S].to(x.dtype)
        for layer in self.dec:
            x = self._run(layer, x, memory)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return next_token_xent(x, self.lm_head, tokens)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        return self(batch["frames"], batch["tokens"])

    def prefill(self, *args, **kwargs):
        raise NotImplementedError("prefill: " + _SERVING)

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError("decode_step: " + _SERVING)
