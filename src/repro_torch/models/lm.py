"""Decoder-only transformer LM, dense GQA family (yi / codeqwen / gemma /
qwen3).

Port of the dense part of :mod:`repro.models.lm`.  One :class:`Block`
module per layer sits in a ``ModuleList`` and a Python loop takes the
place of the reference's ``lax.scan``; ``cfg.remat`` checkpoints each
block (``torch.utils.checkpoint``, non-reentrant).  Parameter names and
shapes are the reference's (``models.params`` converts the stacked
layout), and weights multiply as ``x @ w``.

Not ported yet (``ROADMAP.md`` §1): the MoE and VLM families,
``prefill`` and ``decode_step`` (serving), and the sharding constraints
and GQA expansion, which need a mesh: without sharding rules the
reference does not expand either.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (chunked_softmax_xent, flash_attention,
                                       glu_mlp, rms_norm, rope)
from repro_torch.models.params import ParamDef, torch_dtype

_NOT_PORTED = "not ported yet ({}: ROADMAP.md §1)"


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Block(nn.Module):
    """One pre-norm layer: GQA self-attention, then the GLU MLP."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        D, H, KVH, hd, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.d_ff)
        for name, shape in [("ln_attn", (D,)), ("wq", (D, H * hd)),
                            ("wk", (D, KVH * hd)), ("wv", (D, KVH * hd)),
                            ("wo", (H * hd, D)), ("ln_mlp", (D,)),
                            ("w_gate", (D, F_)), ("w_up", (D, F_)),
                            ("w_down", (F_, D))]:
            setattr(self, name, _param(shape, device, dtype))
        if cfg.qk_norm:
            self.q_norm = _param((hd,), device, dtype)
            self.k_norm = _param((hd,), device, dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return self.mlp(self.attention(x, positions))

    def attention(self, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h = rms_norm(x, self.ln_attn, cfg.norm_eps)
        q = (h @ self.wq).reshape(B, S, H, hd)
        k = (h @ self.wk).reshape(B, S, KVH, hd)
        v = (h @ self.wv).reshape(B, S, KVH, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        attn = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                               kv_chunk=cfg.kv_chunk, mode=cfg.causal_mode)
        return x + attn.reshape(B, S, H * hd) @ self.wo

    def mlp(self, x):
        cfg = self.cfg
        h = rms_norm(x, self.ln_mlp, cfg.norm_eps)
        return x + glu_mlp(h, self.w_gate, self.w_up, self.w_down, cfg.act)


class TransformerLM(nn.Module):
    """The dense LM.  Parameters are allocated uninitialised on ``device``
    in ``dtype`` (default ``cfg.dtype``); fill them with
    :func:`repro_torch.models.params.init_params` and
    :func:`~repro_torch.models.params.from_reference`."""

    def __init__(self, cfg: ModelConfig, *, device="cpu", dtype=None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.family} family: " + _NOT_PORTED.format("other model families"))
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = _param((V, D), device, dtype)
        self.layers = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param((D,), device, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param((D, V), device, dtype)

    # -- parameters ----------------------------------------------------------
    def param_defs(self) -> dict:
        """The reference's ParamDef tree (dense family)."""
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
            "w_gate": ParamDef((L, D, F_), ("layers", "fsdp", "ff")),
            "w_up": ParamDef((L, D, F_), ("layers", "fsdp", "ff")),
            "w_down": ParamDef((L, F_, D), ("layers", "ff", "fsdp")),
        }
        if cfg.qk_norm:
            layer["q_norm"] = ParamDef((L, hd), ("layers", None), "zeros")
            layer["k_norm"] = ParamDef((L, hd), ("layers", None), "zeros")
        defs = {
            "embed": ParamDef((V, D), ("vocab", "fsdp"), "embed"),
            "layers": layer,
            "final_norm": ParamDef((D,), (None,), "zeros"),
        }
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((D, V), ("fsdp", "vocab"))
        return defs

    # -- forward -------------------------------------------------------------
    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(torch_dtype(self.cfg.dtype))

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` (B, S)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed_in(tokens)
        positions = torch.arange(S, device=tokens.device)[None, :]
        for blk in self.layers:
            if cfg.remat:
                x = checkpoint(blk, x, positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, positions)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones((B, S), device=tokens.device)
        mask[:, -1] = 0.0
        # the reference adds 0.01 * aux / n_layers; aux is 0 without MoE
        return chunked_softmax_xent(x, self._head(), labels, mask)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        return self(batch["tokens"])

    def prefill(self, *args, **kwargs):
        raise NotImplementedError("prefill: " + _NOT_PORTED.format("serving"))

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError("decode_step: " + _NOT_PORTED.format("serving"))
