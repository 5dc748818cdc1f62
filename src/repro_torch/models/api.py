"""Model API: build an architecture, allocate its serving cache, and count
its parameters and FLOPs.

Port of :mod:`repro.models.api` (``build_model``, ``cache_init``,
``n_params``, ``n_active_params``, ``model_flops``).  The sharding-rule
selection and the input ShapeDtypeStructs of the dry-run belong to the
mesh slice (``ROADMAP.md`` §1) and are not here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import params as P
from repro_torch.models.lm import TransformerLM
from repro_torch.models.ssm import MambaLM, XLSTMLM
from repro_torch.models.whisper import WhisperModel


def model_class(cfg: ModelConfig) -> type:
    """The class that holds ``cfg``'s family, dispatched as the reference's
    ``build_model``: a hybrid, or an SSM with ``ssm_state``, is a
    :class:`MambaLM`; another SSM an :class:`XLSTMLM`."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM
    if cfg.family == "audio":
        return WhisperModel
    if cfg.family == "hybrid" or (cfg.family == "ssm" and cfg.ssm_state):
        return MambaLM
    if cfg.family == "ssm":
        return XLSTMLM
    raise ValueError(cfg.family)


def build_model(cfg: ModelConfig, *, device="cpu", dtype=None):
    """The model for ``cfg``, its parameters allocated uninitialised on
    ``device`` (``device="meta"`` allocates nothing).  It exposes:

    * ``param_defs()`` / ``cache_defs(B, S)`` — ParamDef trees (see
      models.params); whisper's ``S`` is its encoder length;
    * ``loss_fn(batch)`` — the training loss;
    * ``prefill(batch, max_len=None) -> (logits, cache)``;
    * ``decode_step(cache, batch) -> (logits, cache)``, the cache written
      in place.

    Every family trains and serves."""
    return model_class(cfg)(cfg, device=device, dtype=dtype)


def cache_init(model, cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> dict:
    """An allocated cache on ``device``, in ``model.cache_defs``'s
    layout (for whisper ``max_len`` is the encoder length): KV caches and
    the Mamba2 conv windows in ``cfg.dtype``, the SSM states
    ``h``/``c``/``n``/``hp`` f32, each leaf filled as its ``init`` says
    (the sLSTM's ``n`` with ones), and ``"len"`` the Python int 0 that the
    port's caches count positions with."""
    defs = model.cache_defs(batch_size, max_len)

    def mk(path, d):
        if d.shape == ():
            return 0
        dt = cfg.dtype
        if "ssm" in path and path[-1] in ("h", "c", "n", "hp"):
            dt = torch.float32
        fill = torch.ones if d.init == "ones" else torch.zeros
        return fill(d.shape, dtype=P.torch_dtype(dt), device=device)

    return _map_with_path(mk, defs)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, v, path + (str(i),))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def n_params(cfg: ModelConfig) -> int:
    return P.count(build_model(cfg, device="meta").param_defs())


def n_active_params(cfg: ModelConfig) -> int:
    """MoE: only top_k of n_experts expert params are active per token."""
    if not cfg.n_experts:
        return n_params(cfg)
    defs = build_model(cfg, device="meta").param_defs()
    total = P.count(defs)
    expert = sum(P.count({k: v}) for k, v in defs["layers"].items()
                 if k.startswith("we_"))
    return total - expert + expert * cfg.top_k // cfg.n_experts


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D tokens (train) / 2*N*D (inference step); audio
    trains on its frames and ``min(max_decoder_len, seq_len)`` decoder
    tokens a row."""
    n = n_active_params(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        if cfg.family == "audio":
            toks = shape.global_batch * (shape.seq_len
                                         + min(cfg.max_decoder_len, shape.seq_len))
        return 6.0 * n * toks
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one decoded token per sequence
