"""Model API: build an architecture, allocate its serving cache, select
its sharding rules, describe each dry-run cell's inputs, and count its
parameters and FLOPs.

Port of :mod:`repro.models.api`.  The reference's ShapeDtypeStructs are
``meta`` tensors here (nothing is allocated) and its PartitionSpecs are
:func:`~repro_torch.sharding.specs.logical_to_spec` tuples; a cache's
``"len"`` is the Python int the port's caches count positions with.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import params as P
from repro_torch.models.lm import TransformerLM
from repro_torch.models.ssm import MambaLM, XLSTMLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.sharding.specs import (ShardingRules, decode_rules,
                                        logical_to_spec, mesh_axis_sizes,
                                        train_rules)


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


# ---------------------------------------------------------------------------
# sharding-rule selection (per config x mesh x step kind)
# ---------------------------------------------------------------------------

def rules_kind_is_decode(kind: str) -> bool:
    return kind.startswith("decode")


def rules_for(cfg: ModelConfig, mesh, kind: str, *, fsdp: bool | None = None,
              seq_shard: bool = False) -> ShardingRules:
    """The reference's rule selection; it reads only the mesh's dim names
    and sizes (``mesh_dim_names`` and ``shape``)."""
    sizes = mesh_axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    if fsdp is None:
        # FSDP whenever TP alone cannot comfortably fit the training state:
        # bf16 params + f32 grads + f32 Adam moments = 14 B/param
        fsdp = (14 * n_params(cfg) / model_size) > 8e9
    if kind == "train":
        rules = train_rules(sizes, fsdp=fsdp, seq_shard=seq_shard)
    else:
        # long-context decode: batch too small for the data axis -> shard
        # the KV/cross sequence over `data` instead (SP decode)
        rules = decode_rules(sizes, fsdp=fsdp, kv_seq_shard=kind == "decode_sp")
    over = {}
    # MoE placement: EP when experts divide the model axis, else TP-in-expert
    if cfg.n_experts:
        if cfg.n_experts % model_size == 0:
            over.update(experts="model", expert_ff=None, moe_cap=None)
        else:
            over.update(experts=None, expert_ff="model",
                        moe_cap=rules.axis("tokens"))
    # vocab that doesn't divide the model axis: replicate embeddings
    if cfg.vocab_size % model_size != 0:
        over.update(vocab=None)
    # attention-head divisibility:
    heads_div = cfg.n_heads % model_size == 0
    kvh_div = cfg.n_kv_heads % model_size == 0 if cfg.n_kv_heads else True
    hd_div = cfg.hd % model_size == 0
    if not heads_div:
        over.update(heads=None)
    if cfg.n_kv_heads and not kvh_div:
        if rules_kind_is_decode(kind) or not heads_div:
            # decode: the KV cache must shard -> split head_dim; the tiny
            # single-token scores reduce across hd shards (cheap at S_q=1)
            over.update(kv_heads=None,
                        head_dim="model" if hd_div else None)
        else:
            # train/prefill: replicate KV, shard q heads; the model
            # expands GQA->MHA locally (see models.lm._kv_expand)
            over.update(kv_heads=None, head_dim=None)
    # SSM inner dim must divide the model axis; fall back to replicated
    if cfg.ssm_state and cfg.d_inner % model_size != 0:
        over.update(ssm_inner=None)
    if over:
        rules = rules.with_overrides(**over)
    return rules


# ---------------------------------------------------------------------------
# per-cell inputs (meta tensors: nothing is allocated)
# ---------------------------------------------------------------------------

def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Input structs of one (arch x shape) cell: int32 tokens, embeddings
    in ``cfg.dtype``."""
    B = shape.global_batch
    S = shape.seq_len
    tok = lambda b, s: torch.empty((b, s), dtype=torch.int32, device="meta")
    emb = lambda *s: torch.empty(s, dtype=P.torch_dtype(cfg.dtype),
                                 device="meta")
    if cfg.family == "audio":
        # seq_len = encoder frames (stub frontend -> embeddings); decoder text
        if shape.kind in ("train", "prefill"):
            return {"frames": emb(B, S, cfg.d_model),
                    "tokens": tok(B, min(cfg.max_decoder_len, S))}
        return {"tokens": tok(B, 1)}
    base = {"tokens": tok(B, S) if shape.kind in ("train", "prefill")
            else tok(B, 1)}
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        base["vision_embed"] = emb(B, cfg.vision_tokens, cfg.d_model)
    return base


def batch_logical(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    log = {"tokens": ("batch", "seq") if shape.kind != "decode" else ("batch", None)}
    if cfg.family == "audio" and shape.kind != "decode":
        log["frames"] = ("batch", "seq", "embed")
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        log["vision_embed"] = ("batch", None, "embed")
    return log


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules):
    return {k: logical_to_spec(v, rules)
            for k, v in batch_logical(cfg, shape).items()}


def cache_struct_and_specs(model, cfg: ModelConfig, shape: ShapeConfig,
                           rules: ShardingRules):
    """Decode-cell cache in ``model.cache_defs``'s layout, and its specs:
    KV caches (and conv windows) in ``cfg.dtype``, SSM states f32, each a
    meta tensor; ``"len"`` the Python int 0 with spec ``()``."""
    defs = model.cache_defs(shape.global_batch, shape.seq_len)

    def struct(path, d):
        if d.shape == ():
            return 0
        dt = cfg.dtype
        if "ssm" in path and path[-1] in ("h", "c", "n", "hp"):
            dt = torch.float32
        return torch.empty(d.shape, dtype=P.torch_dtype(dt), device="meta")

    structs = _map_with_path(struct, defs)
    specs = _map_with_path(lambda _, d: logical_to_spec(d.logical, rules),
                           defs)
    return structs, specs


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
