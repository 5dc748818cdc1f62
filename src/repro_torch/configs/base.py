"""Config system: model configs, shape configs, the architecture registry.

The port's own copy of ``repro.configs.base``: plain data, shared by both
packages' models through the same field names."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "silu"           # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert ff width (0 -> d_ff)
    capacity_factor: float = 1.25
    # vision (vlm): interleaved gated cross-attention layers
    cross_attn_every: int = 0
    vision_tokens: int = 0
    # audio (enc-dec)
    encoder_layers: int = 0
    max_decoder_len: int = 448
    # ssm / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0          # 0 -> d_inner // 64
    attn_every: int = 0         # hybrid: shared attn block every k ssm layers
    slstm_every: int = 0        # xlstm: sLSTM block every k blocks
    # execution knobs (hillclimb levers — not architecture)
    moe_dispatch: str = "sorted"   # "sorted" (global) | "rowwise" (local)
    dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    ssm_chunk: int = 256
    causal_mode: str = "masked"   # "masked" | "triangle" (skip future kv blocks)
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(self.d_inner // 64, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_REGISTRY: dict[str, "ModelConfig"] = {}

_ARCH_MODULES = [
    "yi_6b", "codeqwen1_5_7b", "gemma_7b", "qwen3_0_6b", "grok_1_314b",
    "qwen3_moe_30b_a3b", "llama_3_2_vision_11b", "whisper_small",
    "zamba2_7b", "xlstm_350m",
]


def register_arch(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if not ARCH_REGISTRY:
        load_all()
    return ARCH_REGISTRY[name]


def load_all() -> dict[str, ModelConfig]:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return ARCH_REGISTRY


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return cfg.replace(
        n_layers=min(cfg.n_layers, 2 if not cfg.attn_every else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        head_dim=32 if cfg.head_dim else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        capacity_factor=4.0,  # dropless at smoke scale: decode == prefill

        vision_tokens=16 if cfg.vision_tokens else 0,
        cross_attn_every=min(cfg.cross_attn_every, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        max_decoder_len=32 if cfg.encoder_layers else cfg.max_decoder_len,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_heads=2 if cfg.ssm_state else 0,
        attn_every=min(cfg.attn_every, 2),
        slstm_every=cfg.slstm_every,
        q_chunk=16, kv_chunk=16, ssm_chunk=8,
        dtype="float32", remat=False,
    )
