"""grok-1-314b: MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    n_experts=8, top_k=2, capacity_factor=1.25,
))
