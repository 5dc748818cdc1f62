"""qwen3-moe-30b-a3b: MoE 128 experts top-8, per-expert ff 768
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128, qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=768, capacity_factor=1.25,
    rope_theta=1e6,
))
