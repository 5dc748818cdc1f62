"""qwen3-0.6b: qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True,
))
