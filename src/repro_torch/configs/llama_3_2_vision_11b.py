"""llama-3.2-vision-11b: cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Vision frontend is a
stub: input_specs() supplies precomputed patch embeddings (1600 tokens,
rounded from 1601 for chunk divisibility — see DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=5e5,
    cross_attn_every=5, vision_tokens=1600,
))
