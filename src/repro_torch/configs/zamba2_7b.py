"""zamba2-7b: Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].  81 Mamba2 layers; ONE shared
attention+MLP transformer block applied before every 6-layer group
(14 applications, shared parameters, per-application KV caches)."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, attn_every=6,
))
