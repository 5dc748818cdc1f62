"""whisper-small: enc-dec, conv frontend stub [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, encoder_layers=12,
    max_decoder_len=448, act="gelu",
))
