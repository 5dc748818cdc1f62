"""xlstm-350m: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
24 blocks, an sLSTM block every 4th (18 mLSTM + 6 sLSTM); d_ff=0 per the
assignment — blocks carry their internal up/down projections only."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_expand=2, slstm_every=4,
))
