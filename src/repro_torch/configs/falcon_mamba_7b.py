"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free mamba-1,
ssm_state=16, vocab=65024.  [arXiv:2410.05355; unverified]
O(1) recurrent state -> runs long_500k."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    attention="none",
    ssm_state=16, d_inner=8192, dt_rank=256, conv_kernel=4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="falcon-mamba-smoke", num_layers=2, d_model=128,
    vocab_size=512, ssm_state=8, d_inner=256, dt_rank=16)
