"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, llama+mistral mix with SWA(4096).  [arXiv:2401.16818; unverified]
SWA -> runs long_500k."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    window_pattern=(4096,),                 # mistral-heritage sliding window
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="danube-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    window_pattern=(64,))
