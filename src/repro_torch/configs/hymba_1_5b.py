"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16, parallel attention+mamba heads per layer.
[arXiv:2411.13676; hf]

Deviations (DESIGN.md): meta-tokens omitted; attention heads use SWA(1024)
uniformly (the SSM branch supplies global context), vs. the paper's 3 global
layers.  SSM + SWA -> runs long_500k."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    window_pattern=(1024,),
    rope_theta=1e4,
    parallel_ssm=True, ssm_state=16, d_inner=3200, dt_rank=100,
)

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-smoke", num_layers=2, d_model=128, num_heads=5,
    num_kv_heads=1, head_dim=16, d_ff=256, vocab_size=512,
    window_pattern=(32,), ssm_state=8, d_inner=256, dt_rank=16)
