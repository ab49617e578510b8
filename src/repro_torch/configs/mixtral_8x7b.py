"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, SWA(4096).  [arXiv:2401.04088; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    window_pattern=(4096,),                 # Mistral-style sliding window
    rope_theta=1e6,
    num_experts=8, top_k=2, moe_d_ff=14336,
    moe_parallelism="tp",                   # 8 experts < 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, moe_d_ff=256, vocab_size=512,
    num_experts=4, top_k=2, window_pattern=(64,))
