"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global attention (window 1024), 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]
5:1 local:global (windowed-dominant) -> runs long_500k."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),   # 5 local : 1 global
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", num_layers=6, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    window_pattern=(32, 32, 32, 32, 32, 0))
