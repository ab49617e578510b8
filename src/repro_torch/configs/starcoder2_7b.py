"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE.  [arXiv:2402.19173; hf]
Pure full attention -> long_500k skipped."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152,
    rope_theta=1e5,
    mlp_type="gelu",              # starcoder2 uses a plain GELU MLP (7B count)
    skip_shapes=("long_500k",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="starcoder2-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
