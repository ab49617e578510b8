"""whisper-tiny [audio] — 4+4L enc-dec d_model=384 6H d_ff=1536 vocab=51865,
conv frontend STUB: input_specs() provides precomputed mel-frame embeddings
(B, 1500, 384).  [arXiv:2212.04356; unverified]

Deviations (DESIGN.md): RMSNorm + RoPE decoder instead of LayerNorm +
learned positions (backbone-only reproduction).  Decoder is full-attention
-> long_500k skipped.  Tiny model: model-axis sharding is disabled for its
attention internals (6 heads), handled by the sharding rules."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    rope_theta=1e4,
    encoder_layers=4, num_frames=1500,
    mlp_type="gelu", tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=2, d_model=64, num_heads=2,
    num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
    encoder_layers=2, num_frames=64)
