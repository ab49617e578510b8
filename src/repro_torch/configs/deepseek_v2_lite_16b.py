"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H, MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared, expert d_ff=1408, vocab=102400, first layer
dense (d_ff=10944).  [arXiv:2405.04434; hf]

Assignment note: the task line says both "64e top-6" and "160 routed";
160 routed is DeepSeek-V2 (236B) — the *Lite* model (16B, as assigned) has
64 routed + 2 shared, which is what we implement (see DESIGN.md).
Full attention (quadratic prefill) -> long_500k skipped.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=192,                     # qk_nope 128 + qk_rope 64
    d_ff=10944,                       # the dense first layer's ffn
    vocab_size=102400,
    attention="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64, top_k=6, moe_d_ff=1408, shared_experts=2,
    first_dense_layers=1, moe_parallelism="ep",   # 64 experts / 16 shards
    skip_shapes=("long_500k",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", num_layers=3, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=48, d_ff=256, vocab_size=512,
    kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    num_experts=8, top_k=2, moe_d_ff=64, shared_experts=1,
    first_dense_layers=1)
