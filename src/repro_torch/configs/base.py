"""Model / shape configuration schema: a copy of the JAX package's
``repro/configs/base.py`` (pure dataclasses), so the port reads the same
configurations without importing it.

Every assigned architecture is a `ModelConfig`; every assigned input shape a
`ShapeSpec`.  `window_pattern` drives the layer-group mechanism: layers are
stacked in groups of `len(window_pattern)` slots, each slot with its own
attention window (0 = full attention) — this is how gemma3's 5:1
local:global pattern shares one parameter and cache layout while local
layers keep window-sized decode caches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attention: str = "gqa"           # gqa | mla | none
    window_pattern: Tuple[int, ...] = (0,)   # per-slot window; 0 = full
    rope_theta: float = 10000.0

    # mlp
    mlp_type: str = "swiglu"         # swiglu | gelu (starcoder2, whisper)

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0
    first_dense_layers: int = 0      # deepseek: leading dense layer(s)
    moe_parallelism: str = "tp"      # tp (shard d_ff) | ep (shard experts)
    moe_capacity_factor: float = 1.25
    moe_impl: str = "gspmd"         # gspmd | shard_map (sharded dispatch)

    # SSM (mamba-1)
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    conv_kernel: int = 4
    parallel_ssm: bool = False       # hymba: attn + ssm in parallel per layer

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    num_frames: int = 0              # stub frontend sequence length

    # vlm stub
    num_image_tokens: int = 0

    remat_policy: str = "full"      # full | save_tp_out (keep TP-boundary outs)
    microbatches: int = 1            # gradient-accumulation chunks per step
    fsdp: bool = False               # ZeRO-style param/opt shard over "data"

    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # which assigned shapes this arch runs ("" entries are skipped, with the
    # reason recorded in DESIGN.md §long-context policy)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def period(self) -> int:
        return len(self.window_pattern)

    @property
    def num_groups(self) -> int:
        assert self.scan_layers % self.period == 0, (self.name,)
        return self.scan_layers // self.period

    @property
    def scan_layers(self) -> int:
        """Layers inside the scanned stack (excludes the dense prefix)."""
        return self.num_layers - self.first_dense_layers

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.attention != "none"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}
