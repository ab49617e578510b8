"""Attention: GQA with an optional sliding window — flash attention on the
hand-written kernel for prefill, direct scores for decode.  The
counterpart of ``repro/models/attention.py``; MLA is not ported yet.

Prefill never materialises the (Sq, Sk) scores: ``flash_attention`` runs
the online-softmax kernel (``kernels/csrc/flash_attention.cu`` on the card,
its plain version on the CPU).  The JAX package's model-level
``flash_attention`` is a jnp scan over ``kv_chunk`` blocks computing the
same function; its ``kv_chunk`` is a TPU-memory knob the port drops, since
the kernel tiles itself.  Decode (q_len == 1) computes its (B, H, S) scores
directly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops

__all__ = ["flash_attention", "decode_attention", "KVCache", "gqa_attend",
           "apply_rope_bshd", "NEG_INF"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Per-layer decode cache.  k/v: (B, kv_heads, S_max, hd)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int            # tokens currently valid


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window, *, causal: bool = True) -> torch.Tensor:
    """Online-softmax attention for prefill.

    q: (B, Sq, H, hd);  k, v: (B, Sk, KVH, hd) with H % KVH == 0 (GQA).
    ``window``: int; <= 0 → full.  ``causal=False`` gives bidirectional
    attention.  Returns (B, Sq, H, hd) in q's dtype.  The scale hd^-0.5
    multiplies the float32 score, as in the TPU kernel (the JAX oracle
    scales q in bf16 first: the same for hd 16, 64 and 256, one bf16
    rounding of q apart for 32, 120 and 128).
    """
    return ops.flash_attention(q, k, v, window=int(window), causal=causal)


def decode_attention(q: torch.Tensor, cache: KVCache,
                     window) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd); cache.k/v: (B, KVH, S, hd).  Returns (B, 1, H, hd)
    float32.  Out-of-window / beyond-length positions masked.
    """
    B, _, H, hd = q.shape
    _, KVH, S, _ = cache.k.shape
    G = H // KVH
    qg = (q[:, 0] * hd ** -0.5).reshape(B, KVH, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bksh->bkgs", qg, cache.k.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    q_pos = cache.length - 1                       # position of this token
    valid = pos < cache.length
    if window > 0:
        valid &= q_pos - pos < window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p, cache.v.to(torch.float32))
    return out.reshape(B, 1, H, hd)


def gqa_attend(x, p, *, num_heads, num_kv_heads, head_dim, window,
               rope_cos, rope_sin, cache: Optional[KVCache] = None,
               causal: bool = True):
    """Standard GQA block.  p: mapping with wq (d, H*hd), wk/wv (d, KVH*hd),
    wo (H*hd, d).  Prefill when cache is None (flash attention); one-token
    decode otherwise, writing the token's k/v at ``cache.length - 1`` in
    place.  Returns (out, cache)."""
    B, S, d = x.shape
    q = (x @ p["wq"]).reshape(B, S, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, num_kv_heads, head_dim)
    q = apply_rope_bshd(q, rope_cos, rope_sin)
    k = apply_rope_bshd(k, rope_cos, rope_sin)
    if cache is None:
        out = flash_attention(q, k, v, window, causal=causal)
    else:
        idx = cache.length - 1
        cache.k[:, :, idx, :] = k[:, 0].to(cache.k.dtype)
        cache.v[:, :, idx, :] = v[:, 0].to(cache.v.dtype)
        out = decode_attention(q, cache, window)
    out = out.reshape(B, S, num_heads * head_dim).to(x.dtype)
    return out @ p["wo"], cache


def apply_rope_bshd(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) (or (B, S, hd/2)).  Rotates in
    float32, returns x's dtype."""
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)
