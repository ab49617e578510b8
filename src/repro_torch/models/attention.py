"""Attention: GQA with an optional sliding window — flash attention on the
hand-written kernel for prefill, direct scores for decode.  The
counterpart of ``repro/models/attention.py``; MLA is not ported yet.

Prefill never materialises the (Sq, Sk) scores: ``flash_attention`` runs
the online-softmax kernel (``kernels/csrc/flash_attention.cu`` on the card,
its plain version on the CPU).  Where a gradient is wanted (training),
``FlashAttention`` wraps the same forward, and its backward is the
hand-written ``kernels/csrc/flash_attention_bwd.cu`` on the card (the plain
backward on the CPU); prefill, under ``torch.no_grad``, calls the forward
alone.  The JAX package's model-level
``flash_attention`` is a jnp scan over ``kv_chunk`` blocks computing the
same function; its ``kv_chunk`` is a TPU-memory knob the port drops, since
the kernel tiles itself.  Decode (q_len == 1) computes its (B, H, S) scores
directly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.flash_attention import HEAD_DIMS

__all__ = ["flash_attention", "FlashAttention", "decode_attention",
           "KVCache", "gqa_attend", "apply_rope_bshd", "NEG_INF"]

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
    rounding of q apart for 32, 120 and 128).  Differentiable
    (``FlashAttention``) when grad mode is on and an input requires grad.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, int(window), causal)
    return ops.flash_attention(q, k, v, window=int(window), causal=causal)


class FlashAttention(torch.autograd.Function):
    """``ops.flash_attention`` with its gradient ``ops.flash_attention_bwd``:
    on the card the forward and backward kernels, on the CPU their plain
    versions.  Saves q, k, v, the output and, on the card, the forward
    kernel's row log-sum-exp (B H Sq floats; no (Sq, Sk) tensor), which
    the backward kernel reads instead of recomputing it.  On the card the
    backward kernel takes bf16 at ``HEAD_DIMS[torch.bfloat16]`` only: other
    inputs are refused here, before any launch."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool):
        dims = HEAD_DIMS[torch.bfloat16]
        if q.device.type == "cuda" and (q.dtype != torch.bfloat16
                                        or q.shape[-1] not in dims):
            raise ValueError(
                f"the flash-attention backward kernel takes bfloat16 at head "
                f"dims {dims}; got {q.dtype}, head dim "
                f"{q.shape[-1]} (ROADMAP.md Queue 1 item 10)")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse2 = ops.flash_attention(q, k, v, window=window,
                                        causal=causal, lse=True)
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse2 = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, dout,
                                             window=ctx.window,
                                             causal=ctx.causal, lse2=lse2)
        return dq, dk, dv, None, None


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
