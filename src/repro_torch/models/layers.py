"""Shared neural-net building blocks, the counterparts of
``repro/models/layers.py``.

Three conventions of the reference that are easy to miss:
  * ``rms_norm`` scales by ``1 + scale`` (the scale starts at zeros), not by
    ``scale`` as Llama's norm does;
  * rotary embedding is half-split (the first and second halves of the head
    rotate together), not interleaved, and computed in float32;
  * weights are drawn from a normal truncated at +-3 standard deviations,
    with std = fan_in^-0.5.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["rms_norm", "rope", "apply_rope", "truncated_normal_init",
           "new_weight", "compute_weight", "COMPUTE_DTYPE"]

COMPUTE_DTYPE = torch.bfloat16


def new_weight(shape, dtype, device, master: bool = False) -> nn.Parameter:
    """An empty parameter of the serve form (``dtype``, no grad) or of the
    master form (float32, grad)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32 if master
                                    else dtype, device=device),
                        requires_grad=master)


def compute_weight(w: torch.Tensor) -> torch.Tensor:
    """The weight as a layer computes with it: bf16 for two or more
    dimensions (the reference's ``_cast_params``; no copy when the serve
    form stores it so), as stored otherwise."""
    return w.to(COMPUTE_DTYPE) if w.dim() >= 2 else w


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + scale), in float32, returned in x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dtype)


def rope(positions: torch.Tensor, head_dim: int,
         theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding tables.  positions: (..., S) -> cos/sin
    (..., S, hd/2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin broadcastable (..., S, 1, hd/2).
    Half-split rotation, returned in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def truncated_normal_init(gen: torch.Generator, shape,
                          fan_in: Optional[int] = None,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """std * N(0, 1) truncated to [-3, 3], std = fan_in^-0.5 (fan_in
    defaults to shape[-2], or shape[-1] for a vector), drawn in float32 on
    ``device`` from ``gen`` (a generator of that device), then cast to
    ``dtype``.  The reference draws with jax.random, so the two give other
    numbers from one seed; the shapes and the distribution are the same."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (1.0 / max(fan_in, 1)) ** 0.5
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t.mul_(std)).to(dtype)
