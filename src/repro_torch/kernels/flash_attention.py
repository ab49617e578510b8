"""PyTorch wrapper of the flash-attention kernel in
``csrc/flash_attention.cu``.

Online-softmax attention over grouped-query heads, causal or bidirectional,
with an optional sliding window (see ``ref.flash_attention_ref`` for the
exact semantics).  Like the other wrappers (``fused_sweep.py``) it checks
dtype, shape, contiguity and device, allocates its output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and counts its launches in
``flash_attention_cuda.launches``.  CUDA tensors only: the CPU path is the
plain version, chosen by ``ops.flash_attention``.
"""
from __future__ import annotations

import torch

from .fused_sweep import _check, _check_cuda, _launch

__all__ = ["flash_attention_cuda", "HEAD_DIMS"]

# head dims the kernel is built for, per dtype (csrc/flash_attention.cu):
# the bf16 templates pad hd to 64, 128 or 256 (every dense config's head
# dim); the float32 form, the tests' type, has one template per hd
HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 120, 128, 256),
             torch.float32: (16, 32, 64, 128)}
_MAX_GRID_YZ = 65535            # float32 grid (query tiles, H, B)
_MAX_ITEMS = 2 ** 31 - 1        # bf16 work items (128-row tiles x H x B)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int = 0, causal: bool = True
                         ) -> torch.Tensor:
    """softmax(q k^T * hd^-0.5, masked) v over grouped-query heads.

    q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), one dtype (float32 or
    bfloat16), contiguous, on the card; H % KVH == 0, query head h reads KV
    head h // (H // KVH).  ``window <= 0``: no window; causal masking is
    top-left aligned (query i sees keys j <= i, both counted from 0).
    Returns (B, Sq, H, hd) in q's dtype; a row with no valid key is zeros.

    Replaces ``flash_attention_pallas``
    (``src/repro/kernels/flash_attention.py:79``) with its GQA / padding
    wrapper (``src/repro/kernels/ops.py:298``): no head repeat, no padding.
    Bound at the model's prefill shapes by the tensor cores and, as
    closely at hd=64, by the exponentials.  bf16 runs on TMA loads and
    wgmma with the softmax overlapping the products, float32 on the FP32
    units.
    """
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, S, heads, hd), got shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if q.dtype not in HEAD_DIMS:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim {hd} is not supported by the "
                         f"flash-attention kernel for {q.dtype} (built for "
                         f"{HEAD_DIMS[q.dtype]})")
    if KVH < 1 or H % KVH:
        raise ValueError(f"query heads ({H}) must be a multiple of KV heads "
                         f"({KVH})")
    if q.dtype == torch.float32 and max(B, H) > _MAX_GRID_YZ:
        raise ValueError(f"B={B} and H={H} must be at most {_MAX_GRID_YZ}")
    if q.dtype == torch.bfloat16 and -(-Sq // 128) * B * H > _MAX_ITEMS:
        raise ValueError(f"B={B}, Sq={Sq}, H={H}: more than {_MAX_ITEMS} "
                         f"work items")
    _check(q, "q", q.dtype, (B, Sq, H, hd))
    _check(k, "k", q.dtype, (B, Sk, KVH, hd))
    _check(v, "v", q.dtype, (B, Sk, KVH, hd))
    _check_cuda([q, k, v])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:                   # no key is valid for any row
        return out.zero_()
    _launch("flash_attention_launch", q,
            (q, k, v, out, B, Sq, Sk, H, KVH, hd, int(window), int(causal),
             int(q.dtype == torch.bfloat16), hd ** -0.5))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
