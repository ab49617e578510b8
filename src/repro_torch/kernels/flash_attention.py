"""PyTorch wrappers of the flash-attention kernels: the forward in
``csrc/flash_attention.cu`` and its gradient in
``csrc/flash_attention_bwd.cu``.

Online-softmax attention over grouped-query heads, causal or bidirectional,
with an optional sliding window (see ``ref.flash_attention_ref`` for the
exact semantics).  Like the other wrappers (``fused_sweep.py``) it checks
dtype, shape, contiguity and device, allocates its output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and counts its launches in
``flash_attention_cuda.launches``.  CUDA tensors only: the CPU path is the
plain version, chosen by ``ops.flash_attention``.  The backward wrapper
(``flash_attention_bwd_cuda``, bf16 only) counts one launch per call of its
three kernels (D, dK/dV, dQ), and takes the forward kernel's row
statistics (``flash_attention_cuda(..., lse=True)``).
"""
from __future__ import annotations

import torch

from .fused_sweep import _check, _check_cuda, _launch

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "HEAD_DIMS"]

# head dims the kernel is built for, per dtype (csrc/flash_attention.cu):
# the bf16 templates pad hd to 64, 128 or 256 (every dense config's head
# dim); the float32 form, the tests' type, has one template per hd.  The
# backward kernel (csrc/flash_attention_bwd.cu) is bf16 only and pads as the
# bf16 forward does, so it takes HEAD_DIMS[torch.bfloat16]
HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 120, 128, 256),
             torch.float32: (16, 32, 64, 128)}
_MAX_GRID_YZ = 65535            # float32 grid (query tiles, H, B)
_MAX_ITEMS = 2 ** 31 - 1        # bf16 work items (128-row tiles x H x B)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int = 0, causal: bool = True,
                         lse: bool = False):
    """softmax(q k^T * hd^-0.5, masked) v over grouped-query heads.

    q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), one dtype (float32 or
    bfloat16), contiguous, on the card; H % KVH == 0, query head h reads KV
    head h // (H // KVH).  ``window <= 0``: no window; causal masking is
    top-left aligned (query i sees keys j <= i, both counted from 0).
    Returns (B, Sq, H, hd) in q's dtype; a row with no valid key is zeros.
    ``lse=True`` (bf16 only) returns (out, lse2) with lse2 (B, H, Sq)
    float32, each row's log-sum-exp of the scores times hd^-0.5 log2(e),
    in base 2 (+inf for a row with no valid key), the backward kernel's
    input; ``out`` has the same bits either way.

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
    if lse and q.dtype != torch.bfloat16:
        raise ValueError(f"lse=True takes bfloat16, got {q.dtype}")
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
    lse2 = (torch.full((B, H, Sq), torch.inf, dtype=torch.float32,
                       device=q.device) if lse else None)
    if out.numel() == 0 or Sk == 0:      # no key is valid for any row
        out.zero_()
        return (out, lse2) if lse else out
    _launch("flash_attention_launch", q,
            (q, k, v, out, 0 if lse2 is None else lse2.data_ptr(), B, Sq,
             Sk, H, KVH, hd, int(window), int(causal),
             int(q.dtype == torch.bfloat16), hd ** -0.5))
    flash_attention_cuda.launches += 1
    return (out, lse2) if lse else out


flash_attention_cuda.launches = 0


def _bwd_rows(Sq: int) -> int:
    """Query rows of the backward's (lse2, D) scratch: Sq rounded up to
    whole 128-row dQ work items (csrc/flash_attention_bwd.cu)."""
    return -(-Sq // 128) * 128


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse2: torch.Tensor, *,
                             window: int = 0, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_cuda(q, k, v, lse=True)`` =
    (``out``, ``lse2``) for the output gradient ``dout`` (see
    ``ref.flash_attention_bwd_ref``).

    q, out, dout (B, Sq, H, hd), k and v (B, Sk, KVH, hd), bfloat16,
    contiguous, on the card; hd in ``HEAD_DIMS[torch.bfloat16]``; the
    mask as the forward's.  dk and dv sum the G = H / KVH query heads of
    each KV head in the kernel (no repeat); ``lse2`` (B, H, Sq) float32
    the forward kernel's row statistics.  Returns bf16 gradients shaped
    as q, k, v; the same bits on every launch (no float atomics).  A grid
    too large for the card (H or B above 65535) is refused by the C
    launcher before any launch.

    Replaces no Pallas kernel: the JAX package differentiates its jnp
    attention (``src/repro/models/attention.py``, ``flash_attention``).
    Bound by the tensor cores.  Three launches: D = rowsum(dout out) with
    each row's lse2 beside it, then dK/dV, then dQ: persistent wgmma
    kernels fed by TMA rings (a producer thread, two consumer
    warpgroups), 7 products per attended pair.  At hd 256 the two
    consumers of dK/dV share 64 keys, one summing dV and the other dK (64
    keys' dK and dV at 256 columns do not fit one warpgroup's registers).
    """
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, S, heads, hd), got shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the flash-attention backward kernel takes "
                         f"bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS[torch.bfloat16]:
        raise ValueError(f"head dim {hd} is not supported by the "
                         f"flash-attention backward kernel (built for "
                         f"{HEAD_DIMS[torch.bfloat16]})")
    if KVH < 1 or H % KVH:
        raise ValueError(f"query heads ({H}) must be a multiple of KV heads "
                         f"({KVH})")
    for name, t, shape in (("q", q, (B, Sq, H, hd)),
                           ("k", k, (B, Sk, KVH, hd)),
                           ("v", v, (B, Sk, KVH, hd)),
                           ("out", out, (B, Sq, H, hd)),
                           ("dout", dout, (B, Sq, H, hd))):
        _check(t, name, torch.bfloat16, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _check(lse2, "lse2", torch.float32, (B, H, Sq))
    _check_cuda([q, k, v, out, dout, lse2])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:     # no (query, key) pair at all
        return dq.zero_(), dk.zero_(), dv.zero_()
    # scratch: each query row's (lse2, D) pair, Sq padded to a multiple of
    # 128, and the dK/dV launch's work counter
    rows = torch.empty(B * H * _bwd_rows(Sq) * 2, dtype=torch.float32,
                       device=q.device)
    work = torch.empty(1, dtype=torch.int32, device=q.device)
    _launch("flash_attention_bwd_launch", q,
            (q, k, v, out, dout, dq, dk, dv, lse2, rows, work, B, Sq, Sk, H,
             KVH, hd, int(window), int(causal), hd ** -0.5))
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
