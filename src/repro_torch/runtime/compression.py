"""Gradient compression: int8 reduce-scatter -> all-gather with error
feedback -- the counterpart of ``repro/runtime/compression.py`` on
``torch.distributed`` (NCCL on the card, gloo on the CPU).

Why this shape: a plain all-reduce of int8 would overflow (127 * ranks),
so the compressed data-parallel all-reduce is RS/AG: each rank owns 1/n of
the vector, receives int8 *chunks* from its peers (``all_to_all_single``:
wire bytes / 4 against float32), sums them locally in float32, then
all-gathers its int8 result.  The per-rank scales travel as float32
(``all_gather``, n floats).  Error feedback (the quantisation residual
carried to the next call) keeps SGD / Adam convergence intact under
quantisation (Karimireddy et al., 2019).  The arithmetic is the
reference's, operation for operation in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_mean"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: returns (q, scale), scale a
    0-d float32 tensor."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def compressed_psum_mean(x: torch.Tensor, err: torch.Tensor, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-all-reduce of ``x`` (a flat float32 vector whose length the
    group's size divides) over ``group`` (default: the world), with an int8
    wire format and error feedback.  Every rank calls it.  ``err`` is this
    rank's residual from the previous call (shaped as x; zeros at first).
    Returns (mean, new_err), the same mean on every rank."""
    n = dist.get_world_size(group)
    L = x.shape[0]
    if x.dim() != 1 or L % n:
        raise ValueError(f"x must be a flat vector whose length the {n} "
                         f"ranks divide, got shape {tuple(x.shape)}")
    xe = x + err
    q, scale = quantize_int8(xe)
    new_err = xe - dequantize_int8(q, scale)

    # reduce-scatter in int8: chunk p goes to rank p; this rank receives
    # its chunk of every peer, dequantises and sums them
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)
    scales = _gather(scale, n, group)                   # (n,) float32
    local_sum = torch.sum(recv.reshape(n, L // n).to(torch.float32)
                          * scales[:, None], dim=0) / n

    # all-gather the owned chunk in int8
    q2, s2 = quantize_int8(local_sum)
    gathered = _gather(q2, n, group)                    # (n, L / n) int8
    s_all = _gather(s2, n, group)
    mean = (gathered.to(torch.float32) * s_all[:, None]).reshape(L)
    return mean, new_err
