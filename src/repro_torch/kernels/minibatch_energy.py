"""PyTorch wrapper of the bucket-energy kernel in ``csrc/bucket_energy.cu``.

Computes ``E[c, u] = sum_k w[c, k] * 1[v[c, k] == u]``, the energy of every
minibatch Gibbs variant (see ``ref.bucket_energy_ref``); in the port, the
energy of the single-site reference steps.  Like the sweep wrappers
(``fused_sweep.py``) it checks dtype, shape, contiguity and device,
allocates its output with ``torch.empty``, launches on PyTorch's current
stream without synchronising, raises if the launch was refused, and counts
its launches in ``bucket_energy_cuda.launches``.  CUDA tensors only: the CPU
path is the plain version, chosen by ``ops.bucket_energy``.

A launch reads ~10 KB at the minibatch shapes, so its host path is kept
short: ``_call`` reuses the typed ctypes function and reads the stream
handle once, and the data pointers go to it straight.
"""
from __future__ import annotations

import torch

from .fused_sweep import _call, _check, _check_cuda

__all__ = ["bucket_energy_cuda"]

# buckets one block of the kernel sums (kChunk); gridDim.y = ceil(D / 8)
_CHUNK = 8
_MAX_GRID_Y = 65535


def bucket_energy_cuda(w: torch.Tensor, v: torch.Tensor, D: int
                       ) -> torch.Tensor:
    """E[c, u] = sum_k w[c, k] * 1[v[c, k] == u] for u in [0, D); values of
    v outside [0, D) land in no bucket.

    w (C, K) float32, v (C, K) int32, contiguous, on the card.  Returns
    (C, D) float32, summed in a fixed order (the same bits every run).

    Replaces ``bucket_energy_pallas``
    (``src/repro/kernels/minibatch_energy.py:54``).  Bound by bytes: each
    (w, v) pair is read once (8 bytes) and each output written once.  One
    block per (row, eight buckets), per-thread register partials over a
    fixed k-stride and a fixed-order block reduction; no padding of C, K or
    D and no float atomics.
    """
    if w.dim() != 2:
        raise ValueError(f"w must be (C, K), got shape {tuple(w.shape)}")
    C, K = w.shape
    D = int(D)
    if D < 1 or -(-D // _CHUNK) > _MAX_GRID_Y:
        raise ValueError(f"D must lie in [1, {_CHUNK * _MAX_GRID_Y}], "
                         f"got {D}")
    _check(w, "w", torch.float32, (C, K))
    _check(v, "v", torch.int32, (C, K))
    _check_cuda([w, v])
    out = torch.empty((C, D), dtype=torch.float32, device=w.device)
    if C == 0:
        return out
    _call("bucket_energy_launch", w.get_device(),
          (w.data_ptr(), v.data_ptr(), out.data_ptr(), C, K, D))
    bucket_energy_cuda.launches += 1
    return out


bucket_energy_cuda.launches = 0
