"""PyTorch wrapper of the Local Minibatch Gibbs sweep kernel in
``csrc/local_sweep.cu``.

One launch runs S sub-steps of Algorithm 3 for every chain, drawing each
sub-step's B-subset (Floyd's algorithm), and its Gumbels, in-kernel from
Philox (``philox.LOCAL_GIBBS_STREAMS``), so a sweep call reads only x, the
sites, the seed and the B entries of W each sub-step sums.  Like the other
wrappers (``fused_sweep.py``) it checks its inputs, allocates its output
with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and counts its launches in
``local_gibbs_sweep_cuda.launches``.  CUDA tensors only: the CPU path is the
plain version, ``ref.local_gibbs_sweep_ref``, chosen by
``ops.local_gibbs_sweep``.
"""
from __future__ import annotations

import torch

from .fused_sweep import _check, _check_cuda, _launch, _sites

__all__ = ["local_gibbs_sweep_cuda"]


def local_gibbs_sweep_cuda(x, W, i_sites, seed, *, B: int, D: int,
                           scale: float):
    """S fused Local Minibatch Gibbs site updates per chain, every draw
    in-kernel (``ref.local_gibbs_sweep_ref``).

    x (C, n) int32; W (n, n) float32; i_sites (C, S) int32; seed (1,) int32
    on the card; 1 <= B <= n - 1; ``scale`` = (n-1)/B.  Returns x_out
    (C, n) int32.

    Replaces ``bucket_energy_pallas``
    (``src/repro/kernels/minibatch_energy.py:54``) on the local path of
    ``src/repro/core/samplers.py:161``.  One block per chain keeps x in
    shared memory.  Seven producer warps draw the subsets (Floyd's
    algorithm, 32 steps at a time), gather the B weights W[i, j_t] and draw
    the Gumbels of a chunk of sub-steps ahead; one consumer warp runs the
    state-dependent part (x[j_t], the bucket sums over t in draw order, the
    argmax) sub-step after sub-step.  Latency-bound: the consumer's S
    sub-steps depend on each other.  The launch sizes its shared memory
    from the device's allowance and refuses (``RuntimeError``) an n whose
    x row and site bitmaps leave no room for one sub-step.
    """
    C, n = x.shape
    S = _sites(i_sites)
    B, D = int(B), int(D)
    _check(x, "x", torch.int32, (C, n))
    _check(W, "W", torch.float32, (n, n))
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(seed, "seed", torch.int32, (1,))
    _check_cuda([x, W, i_sites, seed])
    if not 1 <= B <= n - 1:
        raise ValueError(f"B must lie in [1, n - 1 = {n - 1}], got {B}")
    if D < 1:
        raise ValueError(f"D must be at least 1, got {D}")
    out = torch.empty_like(x)
    if C == 0:
        return out
    _launch("local_gibbs_sweep_launch", x,
            (x, W, i_sites, seed, out, C, n, S, B, D, float(scale)))
    local_gibbs_sweep_cuda.launches += 1
    return out


local_gibbs_sweep_cuda.launches = 0
