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

import ctypes

import torch

from ._build import load_library
from .fused_sweep import _check, _check_cuda, _launch, _sites

__all__ = ["local_gibbs_sweep_cuda", "local_sweep_plan"]


def local_gibbs_sweep_cuda(x, W, i_sites, seed, *, B: int, D: int,
                           scale: float, recomputed=None):
    """S fused Local Minibatch Gibbs site updates per chain, every draw
    in-kernel (``ref.local_gibbs_sweep_ref``).

    x (C, n) int32; W (n, n) float32; i_sites (C, S) int32; seed (1,) int32
    on the card; 1 <= B <= n - 1; ``scale`` = (n-1)/B.  Returns x_out
    (C, n) int32.  ``recomputed``: an optional (C,) int32 tensor on the
    card into which the kernel writes each chain's count of sub-steps its
    consumer recomputed (it depends on timing; x_out does not).

    Replaces ``bucket_energy_pallas``
    (``src/repro/kernels/minibatch_energy.py:54``) on the local path of
    ``src/repro/core/samplers.py:161``.  One block per chain keeps x in
    shared memory.  Producer warps finish each sub-step ahead: they draw
    the subset (Floyd's algorithm, 32 steps at a time), gather the B
    weights W[i, j_t], draw the Gumbels, read the buckets of x[j_t] as the
    state stands, sum them in draw order and take the argmax, into a ring
    of slots handed over by mbarriers.  The consumer warp takes the
    sub-steps in order, checks the B buckets against the state at its turn
    and stores the value, or recomputes the sub-step when one changed: the
    result is the plain version's bit for bit, whatever the timing.  The
    launch plans its producers and ring depth from the device's shared
    memory (``local_sweep_plan``) and refuses (``RuntimeError``) an n
    whose x row and site bitmaps leave no room for one sub-step.
    """
    C, n = x.shape
    S = _sites(i_sites)
    B, D = int(B), int(D)
    _check(x, "x", torch.int32, (C, n))
    _check(W, "W", torch.float32, (n, n))
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(seed, "seed", torch.int32, (1,))
    tensors = [x, W, i_sites, seed]
    if recomputed is not None:
        _check(recomputed, "recomputed", torch.int32, (C,))
        tensors.append(recomputed)
    _check_cuda(tensors)
    if not 1 <= B <= n - 1:
        raise ValueError(f"B must lie in [1, n - 1 = {n - 1}], got {B}")
    if D < 1:
        raise ValueError(f"D must be at least 1, got {D}")
    out = torch.empty_like(x)
    if C == 0:
        return out
    _launch("local_gibbs_sweep_launch", x,
            (x, W, i_sites, seed, out, recomputed, C, n, S, B, D,
             float(scale)))
    local_gibbs_sweep_cuda.launches += 1
    return out


local_gibbs_sweep_cuda.launches = 0


def local_sweep_plan(n: int, S: int, B: int, D: int) -> dict:
    """The plan ``local_gibbs_sweep_cuda`` launches at (n, S, B, D) on the
    current device: ``producers`` (warps), ``slots`` (the ring's depth: how
    many sub-steps ahead of the consumer a producer may draw), ``window``
    (the sub-steps the consumer checks at once), ``lead`` (how far ahead of
    the consumer a producer reads the state and sums; 0: as soon as it has
    drawn), ``summers`` (with a lead, the producer warps that sum; the
    others draw) and ``smem`` (bytes of shared memory a block).  Raises
    ``RuntimeError`` where the launch would be refused."""
    out = (ctypes.c_int * 6)()
    info = load_library()
    err = info.fns["local_gibbs_sweep_plan"](int(n), int(S), int(B), int(D),
                                             ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"no local-sweep plan fits n={n}, S={S}, B={B}, "
                           f"D={D}: "
                           f"{info.lib.cuda_error_string(err).decode()}")
    return dict(zip(("producers", "slots", "window", "lead", "summers",
                     "smem"), out))
