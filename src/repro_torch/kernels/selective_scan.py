"""PyTorch wrapper of the selective-scan kernel in ``csrc/selective_scan.cu``.

The Mamba-1 block's scan over the sequence, its D skip and its gate, in
one launch (see ``ref.selective_scan_ref`` for the exact semantics).  Like
the other wrappers (``fused_sweep.py``) it checks dtype, shape, layout and
device, allocates its output with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises if the launch was refused,
and counts its launches in ``selective_scan_cuda.launches``.  CUDA tensors
only: the CPU path is the plain version, chosen by ``ops.selective_scan``.
``scan_layout`` is the layout the kernel takes at a shape (lanes per
channel chosen from the shape alone); ``kernel_layout`` asks the built
library for it.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .fused_sweep import _check, _check_cuda, _launch

__all__ = ["selective_scan_cuda", "STATES", "scan_layout", "kernel_layout"]

# state sizes the kernel is built for (csrc/selective_scan.cu): the smoke
# configs' 8 and falcon-mamba-7b's and hymba-1.5b's 16
STATES = (8, 16)
_MAX_GRID_Y = 65535             # gridDim.y = batch
# csrc/selective_scan.cu's layout: a block is _CHANNELS channels x L lanes,
# L the fewest of _LANES (at most N) that launch _TARGET_LANES lanes (14
# warps an SM, 3.5 a scheduler, of the H100's 132 SMs), else N; 8 and 16
# lanes stage 32-step tiles, fewer lanes 16-step tiles
_CHANNELS, _LANES, _SMS = 32, (1, 2, 4, 8, 16), 132
_TARGET_LANES = 14 * _SMS * 32


def scan_layout(bsz: int, S: int, di: int, N: int) -> dict:
    """The kernel's layout at (bsz, S, d_inner, N), from the shape alone:
    ``lanes`` per channel (each holding ``states_per_lane`` states),
    ``channels`` and ``threads`` per block, ``tile`` (steps staged at a
    time), ``blocks`` launched and ``warps_per_scheduler`` (launched warps
    over the 528 schedulers of 132 SMs).  N in ``STATES``."""
    if N not in STATES:
        raise ValueError(f"state size N={N} is not supported by the "
                         f"selective-scan kernel (built for {STATES})")
    lanes = next((L for L in _LANES if L < N and bsz * di * L
                  >= _TARGET_LANES), min(N, _LANES[-1]))
    threads = _CHANNELS * lanes
    blocks = -(-di // _CHANNELS) * bsz
    return dict(lanes=lanes, states_per_lane=N // lanes,
                channels=_CHANNELS, threads=threads,
                tile=32 if lanes >= 8 else 16, blocks=blocks,
                warps_per_scheduler=blocks * threads / 32 / (4 * _SMS))


def kernel_layout(bsz: int, S: int, di: int, N: int) -> dict:
    """The layout the built library takes at the shape (its
    ``selective_scan_layout``): ``lanes``, ``channels``, ``threads`` and
    ``tile``.  Builds the library at first use."""
    out = (ctypes.c_int * 4)()
    info = load_library()
    err = info.fns["selective_scan_layout"](int(bsz), int(S), int(di),
                                            int(N), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"selective_scan_layout refused N={N}: "
                           f"{info.lib.cuda_error_string(err).decode()}")
    return dict(zip(("lanes", "channels", "threads", "tile"), out))


def _row_stride(z: torch.Tensor, S: int, di: int) -> int:
    """Elements between consecutive (b, t) rows of z (bsz, S, di), whose
    rows must be evenly spaced with unit stride inside a row (a contiguous
    tensor, or the gate half of the (bsz, S, 2 di) input projection)."""
    bsz = z.shape[0]
    ld = z.stride(1) if S > 1 else z.stride(0) if bsz > 1 else di
    if ((di > 1 and z.stride(2) != 1) or ld < di
            or (bsz > 1 and z.stride(0) != S * ld)):
        raise ValueError(f"z must have evenly spaced rows of unit stride, "
                         f"got strides {z.stride()} for shape "
                         f"{tuple(z.shape)}")
    return ld


def selective_scan_cuda(dt: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                        D: torch.Tensor) -> torch.Tensor:
    """y_t = bf16((C_t . h_t + D x_t) silu(z_t)) with h_t = exp(dt_t A)
    h_{t-1} + (dt_t x_t) B_t from h_{-1} = 0, per (batch, channel).

    dt, x (bsz, S, di) float32 contiguous, di even; z (bsz, S, di)
    bfloat16 with evenly spaced rows an even number of elements apart,
    4-byte aligned (a contiguous tensor or a row-strided view such as the
    gate half of the input projection, read in place); B, C (bsz, S, N),
    A (di, N) and D (di,) float32 contiguous; N in ``STATES``; all on the
    card.  Returns y (bsz, S, di) bfloat16, the same bits on every
    launch.

    Replaces no Pallas kernel: the JAX package's ``mamba_block``
    (``src/repro/models/ssm.py:42-73``) runs ``jax.lax.associative_scan``
    over (bsz, S, di, N) float32 decay and drive tensors (``:70``), jnp.
    Bound about evenly by the bytes (each input read once, y written once)
    and the exponentials (N + 1 per (b, t, d)).  Each channel's N states
    are spread over ``scan_layout(...)["lanes"]`` lanes; the C . h sums of
    a group of steps are reduced across a channel's lanes once per group,
    and one lane gates and stores each (t, d); each tile's inputs are
    staged in shared memory by cp.async, transposed, while the previous
    tile computes.
    """
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"dt must be (bsz, S, d_inner) and A (d_inner, N), "
                         f"got shapes {tuple(dt.shape)} and "
                         f"{tuple(A.shape)}")
    bsz, S, di = dt.shape
    N = A.shape[1]
    if N not in STATES:
        raise ValueError(f"state size N={N} is not supported by the "
                         f"selective-scan kernel (built for {STATES})")
    if bsz > _MAX_GRID_Y:
        raise ValueError(f"batch {bsz} is more than {_MAX_GRID_Y}")
    if di % 2:
        raise ValueError(f"d_inner {di} is odd: the kernel copies z in "
                         f"pairs of bf16 channels")
    _check(dt, "dt", torch.float32, (bsz, S, di))
    _check(x, "x", torch.float32, (bsz, S, di))
    if z.dtype != torch.bfloat16 or tuple(z.shape) != (bsz, S, di):
        raise ValueError(f"z must be torch.bfloat16 of shape {(bsz, S, di)}, "
                         f"got {z.dtype} {tuple(z.shape)}")
    ld = _row_stride(z, S, di) if z.numel() else di
    if ld % 2 or z.data_ptr() % 4:
        raise ValueError(f"z's rows must start 4-byte aligned: row stride "
                         f"{ld} elements, data pointer {z.data_ptr()}")
    _check(B, "B", torch.float32, (bsz, S, N))
    _check(C, "C", torch.float32, (bsz, S, N))
    _check(A, "A", torch.float32, (di, N))
    _check(D, "D", torch.float32, (di,))
    _check_cuda([dt, x, z, B, C, A, D])
    y = torch.empty((bsz, S, di), dtype=torch.bfloat16, device=dt.device)
    if y.numel() == 0:
        return y
    _launch("selective_scan_launch", dt,
            (dt, x, z, B, C, A, D, y, bsz, S, di, N, ld))
    selective_scan_cuda.launches += 1
    return y


selective_scan_cuda.launches = 0
