"""PyTorch wrappers of the selective-scan kernels in
``csrc/selective_scan.cu``, forward and backward.

The Mamba-1 block's scan over the sequence, its D skip and its gate, in
one launch (see ``ref.selective_scan_ref`` for the exact semantics), and
its gradients (``ref.selective_scan_bwd_ref``).  Like the other wrappers
(``fused_sweep.py``) each checks dtype, shape, layout and device,
allocates its outputs and scratch with ``torch.empty``, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and counts its launches (``selective_scan_cuda.launches``,
``selective_scan_bwd_cuda.launches``).  CUDA tensors only: the CPU path is
the plain version, chosen by ``ops``.  ``scan_layout`` and
``scan_bwd_layout`` are the layouts the kernels take at a shape, from the
shape alone; ``kernel_layout`` and ``kernel_bwd_layout`` ask the built
library for them.  With grad on the forward also writes the states at
every 16th step (``checkpoints=True``), from which the backward restarts
each chunk.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import load_library
from .fused_sweep import _check, _check_cuda, _launch
from .ref import SCAN_CKPT_STEPS

__all__ = ["selective_scan_cuda", "selective_scan_bwd_cuda", "STATES",
           "scan_layout", "kernel_layout", "scan_bwd_layout",
           "kernel_bwd_layout"]

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


def _check_inputs(dt, x, z, B, C, A, D):
    """The forward's and the backward's checks of the inputs' dtypes,
    shapes and layouts; returns (bsz, S, d_inner, N, z's row stride)."""
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
    return bsz, S, di, N, ld


def selective_scan_cuda(dt: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                        D: torch.Tensor, *, checkpoints: bool = False):
    """y_t = bf16((C_t . h_t + D x_t) silu(z_t)) with h_t = exp(dt_t A)
    h_{t-1} + (dt_t x_t) B_t from h_{-1} = 0, per (batch, channel).

    dt, x (bsz, S, di) float32 contiguous, di even; z (bsz, S, di)
    bfloat16 with evenly spaced rows an even number of elements apart,
    4-byte aligned (a contiguous tensor or a row-strided view such as the
    gate half of the input projection, read in place); B, C (bsz, S, N),
    A (di, N) and D (di,) float32 contiguous; N in ``STATES``; all on the
    card.  Returns y (bsz, S, di) bfloat16, the same bits on every
    launch; with ``checkpoints`` (y, ckpt), ckpt (bsz, (S - 1) // 16, di,
    N) float32 the states after steps 15, 31, ... for
    ``selective_scan_bwd_cuda`` (the same y; the serve path asks for
    none and writes none).

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
    bsz, S, di, N, ld = _check_inputs(dt, x, z, B, C, A, D)
    _check_cuda([dt, x, z, B, C, A, D])
    y = torch.empty((bsz, S, di), dtype=torch.bfloat16, device=dt.device)
    ckpt = (torch.empty(_ckpt_shape(bsz, S, di, N), dtype=torch.float32,
                        device=dt.device) if checkpoints else None)
    if y.numel():
        _launch("selective_scan_launch", dt,
                (dt, x, z, B, C, A, D, y,
                 ckpt if ckpt is not None and ckpt.numel() else None,
                 bsz, S, di, N, ld))
        selective_scan_cuda.launches += 1
    return (y, ckpt) if checkpoints else y


selective_scan_cuda.launches = 0


# csrc/selective_scan.cu's backward: a block is _CHANNELS channels x
# N / states lanes, each lane holding 4 contiguous states where that
# launches _BWD_TARGET_LANES lanes (7 warps an SM of 132), else 2; its
# chunks are the SCAN_CKPT_STEPS steps between the forward's checkpoints
_BWD_TARGET_LANES = 7 * _SMS * 32


def _ckpt_shape(bsz: int, S: int, di: int, N: int) -> tuple:
    """The forward's checkpoints: the states after steps 15, 31, ... (each
    before the last step)."""
    return (bsz, max(S - 1, 0) // SCAN_CKPT_STEPS, di, N)


def scan_bwd_layout(bsz: int, S: int, di: int, N: int) -> dict:
    """The backward kernel's layout at (bsz, S, d_inner, N), from the shape
    alone: ``states_per_lane`` (4, or 2 where 4 would launch fewer than 7
    warps an SM), ``lanes`` per channel (N / states_per_lane),
    ``channels`` and ``threads`` per block, ``tile`` (steps per chunk,
    the forward's checkpoint interval), ``chunks``, ``channel_blocks``
    (blocks along d_inner; bsz of them along the batch), ``smem`` (dynamic
    shared memory bytes a block), ``warps_per_scheduler`` (launched warps
    over the 528 schedulers of 132 SMs); in float32 elements the
    checkpoints the forward writes for it (``ckpt``) and the scratch the
    wrapper allocates: ``part_bc`` (each channel block's dB and dC sums)
    and ``part_ad`` (each batch row's dA and dD sums)."""
    if N not in STATES:
        raise ValueError(f"state size N={N} is not supported by the "
                         f"selective-scan kernel (built for {STATES})")
    T, ch = SCAN_CKPT_STEPS, _CHANNELS
    states = 4 if bsz * di * (N // 4) >= _BWD_TARGET_LANES else 2
    lanes = N // states
    chunks = -(-S // T)
    blocks = -(-di // ch)
    # two stages of dt, x (transposed, rows of tile + 4 floats), B, C (rows
    # of N), the checkpoint (channels x N) and z, dy (bf16 rows of 34);
    # then the dC / dB terms of a step (channels x N, padded by N), dy
    # silu(z) and dy silu'(z) (as dt), and ddt, dx, dz
    stage = 4 * (2 * ch * (T + 4) + 2 * T * N + ch * N) + 2 * 2 * T * (ch + 2)
    work = (4 * T * (ch + 1) * N + 4 * 2 * ch * (T + 4) + 4 * 2 * T * ch
            + 2 * T * ch)
    return dict(states_per_lane=states, lanes=lanes, channels=ch,
                threads=ch * lanes, tile=T, chunks=chunks,
                channel_blocks=blocks, smem=2 * stage + work,
                warps_per_scheduler=blocks * bsz * ch * lanes / 32
                / (4 * _SMS),
                ckpt=math.prod(_ckpt_shape(bsz, S, di, N)),
                part_bc=blocks * 2 * bsz * S * N,
                part_ad=bsz * (di * N + di))


def kernel_bwd_layout(bsz: int, S: int, di: int, N: int) -> dict:
    """The layout the built library's backward takes at the shape (its
    ``selective_scan_bwd_layout``).  Builds the library at first use."""
    out = (ctypes.c_int * 7)()
    info = load_library()
    err = info.fns["selective_scan_bwd_layout"](int(bsz), int(S), int(di),
                                                int(N), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd_layout refused N={N}: "
                           f"{info.lib.cuda_error_string(err).decode()}")
    return dict(zip(("lanes", "channels", "threads", "tile", "chunks",
                     "channel_blocks", "smem"), out))


def selective_scan_bwd_cuda(dt: torch.Tensor, x: torch.Tensor,
                            z: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                            A: torch.Tensor, D: torch.Tensor,
                            dy: torch.Tensor, ckpt: torch.Tensor):
    """The gradients (ddt, dx, dz, dB, dC, dA, dD) of
    ``selective_scan_cuda(dt, x, z, B, C, A, D)`` for the output gradient
    dy (``ref.selective_scan_bwd_ref``, the output's bf16 cast taken as the
    identity), from the checkpoints that
    ``selective_scan_cuda(..., checkpoints=True)`` wrote for the same
    inputs.

    Inputs as ``selective_scan_cuda`` takes them (z may be the strided gate
    half of the input projection), B and C 16-byte aligned; dy (bsz, S,
    di) bfloat16 contiguous, 4-byte aligned; ckpt (bsz, (S - 1) // 16, di,
    N) float32 contiguous, 16-byte aligned; all on the card.  Returns ddt,
    dx (bsz, S, di), dB, dC (bsz, S, N), dA (di, N), dD (di,) float32 and
    dz (bsz, S, di) bfloat16, the same bits on every launch: one call is
    three launches on the current stream (counted as one), no
    synchronisation.

    Replaces no Pallas kernel: the JAX package takes this gradient by
    ``jax.grad`` through ``mamba_block``'s associative scan
    (``src/repro/models/ssm.py:61-72``), jnp.  Each 16-step chunk, last
    first, is recomputed from its checkpoint and run in reverse, with
    ``scan_bwd_layout(...)["states_per_lane"]`` contiguous states a lane,
    the sums over a channel's states reduced across its lanes once per
    group of steps, the state recompute and the reverse recurrence in
    fused multiply-adds.  Bound by the bytes (dt, x, dy, z read, ddt, dx,
    dz written: 22 per (b, t, d)) against the exponentials (N + 1 per
    (b, t, d)).  dB and dC (sums over d_inner) are summed over each
    block's channels in shared memory and dA and dD (sums over batch and
    steps) in registers, and leave as partial sums that a second kernel
    adds in a fixed order: no atomics.
    """
    bsz, S, di, N, ld = _check_inputs(dt, x, z, B, C, A, D)
    if (dy.dtype != torch.bfloat16 or tuple(dy.shape) != (bsz, S, di)
            or not dy.is_contiguous()):
        raise ValueError(f"dy must be contiguous torch.bfloat16 of shape "
                         f"{(bsz, S, di)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dy.data_ptr() % 4:
        raise ValueError(f"dy must start 4-byte aligned, data pointer "
                         f"{dy.data_ptr()}")
    _check(ckpt, "ckpt", torch.float32, _ckpt_shape(bsz, S, di, N))
    for name, t in (("B", B), ("C", C), ("ckpt", ckpt)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned, data "
                             f"pointer {t.data_ptr()}")
    _check_cuda([dt, x, z, B, C, A, D, dy, ckpt])
    lay = scan_bwd_layout(bsz, S, di, N)
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dz = torch.empty((bsz, S, di), dtype=torch.bfloat16, device=dt.device)
    # every element written by the ordered sums; zeros when nothing runs
    alloc = torch.empty if dt.numel() else torch.zeros
    dBC = alloc((2, bsz, S, N), **f32)
    dAD = alloc(di * N + di, **f32)
    if dt.numel():
        scratch = [torch.empty(lay[k], **f32) for k in ("part_bc", "part_ad")]
        _launch("selective_scan_bwd_launch", dt,
                (dt, x, z, B, C, A, D, dy, ckpt if ckpt.numel() else None,
                 ddt, dx, dz, dBC, dAD, *scratch, bsz, S, di, N, ld))
        selective_scan_bwd_cuda.launches += 1
    return (ddt, dx, dz, dBC[0], dBC[1], dAD[:di * N].view(di, N),
            dAD[di * N:])


selective_scan_bwd_cuda.launches = 0
