"""PyTorch wrappers of the fused sweep kernels in ``csrc/fused_sweep.cu``.

Each wrapper checks dtype, shape, contiguity and device, allocates its
outputs with ``torch.empty``, launches its kernel on PyTorch's current
stream (no synchronisation) and raises if the launch was refused.  It takes
CUDA tensors only: the CPU path is the plain version in ``ref.py``, chosen
by ``ops.py`` from the tensors' device.  ``<wrapper>.launches`` counts the
kernel launches the wrapper made; nothing else touches it but a caller that
resets it.

Site ids and B must lie in range (the samplers draw them so); the kernels
do not check them.

Both kernels replace ``_sweep_kernel`` of the TPU package
(``src/repro/kernels/fused_sweep.py:219``), which holds the whole (n, n)
tables in VMEM and gathers rows with one-hot matrix products.  On Hopper the
tables (64 MiB each at potts-64x64) cannot sit in shared memory, and a
one-hot product would do n times the work of a gather, so the kernels
gather straight from global memory: per sub-step and chain one W row (4n
bytes) and, for MGPMH, B alias entries (8 bytes each).  That traffic bounds
them; ``chip_smoke.py`` computes the bound for each run.  One block per
chain keeps the chain's state in shared memory across all S sub-steps, so x
never round-trips to global memory inside a sweep.
"""
from __future__ import annotations

import torch

from ._build import load_library

__all__ = ["gibbs_sweep_cuda", "mgpmh_sweep_cuda", "reset_launch_counts"]

# dynamic shared memory one block may use (H100: 227 KB)
_MAX_SMEM = 232448


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda(tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA sweep kernels take CUDA tensors, got "
                         f"{dev}; CPU tensors go through kernels.ops")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")


def _check_smem(n: int, D: int):
    if 4 * (n + D) + 256 > _MAX_SMEM:
        raise ValueError(f"n={n} sites do not fit one block's shared memory "
                         f"({_MAX_SMEM} bytes)")


def _launch(name: str, args):
    lib = load_library().lib
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")


def gibbs_sweep_cuda(x, W, i_sites, gumbel, *, D: int):
    """S fused vanilla-Gibbs site updates per chain (``ref.gibbs_sweep_ref``).

    x (C, n) int32; W (n, n) float32; i_sites (C, S) int32;
    gumbel (C, S, D) float32.  Returns x_out (C, n) int32.

    Replaces ``gibbs_sweep_pallas`` (``src/repro/kernels/fused_sweep.py:577``).
    Bound by bytes: one W row per sub-step and chain.  One block of 256
    threads per chain sums the row into D value buckets (eight per pass, in
    registers) and reduces them in a fixed order.
    """
    C, n = x.shape
    S = i_sites.shape[1] if i_sites.dim() == 2 else -1
    _check(x, "x", torch.int32, (C, n))
    _check(W, "W", torch.float32, (n, n))
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(gumbel, "gumbel", torch.float32, (C, S, D))
    _check_cuda([x, W, i_sites, gumbel])
    _check_smem(n, D)
    out = torch.empty_like(x)
    if C == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("gibbs_sweep_launch",
                (x.data_ptr(), W.data_ptr(), i_sites.data_ptr(),
                 gumbel.data_ptr(), out.data_ptr(), C, n, S, D, stream))
    gibbs_sweep_cuda.launches += 1
    return out


def mgpmh_sweep_cuda(x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias,
                     gumbel, logu, *, D: int, scale: float):
    """S fused MGPMH site updates per chain (``ref.mgpmh_sweep_ref``).

    x (C, n) int32; W/row_prob (n, n) float32; row_alias (n, n) int32;
    i_sites/B (C, S) int32; logu (C, S) float32; u_idx/u_alias (C, S, K)
    float32; gumbel (C, S, D) float32.  ``scale`` = L/lambda.
    Returns (x_out (C, n) int32, accepts (C,) int32).

    Replaces ``mgpmh_sweep_pallas`` (``src/repro/kernels/fused_sweep.py:505``).
    Bound by bytes: per sub-step and chain, B alias draws (two uniforms and
    two table entries each) and one W row for the exact pass.  The draws
    count into integer buckets in shared memory (order-free, exact), the
    energies are scaled once, and the exact pass sums only the two values
    the acceptance ratio reads.
    """
    C, n = x.shape
    S = i_sites.shape[1] if i_sites.dim() == 2 else -1
    K = u_idx.shape[-1]
    _check(x, "x", torch.int32, (C, n))
    _check(W, "W", torch.float32, (n, n))
    _check(row_prob, "row_prob", torch.float32, (n, n))
    _check(row_alias, "row_alias", torch.int32, (n, n))
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(B, "B", torch.int32, (C, S))
    _check(u_idx, "u_idx", torch.float32, (C, S, K))
    _check(u_alias, "u_alias", torch.float32, (C, S, K))
    _check(gumbel, "gumbel", torch.float32, (C, S, D))
    _check(logu, "logu", torch.float32, (C, S))
    _check_cuda([x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias,
                 gumbel, logu])
    _check_smem(n, D)
    out = torch.empty_like(x)
    acc = torch.empty((C,), dtype=torch.int32, device=x.device)
    if C == 0:
        return out, acc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("mgpmh_sweep_launch",
                (x.data_ptr(), W.data_ptr(), row_prob.data_ptr(),
                 row_alias.data_ptr(), i_sites.data_ptr(), B.data_ptr(),
                 u_idx.data_ptr(), u_alias.data_ptr(), gumbel.data_ptr(),
                 logu.data_ptr(), out.data_ptr(), acc.data_ptr(),
                 C, n, S, K, D, float(scale), stream))
    mgpmh_sweep_cuda.launches += 1
    return out, acc


gibbs_sweep_cuda.launches = 0
mgpmh_sweep_cuda.launches = 0


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    gibbs_sweep_cuda.launches = 0
    mgpmh_sweep_cuda.launches = 0
