"""Public kernel operations, dispatched by the tensors' device.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel (``fused_sweep.py``,
``chromatic_sweep.py``, ``minibatch_energy.py``, ``local_sweep.py``,
``flash_attention.py`` and ``selective_scan.py``, forward and backward),
which launches or raises.
Nothing falls back from one to the other.  The in-kernel-RNG forms of the
fused sweeps have no entry here (as in the JAX package): they are called
through ``fused_sweep`` directly.  The local-gibbs sweep draws in-kernel
only, and has its entry here.
"""
from __future__ import annotations

import torch

from .chromatic_sweep import gibbs_class_sweep_cuda
from .fused_sweep import (double_min_sweep_cuda, gibbs_sweep_cuda,
                          mgpmh_sweep_cuda, min_gibbs_sweep_cuda)
from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .local_sweep import local_gibbs_sweep_cuda
from .minibatch_energy import bucket_energy_cuda
from .ref import (bucket_energy_ref, double_min_sweep_ref,
                  flash_attention_bwd_ref, flash_attention_ref,
                  gibbs_class_sweep_ref, gibbs_sweep_ref, gumbel_from_uniform,
                  local_gibbs_sweep_ref, mgpmh_sweep_ref, min_gibbs_sweep_ref,
                  selective_scan_bwd_ref, selective_scan_ref)
from .selective_scan import selective_scan_bwd_cuda, selective_scan_cuda

__all__ = ["bucket_energy", "flash_attention", "flash_attention_bwd",
           "gibbs_sweep", "gibbs_class_sweep", "mgpmh_sweep",
           "min_gibbs_sweep", "double_min_sweep", "local_gibbs_sweep",
           "selective_scan", "selective_scan_bwd"]


def _route(x, op: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on 'cpu' or 'cuda' tensors, got "
                         f"{x.device}")
    return x.device.type


def bucket_energy(w, v, D: int):
    """E[c, u] = sum_k w[c, k] * 1[v[c, k] == u] (see
    ``ref.bucket_energy_ref``); values of v outside [0, D) land in no bucket.

    w (C, K) float (float16 and others cast to float32), v (C, K) integer
    (cast to int32), any C and K, no padding.  Returns (C, D) float32.
    """
    route = _route(w, "bucket_energy")
    w = w.to(torch.float32).contiguous()
    v = v.to(torch.int32).contiguous()
    if route == "cpu":
        return bucket_energy_ref(w, v, D)
    return bucket_energy_cuda(w, v, D)


def flash_attention(q, k, v, *, window: int = 0, causal: bool = True,
                    lse: bool = False):
    """Online-softmax attention over grouped-query heads (see
    ``ref.flash_attention_ref``).

    q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), float32 or bfloat16 (one
    dtype), H % KVH == 0; ``window <= 0`` is full attention; causal masking
    is top-left aligned.  Any Sq and Sk, no padding and no head repeat.
    Returns (B, Sq, H, hd) in q's dtype; with ``lse=True`` (out, lse2),
    lse2 the kernel's row statistics for ``flash_attention_bwd`` (bf16 on
    the card; None on the CPU, whose plain backward recomputes them).
    """
    route = _route(q, "flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if route == "cpu":
        out = flash_attention_ref(q, k, v, window=window, causal=causal)
        return (out, None) if lse else out
    return flash_attention_cuda(q, k, v, window=window, causal=causal,
                                lse=lse)


def flash_attention_bwd(q, k, v, out, dout, *, window: int = 0,
                        causal: bool = True, lse2=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = ``out`` for the output
    gradient ``dout`` (see ``ref.flash_attention_bwd_ref``).

    Shapes and mask as ``flash_attention``; on the card bf16 only, at the
    bf16 forward's head dims (``flash_attention.HEAD_DIMS``), with
    ``lse2`` the forward kernel's row statistics
    (``flash_attention(..., lse=True)``);
    the plain version recomputes them in float32 and takes none.  Returns
    gradients in the inputs' dtypes, shaped as q, k, v.
    """
    route = _route(q, "flash_attention_bwd")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if route == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, window=window,
                                       causal=causal)
    if lse2 is None:
        raise ValueError("the flash-attention backward kernel takes the "
                         "forward kernel's row statistics: "
                         "flash_attention(..., lse=True)")
    return flash_attention_bwd_cuda(q, k, v, out, dout, lse2, window=window,
                                    causal=causal)


def selective_scan(dt, x, z, B, C, A, D, *, checkpoints: bool = False):
    """The Mamba-1 block's selective scan with its D skip and gate (see
    ``ref.selective_scan_ref``): per (batch, channel), h_t = exp(dt_t A)
    h_{t-1} + (dt_t x_t) B_t and y_t = (C_t . h_t + D x_t) silu(z_t).

    dt, x (bsz, S, di) float32; z (bsz, S, di) in the compute dtype, which
    y takes (bf16 on the card), a row-strided view allowed (the gate half
    of the input projection, read in place); B, C (bsz, S, N) float32,
    views allowed (copied to contiguous on the card: S N floats each); A
    (di, N), D (di,) float32.  On the card N in {8, 16}.  With
    ``checkpoints`` returns (y, ckpt): the states after steps 15, 31, ...
    (bsz, (S - 1) // 16, di, N) float32, for ``selective_scan_bwd``.
    """
    if _route(dt, "selective_scan") == "cpu":
        return selective_scan_ref(dt, x, z, B, C, A, D,
                                  checkpoints=checkpoints)
    return selective_scan_cuda(dt.contiguous(), x.contiguous(), z,
                               B.contiguous(), C.contiguous(),
                               A.contiguous(), D.contiguous(),
                               checkpoints=checkpoints)


def selective_scan_bwd(dt, x, z, B, C, A, D, dy, ckpt=None):
    """(ddt, dx, dz, dB, dC, dA, dD): the gradients of
    ``selective_scan(dt, x, z, B, C, A, D)`` for the output gradient dy
    (see ``ref.selective_scan_bwd_ref``; the output's cast to z's dtype
    taken as the identity).

    Inputs as ``selective_scan``'s; dy (bsz, S, di) in y's dtype (bf16 on
    the card); ``ckpt`` the checkpoints of ``selective_scan(...,
    checkpoints=True)`` on the same inputs (on the card, when None, the
    forward kernel writes them first: one more launch).  Each gradient in
    its input's dtype and shape (dz in z's dtype, contiguous).  On the
    card N in {8, 16}.
    """
    if _route(dt, "selective_scan_bwd") == "cpu":
        return selective_scan_bwd_ref(dt, x, z, B, C, A, D, dy, ckpt)
    ins = (dt.contiguous(), x.contiguous(), z, B.contiguous(),
           C.contiguous(), A.contiguous(), D.contiguous())
    if ckpt is None:
        ckpt = selective_scan_cuda(*ins, checkpoints=True)[1]
    return selective_scan_bwd_cuda(*ins, dy.contiguous(), ckpt)


def mgpmh_sweep(x, W, row_pack, i_sites, B, u_idx, u_alias, gumbel, logu,
                *, D: int, scale: float):
    """S fused sequential MGPMH site updates per chain (see
    ``ref.mgpmh_sweep_ref`` for exact semantics).

    x (C, n) i32; W (n, n) f32; row_pack (n, n, 2) i32, the row alias
    tables as one record per entry (``MatchGraph.row_pack``): the kernel
    reads the records, the plain version the two tables as views of them.
    i_sites/B/logu (C, S); u_idx/u_alias (C, S, K) f32 uniforms; gumbel
    (C, S, D) f32.  ``scale`` = L/lambda.
    Returns (x_out (C, n) i32, accepts (C,) i32).
    """
    rest = (i_sites, B, u_idx, u_alias, gumbel, logu)
    if _route(x, "mgpmh_sweep") == "cpu":
        return mgpmh_sweep_ref(x, W, *_unpack(row_pack), *rest, D, scale)
    return mgpmh_sweep_cuda(x, W, row_pack, *rest, D=D, scale=scale)


def gibbs_sweep(x, W, i_sites, gumbel, *, D: int):
    """S fused sequential vanilla-Gibbs site updates per chain (exact
    conditionals; see ``ref.gibbs_sweep_ref``).

    x (C, n) i32; W (n, n); i_sites (C, S); gumbel (C, S, D).
    Returns x_out (C, n) i32.
    """
    if _route(x, "gibbs_sweep") == "cpu":
        return gibbs_sweep_ref(x, W, i_sites, gumbel, D)
    return gibbs_sweep_cuda(x, W, i_sites, gumbel, D=D)


def gibbs_class_sweep(x, W, nbr_pack, sites, u, *, D: int):
    """One chromatic Gibbs color class of every chain, updated IN PLACE in
    ``x``, which it returns (see ``ref.gibbs_class_sweep_ref``), its Gumbels
    ``ref.gumbel_from_uniform(u)``.

    x (C, n) i32; W (n, n) f32 and ``nbr_pack`` = (offsets, records), its
    neighbour table (``MatchGraph.nbr_pack``): the kernel walks the table,
    the plain version reads W; sites (m,) i32, a color class of a proper
    coloring; u (C, m, D) f32 uniforms (not modified): the kernel makes the
    Gumbels in-kernel, the plain version from a copy of u.
    """
    if _route(x, "gibbs_class_sweep") == "cpu":
        return x.copy_(gibbs_class_sweep_ref(
            x, W, sites, gumbel_from_uniform(u.clone()), D))
    return gibbs_class_sweep_cuda(x, *nbr_pack, sites, u, D=D)


def _unpack(pack):
    """(prob, alias) of a packed alias table, as views of its records."""
    return pack[..., 0].view(torch.float32), pack[..., 1]


def min_gibbs_sweep(x, node_pack, row_pack, i_sites, B, u_node, u_nacc,
                    u_row, u_racc, gumbel, cache, *, D: int, lscale: float):
    """S fused sequential MIN-Gibbs site updates per chain with the cached
    energy estimate threaded through (see ``ref.min_gibbs_sweep_ref``).

    x (C, n) i32; node_pack (n, 2) / row_pack (n, n, 2) i32, the node and
    row alias tables as one record per entry
    (``core.factor_graph.pack_alias``; ``MatchGraph.row_pack``): the kernel
    reads the records, the plain version the two tables as views of them.
    i_sites (C, S); B (C, S, D) i32; u_node/u_nacc/u_row/u_racc
    (C, S, D, K) f32 uniforms; gumbel (C, S, D) f32; cache (C,) f32.
    ``lscale`` = log1p(Psi/lam).  Returns (x_out (C, n) i32,
    cache_out (C,) f32).
    """
    rest = (i_sites, B, u_node, u_nacc, u_row, u_racc, gumbel, cache)
    if _route(x, "min_gibbs_sweep") == "cpu":
        return min_gibbs_sweep_ref(x, *_unpack(node_pack), *_unpack(row_pack),
                                   *rest, D, lscale)
    return min_gibbs_sweep_cuda(x, node_pack, row_pack, *rest, D=D,
                                lscale=lscale)


def double_min_sweep(x, row_pack, node_pack, i_sites, B1, u_idx, u_alias,
                     gumbel, B2, u_node, u_nacc, u_row, u_racc, logu, cache,
                     *, D: int, scale1: float, lscale2: float):
    """S fused sequential DoubleMIN site updates per chain with the cached
    xi_x threaded through (see ``ref.double_min_sweep_ref``, whose order of
    tables, row before node, it keeps).

    x (C, n) i32; row_pack/node_pack as in min_gibbs_sweep;
    i_sites/B1/B2/logu (C, S); u_idx/u_alias (C, S, K1) f32;
    u_node/u_nacc/u_row/u_racc (C, S, K2) f32; gumbel (C, S, D) f32;
    cache (C,) f32.  ``scale1`` = L/lam1, ``lscale2`` = log1p(Psi/lam2).
    Returns (x_out (C, n) i32, cache_out (C,) f32, accepts (C,) i32).
    """
    rest = (i_sites, B1, u_idx, u_alias, gumbel, B2, u_node, u_nacc, u_row,
            u_racc, logu, cache)
    if _route(x, "double_min_sweep") == "cpu":
        return double_min_sweep_ref(x, *_unpack(row_pack),
                                    *_unpack(node_pack), *rest, D, scale1,
                                    lscale2)
    return double_min_sweep_cuda(x, row_pack, node_pack, *rest, D=D,
                                 scale1=scale1, lscale2=lscale2)


def local_gibbs_sweep(x, W, i_sites, seed, *, B: int, D: int,
                      scale: float):
    """S fused sequential Local Minibatch Gibbs site updates per chain, the
    B-subsets (Floyd's algorithm) and Gumbels drawn from Philox under
    ``seed`` (see ``ref.local_gibbs_sweep_ref``).

    x (C, n) i32; W (n, n) f32; i_sites (C, S) i32; seed (1,) i32;
    1 <= B <= n - 1; ``scale`` = (n-1)/B.  Returns x_out (C, n) i32.
    """
    if _route(x, "local_gibbs_sweep") == "cpu":
        return local_gibbs_sweep_ref(x, W, i_sites, seed, B, D, scale)
    return local_gibbs_sweep_cuda(x, W, i_sites, seed, B=B, D=D, scale=scale)
