"""Mamba-1 selective state-space block (the falcon-mamba / hymba branch) in
PyTorch: the counterpart of ``repro/models/ssm.py``.

Prefill and training (``mamba_block``) run the selective scan, with its
D skip and gate, through ``ops.selective_scan``: on the card the
hand-written kernel (``kernels/csrc/selective_scan.cu``), on the CPU its
plain version; the reference's associative scan over (B, S, d_inner, N)
float32 tensors has no counterpart here.  With grad on, the scan is
``SelectiveScan``, whose backward is ``ops.selective_scan_bwd`` (the
backward kernel of the same source on the card), where the reference
takes ``jax.grad`` through its scan.  Decode (``mamba_decode_step``) is
the O(1) one-token recurrence on the carried (conv, state), eager on both
devices.

Mixed precision follows the reference's promotions exactly, after its
``_cast_params`` (every leaf of two dimensions in bf16, ``A_log`` and
``conv`` included; ``conv_bias``, ``dt_bias`` and ``D`` float32):
  * the prefill's causal conv is K shifted bf16 products summed in bf16;
    adding the float32 ``conv_bias`` promotes it to float32 before silu;
  * ``xc @ w_x`` and ``proj[..., :dt_rank] @ w_dt`` are float32 x bf16
    products, float32 GEMMs (the weight widened here, since PyTorch
    refuses mixed-dtype products; TF32 stays off, PyTorch's default);
  * A = -exp(float(A_log)) with A_log in bf16;
  * the prefill casts y to the compute dtype before ``@ w_out`` (a bf16
    GEMM); decode keeps y float32 into ``@ w_out`` (a float32 GEMM) and
    casts after; decode's conv is one einsum rounded once.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import COMPUTE_DTYPE, compute_weight, new_weight

__all__ = ["mamba_block", "mamba_decode_step", "SSMCache", "init_ssm_cache",
           "Mamba", "SelectiveScan"]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_inner) last inputs for the causal conv
    state: torch.Tensor  # (B, d_inner, N) ssm hidden state


def init_ssm_cache(batch: int, d_inner: int, conv_kernel: int, n_state: int,
                   dtype=torch.float32, device=None) -> SSMCache:
    """Zeros of the reference's layout, both in ``dtype`` (the model's
    decode cache keeps conv in the compute dtype and the state in float32:
    ``transformer.init_cache``)."""
    return SSMCache(
        conv=torch.zeros((batch, conv_kernel - 1, d_inner), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, d_inner, n_state), dtype=dtype,
                          device=device))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype of the two, as jnp's ``@`` promotes (a
    float32 activation times a bf16 weight is a float32 product)."""
    dtype = torch.promote_types(a.dtype, w.dtype)
    return a.to(dtype) @ w.to(dtype)


def _ssm_params(x_conv, p, n_state: int):
    """Common projections: (dt (B, S, di), Bmat (B, S, N), Cmat (B, S, N),
    A (di, N)), all float32 (the recurrence is numerically sensitive, so it
    runs in float32 whatever the compute dtype).  Bmat and Cmat are views
    of the projection."""
    proj = _mm(x_conv, p["w_x"])                        # (B, S, dt_rank+2N)
    dt_rank = p["w_dt"].shape[0]
    dt = F.softplus(_mm(proj[..., :dt_rank], p["w_dt"]).to(torch.float32)
                    + p["dt_bias"])
    Bmat = proj[..., dt_rank:dt_rank + n_state].to(torch.float32)
    Cmat = proj[..., dt_rank + n_state:].to(torch.float32)
    A = -torch.exp(p["A_log"].to(torch.float32))      # (di, N)
    return dt, Bmat, Cmat, A


class SelectiveScan(torch.autograd.Function):
    """``ops.selective_scan`` with its gradient ``ops.selective_scan_bwd``:
    on the card the forward and backward kernels, on the CPU their plain
    versions.  The forward also writes the states after steps 15, 31, ...
    (``checkpoints=True``: (S - 1) // 16 x d_inner x N float32 a batch
    row, 134 MB at falcon-mamba-7b's layer, B=1 S=4096) and saves them
    with the seven inputs (z as the view it was given, the gate half of
    the input projection); the backward kernel restarts each 16-step chunk
    from its checkpoint, so it repeats no pass of the forward and keeps no
    (S, d_inner, N) tensor.  Under the trainer's rematerialisation both
    forwards of a step write checkpoints; only the group being
    backpropagated keeps them."""

    @staticmethod
    def forward(ctx, dt, x, z, B, C, A, D):
        y, ckpt = ops.selective_scan(dt, x, z, B, C, A, D, checkpoints=True)
        ctx.save_for_backward(dt, x, z, B, C, A, D, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ins, ckpt = ctx.saved_tensors
        return ops.selective_scan_bwd(*ins, dy, ckpt)


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor], *, n_state: int,
                conv_kernel: int = 4) -> torch.Tensor:
    """Full-sequence selective scan.  x: (B, S, d).

    p: w_in (d, 2 di), conv (K, di), conv_bias (di,), w_x (di, dt_rank+2N),
    w_dt (dt_rank, di), dt_bias (di,), A_log (di, N), D (di,), w_out
    (di, d).  Returns (B, S, d) in x's dtype.
    """
    S = x.shape[1]
    xz = x @ p["w_in"]
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv (kernel K): shifted products, summed in order
    pad = F.pad(xi, (0, 0, conv_kernel - 1, 0))
    xc = None
    for k in range(conv_kernel):
        term = pad[:, k:k + S, :] * p["conv"][k]
        xc = term if xc is None else xc + term
    xc = F.silu(xc + p["conv_bias"])

    dt, Bm, Cm, A = _ssm_params(xc, p, n_state)
    ins = (dt, xc.to(torch.float32), z, Bm, Cm, A, p["D"])
    # h_t = exp(dt A) h_{t-1} + dt B_t x_t;  y_t = (C_t . h_t + D x_t)
    # silu(z_t), in z's dtype
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        y = SelectiveScan.apply(*ins)
    else:
        y = ops.selective_scan(*ins)
    return (y.to(x.dtype) @ p["w_out"]).to(x.dtype)


def mamba_decode_step(x: torch.Tensor, p: Dict[str, torch.Tensor],
                      cache: SSMCache, *, n_state: int, conv_kernel: int = 4
                      ) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token recurrence.  x: (B, 1, d).  Returns (out (B, 1, d) in
    x's dtype, the new cache in the cache's dtypes); ``cache`` is not
    modified."""
    if x.shape[1] != 1:
        raise ValueError(f"mamba_decode_step takes one token, got "
                         f"{x.shape[1]}")
    xz = x[:, 0] @ p["w_in"]
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]

    hist = torch.cat([cache.conv, xi[:, None, :]], dim=1)      # (B, K, di)
    out_dtype = torch.promote_types(hist.dtype, p["conv"].dtype)
    xc = torch.einsum("bkd,kd->bd", hist.to(torch.float32),
                      p["conv"].to(torch.float32)).to(out_dtype)
    xc = F.silu(xc + p["conv_bias"])
    new_conv = hist[:, 1:, :]

    dt, Bm, Cm, A = _ssm_params(xc[:, None, :], p, n_state)
    dt, Bm, Cm = dt[:, 0], Bm[:, 0], Cm[:, 0]
    xf = xc.to(torch.float32)
    decay = torch.exp(dt[..., None] * A[None, :, :])           # (B, di, N)
    h = (cache.state.to(torch.float32) * decay
         + (dt * xf)[..., None] * Bm[:, None, :])
    y = torch.einsum("bdn,bn->bd", h, Cm) + xf * p["D"]
    y = y * F.silu(z.to(torch.float32))
    out = _mm(y, p["w_out"]).to(x.dtype)[:, None, :]
    return out, SSMCache(conv=new_conv.to(cache.conv.dtype),
                         state=h.to(cache.state.dtype))


class Mamba(nn.Module):
    """The SSM branch of a layer: the nine leaves of the reference's
    ``_init_ssm`` under its names, so ``params_from_jax`` is a copy.
    Leaves of two dimensions (``w_in``, ``conv``, ``w_x``, ``w_dt``,
    ``A_log``, ``w_out``) compute in bf16, the 1-D ones (``conv_bias``,
    ``dt_bias``, ``D``) in float32; stored as ``layers.new_weight`` makes
    them (the serve form in those dtypes, the master form in float32)."""

    LEAVES = ("w_in", "conv", "conv_bias", "w_x", "w_dt", "dt_bias",
              "A_log", "D", "w_out")

    def __init__(self, cfg: ModelConfig, device=None, master: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, shape in self.shapes(cfg).items():
            setattr(self, name, new_weight(
                shape, COMPUTE_DTYPE if len(shape) >= 2 else torch.float32,
                device, master))

    @staticmethod
    def shapes(cfg: ModelConfig) -> Dict[str, tuple]:
        d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, \
            cfg.conv_kernel
        r = cfg.dt_rank
        return {"w_in": (d, 2 * di), "conv": (K, di), "conv_bias": (di,),
                "w_x": (di, r + 2 * N), "w_dt": (r, di), "dt_bias": (di,),
                "A_log": (di, N), "D": (di,), "w_out": (di, d)}

    def weights(self) -> Dict[str, torch.Tensor]:
        return {k: compute_weight(getattr(self, k)) for k in self.LEAVES}

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return mamba_block(h, self.weights(), n_state=self.cfg.ssm_state,
                           conv_kernel=self.cfg.conv_kernel)

    def decode(self, h: torch.Tensor, cache: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        """One token; ``cache`` is this layer's {conv, state} view of the
        decode cache, written in place."""
        out, new = mamba_decode_step(
            h, self.weights(), SSMCache(cache["conv"], cache["state"]),
            n_state=self.cfg.ssm_state, conv_kernel=self.cfg.conv_kernel)
        cache["conv"].copy_(new.conv)
        cache["state"].copy_(new.state)
        return out
