"""Plain PyTorch versions of the fused sweep kernels.

``gibbs_sweep_ref`` / ``mgpmh_sweep_ref`` are the semantic definition of
the CUDA kernels in ``csrc/fused_sweep.cu``: S sequentially composed
single-site updates per call, consuming *pre-drawn* uniforms, Gumbels and
Poisson totals, so a kernel and its plain version make the same random
choices and their states can be compared exactly.  They follow the JAX
oracles (``repro/kernels/ref.py``) step for step; the CPU path of the
engines and the tests use them, and the card uses them only as the
comparison in ``chip_smoke.py``.

Two choices the kernels share, for bit-equal results on one device:
  * the MGPMH minibatch energy counts matching draws first and scales once
    (``scale * count``), where the JAX oracle sums ``scale`` per draw (the
    two can differ in the last bit, which flips a decision only at a
    near-tie);
  * argmax takes the FIRST maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import torch

__all__ = ["bucket_energy_ref", "gibbs_sweep_ref", "mgpmh_sweep_ref"]


def _onehot(v: torch.Tensor, D: int) -> torch.Tensor:
    """float32 one-hot over the last axis; values outside [0, D) land in no
    bucket (as ``jax.nn.one_hot``)."""
    return (v[..., None] == torch.arange(D, device=v.device)).to(torch.float32)


def bucket_energy_ref(w: torch.Tensor, v: torch.Tensor, D: int) -> torch.Tensor:
    """E[c, u] = sum_k w[c, k] * 1[v[c, k] == u].

    w: (C, K) float, v: (C, K) int in [0, D). Returns (C, D) float32.
    """
    return torch.einsum("ck,ckd->cd", w.to(torch.float32), _onehot(v, D))


def gibbs_sweep_ref(x, W, i_sites, gumbel, D: int):
    """S sequentially composed vanilla-Gibbs site updates (Algorithm 1).

    Per sub-step: eps_u = sum_j W[i,j] 1[x_j = u] exactly, then
    x_i <- argmax_u eps_u + gumbel_u (Gumbel-max == categorical(exp eps)).
    x (C, n) int32; W (n, n) f32; i_sites (C, S) int32; gumbel (C, S, D) f32.
    Returns x_out (C, n) int32 (the input is not modified).
    """
    C = x.shape[0]
    rows = torch.arange(C, device=x.device)
    x = x.clone()
    for s in range(i_sites.shape[1]):
        i = i_sites[:, s].long()
        eps = bucket_energy_ref(W[i], x, D)                    # (C, D)
        x[rows, i] = torch.argmax(eps + gumbel[:, s, :], dim=-1).to(x.dtype)
    return x


def mgpmh_sweep_ref(x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias,
                    gumbel, logu, D: int, scale: float):
    """S sequentially composed MGPMH site updates (Algorithm 4 per sub-step).

    Per sub-step s (all chains c in parallel, sites sequential in s):
      j_k   ~ alias(W[i_s]/L_i)            from u_idx/u_alias   (x-independent)
      eps_u = scale * #{k < B : x[j_k] = u}                     (minibatch)
      v     = argmax_u eps_u + gumbel_u                         (proposal)
      log a = (exact_v - exact_{x_i}) + (eps_{x_i} - eps_v)     (exact MH)
      accept iff logu < log a, where exact_u = sum_j W[i,j] 1[x_j = u].

    x: (C, n) int32; W/row_prob/row_alias: (n, n); i_sites/B/logu: (C, S);
    u_idx/u_alias: (C, S, K); gumbel: (C, S, D).  ``scale`` is L/lambda.
    Returns (x_out (C, n) int32, accepts (C,) int32).
    """
    C, n = x.shape
    K = u_idx.shape[-1]
    dev = x.device
    rows = torch.arange(C, device=dev)
    # the alias draws are x-independent: hoist them out of the loop
    idx = torch.clamp((u_idx * n).to(torch.int32), max=n - 1).long()
    ii = i_sites.long()[:, :, None]
    j_all = torch.where(u_alias < row_prob[ii, idx], idx,
                        row_alias[ii, idx].long())             # (C, S, K)
    live = torch.arange(K, device=dev) < B[:, :, None]         # (C, S, K)
    scale_f = torch.tensor(scale, dtype=torch.float32, device=dev)
    x = x.clone()
    acc = torch.zeros((C,), dtype=torch.int32, device=dev)
    for s in range(i_sites.shape[1]):
        i = i_sites[:, s].long()
        vals = torch.gather(x, 1, j_all[:, s, :])              # (C, K)
        counts = (_onehot(vals, D) * live[:, s, :, None]).sum(1)
        eps = scale_f * counts                                  # (C, D)
        v = torch.argmax(eps + gumbel[:, s, :], dim=-1)
        xi = x[rows, i].long()
        w_row = W[i]                                           # (C, n)
        exact_v = torch.sum(w_row * (x == v[:, None]), dim=1)
        exact_xi = torch.sum(w_row * (x == xi[:, None]), dim=1)
        log_a = (exact_v - exact_xi) + (eps[rows, xi] - eps[rows, v])
        accept = logu[:, s] < log_a
        x[rows, i] = torch.where(accept, v, xi).to(x.dtype)
        acc += accept.to(torch.int32)
    return x, acc
