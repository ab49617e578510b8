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

MIN-Gibbs and DoubleMIN draw their global minibatches in two stages, as the
JAX oracles do: endpoint ``a`` from a node alias table (p_a = L_a / 2Psi),
endpoint ``b`` from row a's alias table (p_b = W_ab / L_a), so
p({a, b}) = M_phi / Psi with (n,)-indexed tables only.

The ``*_rng_ref`` versions are the plain versions of the in-kernel-RNG
kernels: each makes its uniform streams from the seed with
``philox.uniforms`` (the layout the kernels reproduce) and calls the
host-stream version.  They hold the whole streams in memory, so they run at
test and check sizes only.

``local_gibbs_sweep_ref`` is the plain version of the Local Minibatch Gibbs
sweep kernel (``csrc/local_sweep.cu``): Philox words, Floyd's subsets and
Gumbels from the seed, then the sub-steps in order, each bucket summed
over the subset in draw order, as the kernel sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import philox

__all__ = ["bucket_energy_ref", "gibbs_sweep_ref", "gibbs_class_sweep_ref",
           "mgpmh_sweep_ref",
           "min_gibbs_sweep_ref", "double_min_sweep_ref",
           "mgpmh_sweep_rng_ref", "min_gibbs_sweep_rng_ref",
           "double_min_sweep_rng_ref", "local_gibbs_subsets",
           "local_gibbs_sweep_ref", "flash_attention_ref",
           "flash_attention_bwd_ref", "selective_scan_ref",
           "selective_scan_bwd_ref", "SCAN_CKPT_STEPS"]

NEG_INF = -1e30     # the masked score of the TPU kernel (not -inf)
# steps between the selective scan's checkpoints: the state after steps
# 15, 31, ... (csrc/selective_scan.cu kBT), which the backward restarts from
SCAN_CKPT_STEPS = 16


def _onehot(v: torch.Tensor, D: int) -> torch.Tensor:
    """float32 one-hot over the last axis; values outside [0, D) land in no
    bucket (as ``jax.nn.one_hot``)."""
    return (v[..., None] == torch.arange(D, device=v.device)).to(torch.float32)


def _at_code(t: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """``t[c, code[c]]`` per row of a (C, D) table; 0 where ``code[c]``
    lies outside [0, D), where the kernels read no bucket."""
    D = t.shape[-1]
    idx = code.clamp(0, D - 1)
    return torch.where(idx == code, t.gather(1, idx[:, None])[:, 0],
                       torch.zeros((), dtype=t.dtype, device=t.device))


def bucket_energy_ref(w: torch.Tensor, v: torch.Tensor, D: int) -> torch.Tensor:
    """E[c, u] = sum_k w[c, k] * 1[v[c, k] == u] for u in [0, D).

    The plain version of the bucket-energy kernel
    (``csrc/bucket_energy.cu``) and the shared primitive of the samplers:
    minibatch energies (``w = scale * mask`` or ``W[i, j]``, ``v = x[j]``)
    and the exact conditional pass (``w = W[i, :]``, ``v = x``).
    w: (C, K) float, v: (C, K) int; values of v outside [0, D) land in no
    bucket (the JAX package's padding convention).  Returns (C, D) float32.
    """
    return torch.einsum("ck,ckd->cd", w.to(torch.float32), _onehot(v, D))


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                       D: torch.Tensor, *, checkpoints: bool = False):
    """The plain version of the selective-scan kernel
    (``csrc/selective_scan.cu``): per (batch, channel), from h = 0,

      h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
      y_t = (sum_n C_t[n] h_t[n] + D x_t) * silu(z_t)

    sequentially in t, in float32 (in dt's dtype where that is wider:
    float64 in the tests), the state's products and sums rounded one by
    one in the kernel's order (the sum over n in PyTorch's order, the
    exponential accurate); the function the JAX package's ``mamba_block``
    computes with an associative scan (``src/repro/models/ssm.py:61-72``).

    dt, x (bsz, S, di) float32; z (bsz, S, di), any strides; B, C (bsz,
    S, N) float32; A (di, N), D (di,) float32; any N.  Returns y (bsz, S,
    di) in z's dtype (the block's compute dtype); with ``checkpoints``
    (y, ckpt): ckpt (bsz, (S - 1) // SCAN_CKPT_STEPS, di, N) holds h after
    steps 15, 31, ... (each checkpoint before the last step), in h's
    dtype, for ``selective_scan_bwd_ref``.
    """
    bsz, S, di = dt.shape
    K = SCAN_CKPT_STEPS
    ct = torch.promote_types(dt.dtype, torch.float32)
    h = torch.zeros((bsz, di, A.shape[-1]), dtype=ct, device=dt.device)
    y = torch.empty((bsz, S, di), dtype=ct, device=dt.device)
    ckpt = (torch.empty((bsz, max(S - 1, 0) // K, *h.shape[1:]), dtype=ct,
                        device=dt.device) if checkpoints else None)
    for t in range(S):
        decay = torch.exp(dt[:, t, :, None] * A)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        y[:, t] = (h * C[:, t, None, :]).sum(-1) + D * x[:, t]
        if checkpoints and (t + 1) % K == 0 and t + 1 < S:
            ckpt[:, (t + 1) // K - 1] = h
    y = (y * F.silu(z.to(ct))).to(z.dtype)
    return (y, ckpt) if checkpoints else y


def selective_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor,
                           z: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           A: torch.Tensor, D: torch.Tensor, dy: torch.Tensor,
                           ckpt: torch.Tensor = None):
    """The plain version of the selective-scan backward kernel
    (``csrc/selective_scan.cu``): the gradients of ``selective_scan_ref``
    (its final cast taken as the identity) for the output gradient dy.

    One forward pass keeps h_{t-1} and y_pre_t = C_t . h_t + D x_t (given
    ``ckpt``, the checkpoints of ``selective_scan_ref(...,
    checkpoints=True)``, it restarts h from each one, as the kernel
    restarts each chunk: the same gradients, bit for bit, from the plain
    forward's checkpoints), then one reverse pass in t, with g = silu(z)
    and dy_pre = dy g:

      dz_t = dy_t y_pre_t silu'(z_t)
      dh_t = dy_pre_t C_t + exp(dt_{t+1} A) dh_{t+1}          (dh_S = 0)
      ddt_t = sum_n dh_t (A exp(dt_t A) h_{t-1} + x_t B_t)
      dx_t = D dy_pre_t + dt_t sum_n dh_t B_t
      dB_t = sum_d dt_t x_t dh_t,   dC_t = sum_d dy_pre_t h_t
      dA = sum_{b,t} dh_t dt_t exp(dt_t A) h_{t-1},   dD = sum_{b,t} dy_pre_t x_t

    in float32, computed as the inputs' dtype when that is wider (float64
    in the tests).  Sums over n and d in PyTorch's order; dA summed over t
    from the last step down per batch row, then over the rows; dD in one
    ``sum`` over (b, t).  Same shapes as the forward, dy (bsz, S, di) in
    any float dtype; any N.  Returns (ddt, dx, dz, dB, dC, dA, dD), each in
    its input's dtype (dz in z's: bf16 on the card).
    """
    bsz, S, di = dt.shape
    ct = torch.promote_types(dt.dtype, torch.float32)
    f = lambda t: t.to(ct)
    dt, x, B, C, A, D = map(f, (dt, x, B, C, A, D))
    zf, dyf = f(z), f(dy)
    sig = torch.sigmoid(zf)
    dyp = dyf * zf * sig                               # dy silu(z)
    h = torch.zeros((bsz, di, A.shape[-1]), dtype=ct, device=dt.device)
    hprev = torch.empty((bsz, S, *h.shape[1:]), dtype=ct, device=dt.device)
    ypre = torch.empty((bsz, S, di), dtype=ct, device=dt.device)
    for t in range(S):
        if ckpt is not None and t and t % SCAN_CKPT_STEPS == 0:
            h = ckpt[:, t // SCAN_CKPT_STEPS - 1].to(ct)
        hprev[:, t] = h
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :])
        ypre[:, t] = (h * C[:, t, None, :]).sum(-1) + D * x[:, t]
    dz = dyf * ypre * (sig * (1 + zf * (1 - sig)))
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(h)
    dh = torch.zeros_like(h)
    decay_next = torch.zeros_like(h)
    for t in reversed(range(S)):
        dtx = (dt[:, t] * x[:, t])[..., None]
        decay = torch.exp(dt[:, t, :, None] * A)
        q = decay * hprev[:, t]                        # exp(dt A) h_{t-1}
        h_t = q + dtx * B[:, t, None, :]
        dh = dyp[:, t, :, None] * C[:, t, None, :] + decay_next * dh
        dC[:, t] = (dyp[:, t, :, None] * h_t).sum(1)
        dB[:, t] = (dtx * dh).sum(1)
        ddt[:, t] = (dh * (A * q + x[:, t, :, None] * B[:, t, None, :])
                     ).sum(-1)
        dx[:, t] = D * dyp[:, t] + dt[:, t] * (dh * B[:, t, None, :]).sum(-1)
        dA += dh * dt[:, t, :, None] * q
        decay_next = decay
    dD = (dyp * x).sum((0, 1))
    return (ddt, dx, dz.to(z.dtype), dB, dC, dA.sum(0), dD)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, causal: bool = True
                        ) -> torch.Tensor:
    """softmax(q k^T * hd^-0.5, masked) v over grouped-query heads: the plain
    version of the flash-attention kernel (``csrc/flash_attention.cu``), with
    the TPU kernel's arithmetic (``_kernel`` in
    ``src/repro/kernels/flash_attention.py``).

    q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), float32 or bfloat16, H % KVH
    == 0: query head h reads KV head h // (H // KVH).  Key j is valid for
    query i when (causal) i >= j and (window > 0) i - j < window, both
    counted from 0 even when Sq != Sk; ``window <= 0`` is full attention.
    Scores are the float32 dot times hd^-0.5, masked to -1e30; p =
    exp(s - max) is cast to v's dtype before the PV product, which sums in
    float32; out = acc / max(l, 1e-30) in q's dtype.  A row with no valid
    key is zeros (the TPU kernel leaves that row to its padding).  One batch
    element at a time: the (H, Sq, Sk) float32 scores of one element are the
    largest transient.
    """
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i >= j
    if window > 0:
        mask &= (i - j) < window
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b].transpose(0, 1).to(torch.float32)             # (H, Sq, hd)
        kb = k[b].transpose(0, 1).repeat_interleave(G, dim=0)   # (H, Sk, hd)
        vb = v[b].transpose(0, 1).repeat_interleave(G, dim=0)
        s = (qb @ kb.to(torch.float32).transpose(1, 2)) * hd ** -0.5
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        acc = p.to(v.dtype).to(torch.float32) @ vb.to(torch.float32)
        o = acc / torch.clamp(l, min=1e-30)
        o = o.masked_fill(~mask.any(dim=-1)[None, :, None], 0.0)
        out[b] = o.transpose(0, 1).to(q.dtype)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, *, window: int = 0,
                            causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v)`` = ``out`` for the
    output gradient ``dout``: the plain version of the backward kernel
    (``csrc/flash_attention_bwd.cu``), recomputed in float32 from the same
    inputs.

    With s = q k^T * hd^-0.5 (masked as the forward masks it), P =
    softmax(s) and D_i = sum_d dout_id out_id: dv = P^T dout, dS = P (dout
    v^T - D), dq = dS k * hd^-0.5, dk = dS^T q * hd^-0.5; dk and dv sum the
    G query heads of each KV head.  A row with no valid key has P = 0.
    Returns the gradients in the inputs' dtypes.  One (batch element, KV
    head) at a time: its (G, Sq, Sk) float32 scores are the largest
    transient.  P and dS stay float32 here (the kernel rounds them to
    bf16 for its products).
    """
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G, scale = H // KVH, hd ** -0.5
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i >= j
    if window > 0:
        mask &= (i - j) < window
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = torch.float32
    for b in range(B):
        for kh in range(KVH):
            heads = slice(kh * G, (kh + 1) * G)
            qb, ob, dob = (t[b, :, heads].to(f32).transpose(0, 1)
                           for t in (q, out, dout))             # (G, Sq, hd)
            kb, vb = k[b, :, kh].to(f32), v[b, :, kh].to(f32)   # (Sk, hd)
            s = (qb @ kb.T * scale).masked_fill(~mask, -torch.inf)
            lse = torch.logsumexp(s, dim=-1, keepdim=True)
            p = torch.where(mask, torch.exp(s - lse), 0.0)      # (G, Sq, Sk)
            dsum = (dob * ob).sum(dim=-1, keepdim=True)
            ds = p * (dob @ vb.T - dsum)
            dv[b, :, kh] = (p.transpose(1, 2) @ dob).sum(dim=0).to(v.dtype)
            dk[b, :, kh] = ((ds.transpose(1, 2) @ qb).sum(dim=0)
                            * scale).to(k.dtype)
            dq[b, :, heads] = (ds @ kb * scale).transpose(0, 1).to(q.dtype)
    return dq, dk, dv


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


def gibbs_class_sweep_ref(x, W, sites, gumbel, D: int):
    """One chromatic Gibbs color class of every chain, as one block update:
    x[c, i] <- argmax_u (eps[c, k, u] + gumbel[c, k, u]) for i = sites[k],
    eps = einsum(W[sites], onehot(x)), every eps read from the state the
    class started from (first maximum; values outside [0, D) match no
    bucket).

    The plain version of the class kernel (``csrc/chromatic_sweep.cu``),
    dense and independent of its neighbour table.  Equal to
    ``gibbs_sweep_ref`` fed ``i_sites`` = the class in any order when the
    class sites share no factor.  x (C, n) int32; W (n, n) float32; sites
    (m,) int; gumbel (C, m, D) float32.  Returns x_out (C, n) int32 (the
    input is not modified).
    """
    idx = sites.long()
    eps = torch.einsum("kj,cjd->ckd", W[idx], _onehot(x, D))   # (C, m, D)
    x = x.clone()
    x[:, idx] = torch.argmax(eps + gumbel, dim=-1).to(x.dtype)
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
        # a current value outside [0, D) matches no bucket and no draw
        exact_xi = torch.where((xi >= 0) & (xi < D),
                               torch.sum(w_row * (x == xi[:, None]), dim=1),
                               0.0)
        log_a = (exact_v - exact_xi) + (_at_code(eps, xi) - eps[rows, v])
        accept = logu[:, s] < log_a
        x[rows, i] = torch.where(accept, v, xi).to(x.dtype)
        acc += accept.to(torch.int32)
    return x, acc


def _pair_pick(node_prob, node_alias, row_prob, row_alias, u_node, u_nacc,
               u_row, u_racc, n):
    """Two-stage global factor draw: endpoint ``a`` from the node alias
    table, endpoint ``b`` from row ``a``'s alias table.  All uniforms
    (..., K)-shaped; returns int64 endpoint arrays ``(a, b)``."""
    idx1 = torch.clamp((u_node * n).to(torch.int32), max=n - 1).long()
    a = torch.where(u_nacc < node_prob[idx1], idx1, node_alias[idx1].long())
    idx2 = torch.clamp((u_row * n).to(torch.int32), max=n - 1).long()
    b = torch.where(u_racc < row_prob[a, idx2], idx2,
                    row_alias[a, idx2].long())
    return a, b


def min_gibbs_sweep_ref(x, node_prob, node_alias, row_prob, row_alias,
                        i_sites, B, u_node, u_nacc, u_row, u_racc, gumbel,
                        cache, D: int, lscale: float):
    """S sequentially composed MIN-Gibbs site updates (Algorithm 2 per
    sub-step), the cached energy estimate threaded through.

    Per sub-step s (all chains c in parallel, sites sequential in s):
      {a_k, b_k} ~ p_phi = M_phi/Psi   two-stage draw, per candidate u
      eps_u = lscale * #{k < B_u : x_u[a_k] = x_u[b_k]},  x_u = x[i_s <- u]
      eps_{x(i)} <- cache              (Alg 2's augmented-state slot)
      v = argmax_u eps_u + gumbel_u;  x[i_s] <- v;  cache <- eps_v.

    x (C, n) int32; node_prob/node_alias (n,); row_prob/row_alias (n, n);
    i_sites (C, S); B (C, S, D) int32 per-candidate Poisson totals;
    u_node/u_nacc/u_row/u_racc (C, S, D, K) f32; gumbel (C, S, D);
    cache (C,) f32.  ``lscale`` = log1p(Psi/lam).
    Returns (x_out (C, n) int32, cache_out (C,) f32).
    """
    C, n = x.shape
    K = u_node.shape[-1]
    dev = x.device
    rows = torch.arange(C, device=dev)
    # the factor draws are x-independent: hoist them out of the loop
    a, b = _pair_pick(node_prob, node_alias, row_prob, row_alias,
                      u_node, u_nacc, u_row, u_racc, n)      # (C, S, D, K)
    live = torch.arange(K, device=dev) < B[..., None]         # (C, S, D, K)
    u_cand = torch.arange(D, device=dev)[None, :, None]
    lscale_f = torch.tensor(lscale, dtype=torch.float32, device=dev)
    x = x.clone()
    for s in range(i_sites.shape[1]):
        i = i_sites[:, s].long()[:, None, None]
        a_s, b_s = a[:, s], b[:, s]                          # (C, D, K)
        xa = torch.gather(x, 1, a_s.reshape(C, -1)).reshape(a_s.shape)
        xb = torch.gather(x, 1, b_s.reshape(C, -1)).reshape(b_s.shape)
        xa = torch.where(a_s == i, u_cand, xa.long())
        xb = torch.where(b_s == i, u_cand, xb.long())
        m = ((xa == xb) & live[:, s]).sum(-1).to(torch.float32)
        eps = lscale_f * m                                   # (C, D)
        xi = x[rows, i[:, 0, 0]].long()
        # the current value's slot takes the cache (none outside [0, D))
        eps = torch.where(u_cand[:, :, 0] == xi[:, None], cache[:, None],
                          eps)
        v = torch.argmax(eps + gumbel[:, s], dim=-1)
        x[rows, i[:, 0, 0]] = v.to(x.dtype)
        cache = eps[rows, v]
    return x, cache.clone()


def double_min_sweep_ref(x, row_prob, row_alias, node_prob, node_alias,
                         i_sites, B1, u_idx, u_alias, gumbel, B2, u_node,
                         u_nacc, u_row, u_racc, logu, cache, D: int,
                         scale1: float, lscale2: float):
    """S sequentially composed DoubleMIN site updates (Algorithm 5 per
    sub-step), the cached second-batch estimate xi_x threaded through.

    Per sub-step s:
      j_k  ~ alias(W[i_s]/L_i)        MGPMH proposal minibatch (u_idx/u_alias)
      eps_u = scale1 * #{k < B1 : x[j_k] = u};  v = argmax_u eps_u + gumbel_u
      {a_k, b_k} ~ p_phi              second (global) batch, two-stage draw
      xi_y = lscale2 * #{k < B2 : y[a_k] = y[b_k]},  y = x[i_s <- v]
      log a = (xi_y - cache) + (eps_{x(i)} - eps_v);  accept iff logu < log a
      on accept: x <- y, cache <- xi_y.

    x (C, n) int32; row/node tables as in min_gibbs_sweep_ref; i_sites/B1/
    B2/logu (C, S); u_idx/u_alias (C, S, K1); u_node/u_nacc/u_row/u_racc
    (C, S, K2); gumbel (C, S, D); cache (C,).  ``scale1`` = L/lam1,
    ``lscale2`` = log1p(Psi/lam2).
    Returns (x_out (C, n) int32, cache_out (C,) f32, accepts (C,) int32).
    """
    C, n = x.shape
    K1 = u_idx.shape[-1]
    K2 = u_node.shape[-1]
    dev = x.device
    rows = torch.arange(C, device=dev)
    # x-independent draws hoisted: proposal neighbours + second-batch pairs
    idx = torch.clamp((u_idx * n).to(torch.int32), max=n - 1).long()
    ii = i_sites.long()[:, :, None]
    j_all = torch.where(u_alias < row_prob[ii, idx], idx,
                        row_alias[ii, idx].long())           # (C, S, K1)
    live1 = torch.arange(K1, device=dev) < B1[:, :, None]
    a, b = _pair_pick(node_prob, node_alias, row_prob, row_alias,
                      u_node, u_nacc, u_row, u_racc, n)      # (C, S, K2)
    live2 = torch.arange(K2, device=dev) < B2[:, :, None]
    scale1_f = torch.tensor(scale1, dtype=torch.float32, device=dev)
    lscale2_f = torch.tensor(lscale2, dtype=torch.float32, device=dev)
    x = x.clone()
    acc = torch.zeros((C,), dtype=torch.int32, device=dev)
    for s in range(i_sites.shape[1]):
        i = i_sites[:, s].long()
        vals = torch.gather(x, 1, j_all[:, s])               # (C, K1)
        counts = (_onehot(vals, D) * live1[:, s, :, None]).sum(1)
        eps = scale1_f * counts                              # (C, D)
        v = torch.argmax(eps + gumbel[:, s], dim=-1)
        xi = x[rows, i].long()
        a_s, b_s = a[:, s], b[:, s]
        ya = torch.where(a_s == i[:, None], v[:, None],
                         torch.gather(x, 1, a_s).long())
        yb = torch.where(b_s == i[:, None], v[:, None],
                         torch.gather(x, 1, b_s).long())
        m = ((ya == yb) & live2[:, s]).sum(-1).to(torch.float32)
        xi_y = lscale2_f * m
        log_a = (xi_y - cache) + (_at_code(eps, xi) - eps[rows, v])
        accept = logu[:, s] < log_a
        x[rows, i] = torch.where(accept, v, xi).to(x.dtype)
        cache = torch.where(accept, xi_y, cache)
        acc += accept.to(torch.int32)
    return x, cache.clone(), acc


def mgpmh_sweep_rng_ref(x, W, row_prob, row_alias, i_sites, B, seed, D: int,
                        scale: float, K: int, chain0: int = 0):
    """``mgpmh_sweep_ref`` fed by the Philox streams of ``seed`` (streams
    0-3 of ``philox.MGPMH_STREAMS``); K is the capacity.  With ``chain0``,
    the chains are rows chain0 .. chain0 + C - 1 of a larger kernel call."""
    C, S = i_sites.shape
    st = philox.MGPMH_STREAMS
    draw = lambda stream, L: philox.uniforms(seed, stream, C, S, L, x.device,
                                             chain0)
    u_idx, u_alias = draw([st["u_idx"], st["u_alias"]], K)
    g = philox.to_gumbel(draw(st["gumbel"], D))
    logu = philox.to_log_uniform(draw(st["logu"], 1)[..., 0])
    return mgpmh_sweep_ref(x, W, row_prob, row_alias, i_sites, B, u_idx,
                           u_alias, g, logu, D, scale)


def min_gibbs_sweep_rng_ref(x, node_prob, node_alias, row_prob, row_alias,
                            i_sites, B, cache, seed, D: int, lscale: float,
                            K: int, chain0: int = 0):
    """``min_gibbs_sweep_ref`` fed by the Philox streams of ``seed``
    (``philox.MIN_GIBBS_STREAMS``: lane u*K + k of streams 0-3 is draw k of
    candidate u); B (C, S, D) stays an input.  ``chain0`` as in
    ``mgpmh_sweep_rng_ref``."""
    C, S = i_sites.shape
    st = philox.MIN_GIBBS_STREAMS
    draw = lambda stream, L: philox.uniforms(seed, stream, C, S, L, x.device,
                                             chain0)
    u4 = draw([st[k] for k in ("u_node", "u_nacc", "u_row", "u_racc")],
              D * K).reshape(4, C, S, D, K)
    g = philox.to_gumbel(draw(st["gumbel"], D))
    return min_gibbs_sweep_ref(x, node_prob, node_alias, row_prob,
                               row_alias, i_sites, B, *u4, g, cache, D,
                               lscale)


def double_min_sweep_rng_ref(x, row_prob, row_alias, node_prob, node_alias,
                             i_sites, B1, B2, cache, seed, D: int,
                             scale1: float, lscale2: float, K1: int,
                             K2: int, chain0: int = 0):
    """``double_min_sweep_ref`` fed by the Philox streams of ``seed``
    (``philox.DOUBLE_MIN_STREAMS``); B1, B2 stay inputs.  ``chain0`` as in
    ``mgpmh_sweep_rng_ref``."""
    C, S = i_sites.shape
    st = philox.DOUBLE_MIN_STREAMS
    draw = lambda stream, L: philox.uniforms(seed, stream, C, S, L, x.device,
                                             chain0)
    u_idx, u_alias = draw([st["u_idx"], st["u_alias"]], K1)
    g = philox.to_gumbel(draw(st["gumbel"], D))
    v4 = draw([st[k] for k in ("u_node", "u_nacc", "u_row", "u_racc")], K2)
    logu = philox.to_log_uniform(draw(st["logu"], 1)[..., 0])
    return double_min_sweep_ref(x, row_prob, row_alias, node_prob,
                                node_alias, i_sites, B1, u_idx, u_alias, g,
                                B2, *v4, logu, cache, D, scale1, lscale2)


def local_gibbs_subsets(seed, i_sites, B: int, n: int, chain0: int = 0):
    """The subsets of a Local Minibatch Gibbs sweep call: j (C, S, B) int64,
    B distinct sites per (chain, sub-step), none equal to that sub-step's
    site, in draw order.

    Floyd's algorithm over {0 .. n-2}: at step t = 0 .. B-1, with
    r = n-1-B+t, draw k = (bits * (r+1)) >> 32 from lane t of the u_sub
    stream (``philox.LOCAL_GIBBS_STREAMS``; raw 32-bit words) and insert k,
    or r if k is already in the subset; then ``j = k + (k >= i)`` skips the
    site, as the JAX step does.  Every B-subset is equally likely up to the
    multiply-high bias, at most (r+1)/2^32 per draw (3.8e-6 at n = 16384);
    at B = n-1 the subset is every other site.  ``chain0`` as in
    ``mgpmh_sweep_rng_ref``.
    """
    C, S = i_sites.shape
    m = n - 1
    dev = i_sites.device
    bits = philox.words(seed, philox.LOCAL_GIBBS_STREAMS["u_sub"], C, S, B,
                        dev, chain0).reshape(C * S, B)
    rows = torch.arange(C * S, device=dev)
    member = torch.zeros((C * S, m), dtype=torch.bool, device=dev)
    k = torch.empty((C * S, B), dtype=torch.int64, device=dev)
    for t in range(B):
        r = m - B + t
        draw = (bits[:, t] * (r + 1)) >> 32
        pick = torch.where(member[rows, draw], r, draw)
        member[rows, pick] = True
        k[:, t] = pick
    k = k.reshape(C, S, B)
    return k + (k >= i_sites.long()[..., None]).long()


def local_gibbs_sweep_ref(x, W, i_sites, seed, B: int, D: int, scale: float,
                          chain0: int = 0):
    """S sequentially composed Local Minibatch Gibbs updates (Algorithm 3
    per sub-step), every draw from the Philox streams of ``seed``.

    Per sub-step s (all chains c in parallel, sites sequential in s):
      j_t  = t-th site of Floyd's B-subset of the sites other than i
             (``local_gibbs_subsets``)
      eps_u = scale * sum_t W[i, j_t] 1[x[j_t] = u],  summed t = 0 .. B-1
      x_i <- argmax_u eps_u + gumbel_u    (first maximum)

    x (C, n) int32; W (n, n) float32; i_sites (C, S) int32; seed (1,)
    int32; ``scale`` = (n-1)/B.  Returns x_out (C, n) int32.  The subsets
    and the weights they read do not depend on x, so they are drawn and
    gathered for all sub-steps first.  ``chain0`` as in
    ``mgpmh_sweep_rng_ref``.
    """
    C, n = x.shape
    S = i_sites.shape[1]
    dev = x.device
    rows = torch.arange(C, device=dev)
    j = local_gibbs_subsets(seed, i_sites, B, n, chain0)       # (C, S, B)
    w = W[i_sites.long()[..., None], j]                        # (C, S, B)
    g = philox.to_gumbel(philox.uniforms(
        seed, philox.LOCAL_GIBBS_STREAMS["gumbel"], C, S, D, dev, chain0))
    scale_f = torch.tensor(scale, dtype=torch.float32, device=dev)
    x = x.clone()
    for s in range(S):
        onehot = _onehot(torch.gather(x, 1, j[:, s]), D)        # (C, B, D)
        acc = torch.zeros((C, D), dtype=torch.float32, device=dev)
        for t in range(B):
            acc = acc + w[:, s, t, None] * onehot[:, t, :]
        v = torch.argmax(scale_f * acc + g[:, s], dim=-1)
        x[rows, i_sites[:, s].long()] = v.to(x.dtype)
    return x
