"""Philox4x32-10 in plain PyTorch: the random bits of the in-kernel-RNG sweeps.

The ``*_rng`` CUDA kernels (``csrc/philox.cuh``) draw their uniforms from a
counter-based generator instead of reading pre-drawn streams, so the
O(C·S·K) (MIN-Gibbs: O(C·S·D·K)) uniform buffers never exist in device
memory.  This module computes the same bits on any device, so a kernel and
its plain version (``ref.*_sweep_rng_ref``) can be compared exactly.  It is
the port's counterpart of the TPU's ``pltpu.prng_seed`` /
``prng_random_bits`` and ``_uniform_from_bits``
(``src/repro/kernels/fused_sweep.py:84-86``, ``:182-206``); the bits differ
from the TPU's, the conversions do not.

Layout (the kernels reproduce it bit for bit)::

    key  = (seed mod 2^32, stream)      seed: a sweep's (1,) int32 tensor
    ctr  = (lane // 4, s, c, 0)         c = chain row of the call, s = sub-step
    bits = word (lane % 4) of philox4x32_10(ctr, key)
    u    = float32(bits >> 8) * 2^-24   exact, in [0, 1)
    k    = (bits * (r + 1)) >> 32       raw-word streams only: k in [0, r]
    gumbel = -log(-log(u + 1e-20) + 1e-20)
    logu   = log(u + 1e-20)

Stream ids, with L lanes per (c, s) each; K is the unpadded capacity:

    =========  ==========================================================
    kernel     streams
    =========  ==========================================================
    mgpmh      0 u_idx (K), 1 u_alias (K), 2 gumbel (D), 3 logu (1)
    min-gibbs  0 u_node, 1 u_nacc, 2 u_row, 3 u_racc (D·K each,
               lane = u·K + k), 4 gumbel (D)
    doublemin  0 u_idx, 1 u_alias (K1), 2 gumbel (D), 3 u_node, 4 u_nacc,
               5 u_row, 6 u_racc (K2), 7 logu (1)
    local      0 u_sub (B; the raw 32-bit words, not uniforms: lane t
               draws Floyd's k_t in [0, r_t] by multiply-high),
               1 gumbel (D)
    =========  ==========================================================

uint32 arithmetic is carried in int64 tensors; the 32x32 -> 64-bit
products are split into 16-bit halves so no intermediate leaves int64.
"""
from __future__ import annotations

import torch

__all__ = ["philox4x32_10", "words", "uniforms", "to_gumbel",
           "to_log_uniform", "MGPMH_STREAMS", "MIN_GIBBS_STREAMS",
           "DOUBLE_MIN_STREAMS", "LOCAL_GIBBS_STREAMS"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57       # Random123's Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85       # its Weyl key increments
_MASK = 0xFFFFFFFF

# stream ids (see the table above)
MGPMH_STREAMS = dict(u_idx=0, u_alias=1, gumbel=2, logu=3)
MIN_GIBBS_STREAMS = dict(u_node=0, u_nacc=1, u_row=2, u_racc=3, gumbel=4)
DOUBLE_MIN_STREAMS = dict(u_idx=0, u_alias=1, gumbel=2, u_node=3, u_nacc=4,
                          u_row=5, u_racc=6, logu=7)
LOCAL_GIBBS_STREAMS = dict(u_sub=0, gumbel=1)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x, x < 2^32 int64."""
    a = m * (x & 0xFFFF)                 # < 2^48
    b = m * (x >> 16)                    # < 2^48
    t = a + ((b & 0xFFFF) << 16)         # < 2^49
    return (t >> 32) + (b >> 16), t & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's reference rounds).

    ``ctr``: four int64 tensors (or ints) holding uint32 words, broadcast
    together; ``key``: two such words.  Returns the four output words as
    int64 tensors in [0, 2^32).
    """
    c0, c1, c2, c3 = (torch.as_tensor(w, dtype=torch.int64) for w in ctr)
    k0, k1 = (torch.as_tensor(w, dtype=torch.int64) for w in key)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(seed, stream, C: int, S: int, L: int, device=None,
          chain0: int = 0) -> torch.Tensor:
    """The (C, S, L) raw 32-bit words of one stream, as int64 in
    [0, 2^32): lane l of sub-step s of chain row c is word l % 4 of the
    Philox block at counter (l // 4, s, c, 0) under key
    (seed mod 2^32, stream).  ``chain0`` offsets the chain rows, so rows
    chain0 .. chain0 + C - 1 of a larger call can be drawn alone.

    ``seed`` is the (1,) int32 tensor a sweep takes, or an int.  ``stream``
    is an int, or a sequence of ints for several streams of the same width
    at once (then the result is (len(stream), C, S, L)).  Computed on
    ``device`` (default: the seed tensor's) without a host round trip.
    """
    seed = torch.as_tensor(seed)
    dev = seed.device if device is None else torch.device(device)
    k0 = seed.to(dev, torch.int64).reshape(()) & _MASK
    many = not isinstance(stream, int)
    k1 = torch.as_tensor(stream if many else [stream], dtype=torch.int64,
                         device=dev)[:, None, None, None]
    blocks = -(-L // 4)
    ar = lambda m: torch.arange(m, dtype=torch.int64, device=dev)
    out = philox4x32_10(
        (ar(blocks)[None, None, None, :], ar(S)[None, None, :, None],
         (chain0 + ar(C))[None, :, None, None], 0), (k0, k1))
    bits = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    bits = bits.reshape(k1.shape[0], C, S, 4 * blocks)[..., :L]
    return bits if many else bits[0]


def uniforms(seed, stream, C: int, S: int, L: int, device=None,
             chain0: int = 0) -> torch.Tensor:
    """The (C, S, L) float32 uniforms of one stream, as the kernels draw
    them: ``float32(bits >> 8) * 2^-24`` of :func:`words` (same arguments),
    exact, in [0, 1)."""
    bits = words(seed, stream, C, S, L, device, chain0)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def to_gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms, as the kernels compute it
    (``fused_sweep.py:195``)."""
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def to_log_uniform(u: torch.Tensor) -> torch.Tensor:
    """log-uniform MH thresholds from uniforms (``fused_sweep.py:205``)."""
    return torch.log(u + 1e-20)
