"""Minibatch energy estimators (paper Section 2, eq. 2 and Lemma 2).

The paper's dynamically-sized Poisson minibatch is realized with its own
footnote-7 decomposition: ``B ~ Poisson(Lambda)`` total draws, then ``B``
categorical draws (an O(1) alias-table lookup each).  A fixed-shape sweep
draws a static ``capacity`` of ids and masks draws ``k >= B``; the clamp
probability ``P(B > capacity)`` is computed in closed form
(`capacity_overflow_prob`) and chosen < 1e-8 by `recommended_capacity`.

On a weighted-match graph every per-draw contribution is a constant times
a match indicator: ``L/lam`` for MGPMH, so its minibatch energy is a bucket
count (``kernels/ref.py``), and ``log1p(Psi/lam)`` for the MIN-Gibbs
estimator of eq. (2) (``min_gibbs_estimate``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .factor_graph import MatchGraph, alias_draw

__all__ = [
    "lemma2_lambda",
    "recommended_capacity",
    "capacity_overflow_prob",
    "draw_global_minibatch",
    "min_gibbs_lscale",
    "min_gibbs_estimate",
    "draw_local_minibatch",
]


def lemma2_lambda(psi: float, delta_tol: float, fail_prob: float) -> float:
    """Lemma 2 batch-size recipe: the expected batch size lambda such that
    ``P(|eps_x - zeta(x)| >= delta_tol) <= fail_prob``."""
    return max(8.0 * psi**2 / delta_tol**2 * math.log(2.0 / fail_prob),
               2.0 * psi**2 / delta_tol)


def recommended_capacity(lam: float, tail: float = 1e-8) -> int:
    """Static draw-buffer size K with ``P(Poisson(lam) > K) < tail``.

    Starts from the normal tail K = lam + c*sqrt(lam) + c^2, c = 6, then
    verifies/chooses with the exact CDF.
    """
    k = int(math.ceil(lam + 6.0 * math.sqrt(max(lam, 1.0)) + 36.0))
    while float(capacity_overflow_prob(lam, k)) >= tail:
        k = int(math.ceil(k * 1.25)) + 8
    return k


def capacity_overflow_prob(lam: float, capacity: int) -> torch.Tensor:
    """Exact P(Poisson(lam) > capacity) = P(Gamma(capacity+1) < lam), in
    float32 (the precision the JAX package computes it in, so both choose
    the same capacity)."""
    return torch.special.gammainc(
        torch.tensor(float(capacity + 1), dtype=torch.float32),
        torch.tensor(float(lam), dtype=torch.float32))


# ---------------------------------------------------------------------------
# Global minibatch (MIN-Gibbs / DoubleMIN second batch)
# ---------------------------------------------------------------------------

def draw_global_minibatch(gen: torch.Generator, graph: MatchGraph,
                          lam: float, capacity: int,
                          shape: Tuple[int, ...] = ()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``shape + (capacity,)`` factor ids from p_phi = M_phi/Psi (the
    flat factor alias table) plus the Poisson totals ``B`` of shape
    ``shape``, clamped to ``capacity`` (draws k >= B are to be masked).

    Draws from ``gen`` in this order: the totals, then the alias index
    integers, then the alias accept uniforms.  Returns (idx int32, B int32).
    """
    rate = torch.full(tuple(shape), float(lam), device=graph.device)
    B = torch.poisson(rate, generator=gen).clamp_(max=capacity)
    idx = alias_draw(gen, graph.pair_prob, graph.pair_alias,
                     tuple(shape) + (capacity,))
    return idx, B.to(torch.int32)


def min_gibbs_lscale(psi: float, lam: float) -> float:
    """Per-match weight ``log1p(Psi/lam)`` of the eq.-(2) estimator, in
    float64 (the kernels and plain versions round it to float32 once)."""
    return math.log1p(psi / lam)


def min_gibbs_estimate(graph: MatchGraph, x: torch.Tensor, idx: torch.Tensor,
                       B: torch.Tensor, lam: float) -> torch.Tensor:
    """Bias-adjusted estimator of eq. (2) for match graphs.

    eps_x = sum_{phi in S} s_phi log(1 + Psi/(lam M_phi) phi(x))
          = log1p(Psi/lam) * #{draws k < B : x[a_k] == x[b_k]}.

    ``x`` (..., n) int32, ``idx`` (..., K) factor ids, ``B`` (...) counts,
    batched over leading dims (one estimate per chain).  Satisfies
    E[exp(eps_x)] = exp(zeta(x)) exactly (Lemma 1).  Returns (...) float32.
    """
    idx = idx.long()
    a = graph.pair_a[idx].long()
    b = graph.pair_b[idx].long()
    live = torch.arange(idx.shape[-1], device=idx.device) < B[..., None]
    match = torch.gather(x, -1, a) == torch.gather(x, -1, b)
    matches = (match & live).sum(-1).to(torch.float32)
    lscale = torch.tensor(min_gibbs_lscale(graph.psi, lam),
                          dtype=torch.float32, device=matches.device)
    return lscale * matches


# ---------------------------------------------------------------------------
# Local minibatch over A[i] (MGPMH / DoubleMIN first batch)
# ---------------------------------------------------------------------------

def draw_local_minibatch(gen: torch.Generator, graph: MatchGraph, i,
                         lam: float, capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the MGPMH minibatch over A[i]: ``s_phi ~ Poisson(lam M_phi / L)``
    for the factors {i,j}, realized as ``B ~ Poisson(lam * L_i / L)`` total
    draws of neighbor ids j ~ W_ij / L_i (row i's alias table, read as
    packed records, ``MatchGraph.row_pack``).

    ``i`` is one site, or a tensor of sites (one per chain) whose shape
    leads the outputs.  Draws from ``gen`` the totals, then the alias index
    integers, then the alias accept uniforms.  Returns (j_ids
    ``i.shape + (capacity,)`` int32, B ``i.shape`` int32 clamped to
    capacity)."""
    i = torch.as_tensor(i, device=graph.device).long()
    lam_i = (lam / graph.L) * graph.row_sum[i]
    B = torch.poisson(lam_i.reshape(-1), generator=gen).reshape(i.shape)
    shape = tuple(i.shape) + (capacity,)
    idx = torch.randint(0, graph.n, shape, generator=gen, device=graph.device)
    u = torch.rand(shape, generator=gen, device=graph.device)
    rec = graph.row_pack[i[..., None], idx]    # one record per draw
    j = torch.where(u >= rec[..., 0].view(torch.float32), rec[..., 1].long(),
                    idx)
    return j.to(torch.int32), B.clamp(max=capacity).to(torch.int32)
