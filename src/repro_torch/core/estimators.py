"""Minibatch energy estimators (paper Section 2, eq. 2 and Lemma 2).

The paper's dynamically-sized Poisson minibatch is realized with its own
footnote-7 decomposition: ``B ~ Poisson(Lambda)`` total draws, then ``B``
categorical draws (an O(1) alias-table lookup each).  A fixed-shape sweep
draws a static ``capacity`` of ids and masks draws ``k >= B``; the clamp
probability ``P(B > capacity)`` is computed in closed form
(`capacity_overflow_prob`) and chosen < 1e-8 by `recommended_capacity`.

For MGPMH on a weighted-match graph every per-draw contribution is the
constant ``L/lam`` times a match indicator, so the minibatch energy is a
bucket count (``kernels/ref.py``).
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


def draw_local_minibatch(gen: torch.Generator, graph: MatchGraph, i: int,
                         lam: float, capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the MGPMH minibatch over A[i]: ``s_phi ~ Poisson(lam M_phi / L)``
    for the factors {i,j}, realized as ``B ~ Poisson(lam * L_i / L)`` total
    draws of neighbor ids j ~ W_ij / L_i (per-row alias table).

    Returns (j_ids (capacity,) int32, B scalar int32 clamped to capacity)."""
    lam_i = (lam / graph.L) * graph.row_sum[i]
    B = torch.poisson(lam_i.reshape(1), generator=gen)[0]
    j = alias_draw(gen, graph.row_prob[i], graph.row_alias[i], (capacity,))
    return j, B.clamp(max=capacity).to(torch.int32)
