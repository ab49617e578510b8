"""Exact transition-matrix validators for the paper's theorems.

For tiny graphs (enumerable state spaces) we build the *exact* transition
matrices of vanilla Gibbs, MGPMH, MIN-Gibbs and DoubleMIN-Gibbs — the latter
two on their augmented state spaces Omega x R — using truncated-Poisson
minibatch distributions (truncation mass < 1e-9 for the caps used in tests;
reversibility statements hold for ANY s-distribution because the paper's
proofs are pointwise in s, so the truncated chains are still exactly
reversible).

This lets the test-suite check, to float precision:
  * Thm 1: MIN-Gibbs stationary  pi(x, e) ~ mu_x(e) exp(e); marginal ~ E[exp e].
  * Lemma 1: E[exp eps_x] = exp(zeta(x)) for the bias-adjusted estimator.
  * Thm 2: gap(MIN-Gibbs) >= exp(-6 delta) gap(Gibbs).
  * Thm 3: MGPMH reversible with stationary pi.
  * Thm 4: gap(MGPMH) >= exp(-L^2/lambda) gap(Gibbs).
  * Thm 5: DoubleMIN stationary == MIN-Gibbs stationary form.
  * Thm 6: gap(DoubleMIN) >= exp(-4 delta) gap(MGPMH).

Everything here is plain numpy — exactness over speed.  A copy of the
JAX package's ``core/spectral.py`` on the port's
:class:`~repro_torch.core.factor_graph.TabularPairwiseGraph`, so the port
reads no module of that package.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Tuple

import numpy as np

from .factor_graph import TabularPairwiseGraph

__all__ = [
    "truncated_poisson_pmf",
    "spectral_gap",
    "reversibility_error",
    "gibbs_transition_matrix",
    "mgpmh_transition_matrix",
    "min_gibbs_augmented_chain",
    "double_min_augmented_chain",
    "enumerate_global_estimator",
]


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------

def truncated_poisson_pmf(mu: float, cap: int) -> np.ndarray:
    """Poisson(mu) pmf on {0..cap}, renormalized.  For the caps used in the
    tests the discarded tail is < 1e-9."""
    ks = np.arange(cap + 1)
    logp = -mu + ks * np.log(max(mu, 1e-300)) - np.array(
        [math.lgamma(k + 1) for k in ks])
    p = np.exp(logp - logp.max())
    return p / p.sum()


def spectral_gap(T: np.ndarray, pi: np.ndarray) -> float:
    """gamma = 1 - lambda_2 of a reversible chain, via the symmetrized
    matrix D^{1/2} T D^{-1/2}."""
    d = np.sqrt(pi)
    S = (d[:, None] * T) / d[None, :]
    ev = np.linalg.eigvalsh((S + S.T) / 2.0)
    return float(ev[-1] - ev[-2])


def reversibility_error(T: np.ndarray, pi: np.ndarray) -> float:
    """max |pi(x)T(x,y) - pi(y)T(y,x)| — zero iff detailed balance holds."""
    F = pi[:, None] * T
    return float(np.abs(F - F.T).max())


def _poisson_combos(mus: np.ndarray, cap: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Enumerate s-vectors over ``len(mus)`` independent truncated Poissons.
    Returns (combos (S, F) int, pmf (S,))."""
    F = len(mus)
    grids = list(itertools.product(range(cap + 1), repeat=F))
    combos = np.array(grids, dtype=np.int64).reshape(-1, F)
    pmf = np.ones(combos.shape[0])
    for f in range(F):
        pmf *= truncated_poisson_pmf(float(mus[f]), cap)[combos[:, f]]
    return combos, pmf


# ---------------------------------------------------------------------------
# Algorithm 1 — vanilla Gibbs exact T
# ---------------------------------------------------------------------------

def gibbs_transition_matrix(g: TabularPairwiseGraph) -> Tuple[np.ndarray,
                                                              np.ndarray,
                                                              np.ndarray]:
    """Returns (T, pi, states)."""
    states = g.all_states()
    S = len(states)
    index = {tuple(s): k for k, s in enumerate(states)}
    pi = g.pi()
    T = np.zeros((S, S))
    for k, x in enumerate(states):
        for i in range(g.n):
            eps = np.array([g.energy(_assign(x, i, u)) for u in range(g.D)])
            rho = _softmax(eps)
            for u in range(g.D):
                T[k, index[tuple(_assign(x, i, u))]] += rho[u] / g.n
    return T, pi, states


def _assign(x: np.ndarray, i: int, u: int) -> np.ndarray:
    y = x.copy()
    y[i] = u
    return y


def _softmax(e: np.ndarray) -> np.ndarray:
    w = np.exp(e - e.max())
    return w / w.sum()


# ---------------------------------------------------------------------------
# Algorithm 4 — MGPMH exact T
# ---------------------------------------------------------------------------

def mgpmh_transition_matrix(g: TabularPairwiseGraph, lam: float,
                            cap: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Exact MGPMH transition matrix with truncated-Poisson minibatch
    coefficients s_phi ~ Poisson(lam * M_phi / L) on {0..cap}."""
    states = g.all_states()
    S = len(states)
    index = {tuple(s): k for k, s in enumerate(states)}
    L = g.L
    M = g.M
    T = np.zeros((S, S))
    for k, x in enumerate(states):
        for i in range(g.n):
            adj = g.adjacent(i)                       # factor ids in A[i]
            combos, pmf = _poisson_combos(lam * M[adj] / L, cap)
            # phi_f(x_{i<-u}) table: (|adj|, D)
            phi_u = np.zeros((len(adj), g.D))
            for fi, f in enumerate(adj):
                for u in range(g.D):
                    phi_u[fi, u] = g.factor_values(_assign(x, i, u))[f]
            # eps[s, u] = sum_f s_f * L/(lam*M_f) * phi_f(x_u)
            R = (L / (lam * M[adj]))[:, None] * phi_u          # (F_i, D)
            eps = combos @ R                                    # (S_c, D)
            psi = np.exp(eps - eps.max(axis=1, keepdims=True))
            psi /= psi.sum(axis=1, keepdims=True)
            loc = phi_u.sum(0)                                  # sum_{A[i]} phi(x_u)
            xi = int(x[i])
            for u in range(g.D):
                # a = exp(loc[u]-loc[xi]) * exp(eps_xi - eps_u)
                a = np.exp(np.minimum(loc[u] - loc[xi]
                                      + eps[:, xi] - eps[:, u], 0.0))
                p = float(np.sum(pmf * psi[:, u] * a)) / g.n
                T[k, index[tuple(_assign(x, i, u))]] += p
        T[k, k] += 1.0 - T[k].sum()
    return T, g.pi()


# ---------------------------------------------------------------------------
# MIN-Gibbs estimator support + augmented chain (Algorithm 2, D = 2)
# ---------------------------------------------------------------------------

def enumerate_global_estimator(g: TabularPairwiseGraph, lam: float,
                               cap: int = 8):
    """Enumerate the eq.-(2) estimator mu_x over ALL factors with truncated
    Poisson s_phi ~ Poisson(lam*M_phi/Psi).

    Returns (supports, probs): two lists over states (in all_states order),
    supports[k] = distinct eps values (V_k,), probs[k] = their pmf.
    Also returns the raw (combos, pmf, per-state weight matrix) for reuse.
    """
    M = g.M
    psi = g.psi
    combos, pmf = _poisson_combos(lam * M / psi, cap)
    states = g.all_states()
    supports: List[np.ndarray] = []
    probs: List[np.ndarray] = []
    for x in states:
        phi = g.factor_values(x)
        w = np.log1p(psi * phi / (lam * M))        # per-factor weight
        eps = combos @ w                           # (S_c,)
        vals, inv = np.unique(np.round(eps, 9), return_inverse=True)
        p = np.zeros(len(vals))
        np.add.at(p, inv, pmf)
        supports.append(vals)
        probs.append(p)
    return supports, probs


def min_gibbs_augmented_chain(g: TabularPairwiseGraph, lam: float,
                              cap: int = 8):
    """Exact augmented chain of Algorithm 2 for D = 2 models.

    Returns (T, bar_pi, labels) where labels[j] = (state_index, eps_value)
    and bar_pi is the *claimed* stationary distribution of Theorem 1,
    bar_pi(x, e) ~ mu_x(e) exp(e).  Tests assert bar_pi T = bar_pi and
    detailed balance.
    """
    if g.D != 2:
        raise ValueError("exact MIN-Gibbs validation uses D = 2")
    states = g.all_states()
    sindex = {tuple(s): k for k, s in enumerate(states)}
    supports, probs = enumerate_global_estimator(g, lam, cap)

    labels: List[Tuple[int, float]] = []
    offset = []         # start index of each state's block
    for k, vals in enumerate(supports):
        offset.append(len(labels))
        labels += [(k, float(v)) for v in vals]
    A = len(labels)

    bar_pi = np.array([probs[k][j - offset[k]] * math.exp(labels[j][1])
                       for j, (k, _) in enumerate(labels)
                       for k in [labels[j][0]]])
    bar_pi /= bar_pi.sum()

    T = np.zeros((A, A))
    for j, (k, e) in enumerate(labels):
        x = states[k]
        for i in range(g.n):
            u = 1 - int(x[i])                  # the single alternative (D=2)
            y = _assign(x, i, u)
            ky = sindex[tuple(y)]
            vals_y, p_y = supports[ky], probs[ky]
            # rho(new) = exp(e_u)/(exp(e)+exp(e_u)) pairwise softmax
            m = np.maximum(vals_y, e)
            rho_new = np.exp(vals_y - m) / (np.exp(vals_y - m)
                                            + np.exp(e - m))
            T[j, offset[ky]:offset[ky] + len(vals_y)] += (
                p_y * rho_new / g.n)
            # staying keeps the cached energy unchanged
            T[j, j] += float(np.sum(p_y * (1.0 - rho_new))) / g.n
    return T, bar_pi, labels


# ---------------------------------------------------------------------------
# DoubleMIN-Gibbs augmented chain (Algorithm 5, any D)
# ---------------------------------------------------------------------------

def double_min_augmented_chain(g: TabularPairwiseGraph, lam1: float,
                               cap1: int, lam2: float, cap2: int):
    """Exact augmented chain of Algorithm 5.

    First minibatch: s_phi ~ Poisson(lam1 M_phi / L) over A[i] (MGPMH
    proposal).  Second: the global eq.-(2) estimator with lam2 (cached xi).
    Returns (T, bar_pi, labels) — bar_pi is Theorem 5's claimed stationary
    distribution, identical in form to MIN-Gibbs's.
    """
    states = g.all_states()
    sindex = {tuple(s): k for k, s in enumerate(states)}
    supports, probs = enumerate_global_estimator(g, lam2, cap2)

    labels: List[Tuple[int, float]] = []
    offset = []
    for k, vals in enumerate(supports):
        offset.append(len(labels))
        labels += [(k, float(v)) for v in vals]
    A = len(labels)

    bar_pi = np.array([probs[labels[j][0]][j - offset[labels[j][0]]]
                       * math.exp(labels[j][1]) for j in range(A)])
    bar_pi /= bar_pi.sum()

    L, M = g.L, g.M
    T = np.zeros((A, A))
    for j, (k, xi) in enumerate(labels):
        x = states[k]
        for i in range(g.n):
            adj = g.adjacent(i)
            combos, pmf = _poisson_combos(lam1 * M[adj] / L, cap1)
            phi_u = np.zeros((len(adj), g.D))
            for fi, f in enumerate(adj):
                for u in range(g.D):
                    phi_u[fi, u] = g.factor_values(_assign(x, i, u))[f]
            R = (L / (lam1 * M[adj]))[:, None] * phi_u
            eps = combos @ R                                  # (S_c, D)
            psi = np.exp(eps - eps.max(axis=1, keepdims=True))
            psi /= psi.sum(axis=1, keepdims=True)
            xiv = int(x[i])
            for u in range(g.D):
                y = _assign(x, i, u)
                ky = sindex[tuple(y)]
                vals_y, p_y = supports[ky], probs[ky]
                # acc[s, xi'] = min(exp(xi' - xi + eps_xi - eps_u), 1)
                log_a = (vals_y[None, :] - xi
                         + (eps[:, xiv] - eps[:, u])[:, None])
                acc = np.exp(np.minimum(log_a, 0.0))
                w = (pmf * psi[:, u]) @ acc                   # (V_y,)
                T[j, offset[ky]:offset[ky] + len(vals_y)] += (
                    p_y * w / g.n)
        T[j, j] += 1.0 - T[j].sum()
    return T, bar_pi, labels
