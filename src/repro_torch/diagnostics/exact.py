"""Exact references for convergence diagnostics on small graphs.

Where the state space is enumerable this module grounds sampler output in
exact quantities: the true per-site marginals (whole-graph, or conditioned
on evidence per connected component), the total-variation distance of
estimated marginals to them, and the exact spectral gap of random-scan
Gibbs via the transition-matrix validators of ``core/spectral.py``.

Host-side numpy (exactness over speed), on the port's graphs; a copy of the
JAX package's ``diagnostics/exact.py``, with its telemetry-based
:func:`empirical_spectral_gap` reading the port's carry.
"""
from __future__ import annotations

import numpy as np

from ..core.factor_graph import MatchGraph, TabularPairwiseGraph
from ..core import spectral
from .telemetry import Telemetry, _lag1_stats

__all__ = ["exact_marginals", "exact_conditional_marginals", "tv_to_exact",
           "exact_gibbs_gap", "empirical_spectral_gap"]


def exact_marginals(graph: MatchGraph, max_states: int = 1 << 22
                    ) -> np.ndarray:
    """Per-site marginals of the exact stationary distribution ((n, D)).

    Enumerates the D^n state space through
    :class:`~repro_torch.core.factor_graph.TabularPairwiseGraph`; refuses
    graphs beyond ``max_states`` states.
    """
    n_states = float(graph.D) ** graph.n
    if n_states > max_states:
        raise ValueError(
            f"state space D^n = {graph.D}^{graph.n} exceeds {max_states}; "
            f"exact marginals need an enumerable graph")
    tg = TabularPairwiseGraph.from_match_graph(graph)
    states = tg.all_states()
    pi = tg.pi()
    marg = np.zeros((graph.n, graph.D))
    for i in range(graph.n):
        marg[i] = np.bincount(states[:, i], weights=pi, minlength=graph.D)
    return marg


def _components(W: np.ndarray) -> list:
    """Connected components of the factor graph (DFS over ``W != 0``);
    returns a list of sorted site-index arrays."""
    n = W.shape[0]
    adj = W != 0.0
    seen = np.zeros(n, bool)
    comps = []
    for s in range(n):
        if seen[s]:
            continue
        stack, comp = [s], []
        seen[s] = True
        while stack:
            v = stack.pop()
            comp.append(v)
            for u in np.where(adj[v] & ~seen)[0]:
                seen[u] = True
                stack.append(u)
        comps.append(np.sort(np.asarray(comp)))
    return comps


def exact_conditional_marginals(graph: MatchGraph, ev_sites, ev_vals, *,
                                max_states: int = 1 << 22) -> np.ndarray:
    """Per-site marginals of ``pi(x | x[ev_sites] = ev_vals)`` ((n, D)).

    The evidence-clamped exact reference the serving layer's clamped
    answers are tested against.  Enumeration is per connected component of
    ``W`` — conditioning factorizes over components, so the bound is
    ``D^(free sites in the largest component)``, not ``D^n``; the strong/
    weak pair workloads (2^24 states whole-graph) are exact in microseconds.
    With empty evidence this equals :func:`exact_marginals` where that is
    feasible.  Observed sites get exact delta rows.  Host-side numpy.
    """
    W = graph.W.cpu().numpy().astype(np.float64)
    n, D = graph.n, graph.D
    ev_sites = np.asarray(ev_sites, np.int64).reshape(-1)
    ev_vals = np.asarray(ev_vals, np.int64).reshape(-1)
    if ev_sites.shape != ev_vals.shape:
        raise ValueError(f"ev_sites/ev_vals length mismatch: "
                         f"{ev_sites.shape} vs {ev_vals.shape}")
    if len(np.unique(ev_sites)) != len(ev_sites):
        raise ValueError("duplicate evidence sites")
    if ev_sites.size and (ev_sites.min() < 0 or ev_sites.max() >= n):
        raise ValueError(f"evidence sites out of range [0, {n})")
    if ev_vals.size and (ev_vals.min() < 0 or ev_vals.max() >= D):
        raise ValueError(f"evidence values out of range [0, {D})")
    obs = dict(zip(ev_sites.tolist(), ev_vals.tolist()))
    marg = np.zeros((n, D))
    for comp in _components(W):
        free = [v for v in comp.tolist() if v not in obs]
        k = len(free)
        if float(D) ** k > max_states:
            raise ValueError(
                f"component with {len(comp)} sites has {k} free sites: "
                f"{D}^{k} conditional states exceed {max_states}; observe "
                f"more sites or use a sampled estimate")
        if k:
            grids = np.meshgrid(*([np.arange(D)] * k), indexing="ij")
            Xf = np.stack([g.ravel() for g in grids], axis=-1)
        else:
            Xf = np.zeros((1, 0), np.int64)
        m = len(comp)
        X = np.zeros((Xf.shape[0], m), np.int64)
        pos = {v: j for j, v in enumerate(comp.tolist())}
        for j, v in enumerate(free):
            X[:, pos[v]] = Xf[:, j]
        for v, val in obs.items():
            if v in pos:
                X[:, pos[v]] = val
        e = np.zeros(X.shape[0])
        for a in range(m):
            for b in range(a + 1, m):
                w = W[comp[a], comp[b]]
                if w != 0.0:
                    e += w * (X[:, a] == X[:, b])
        p = np.exp(e - e.max())
        p /= p.sum()
        for j, v in enumerate(comp.tolist()):
            marg[v] = np.bincount(X[:, j], weights=p, minlength=D)
    return marg


def tv_to_exact(marginals: np.ndarray, exact: np.ndarray) -> np.ndarray:
    """Per-site total-variation distance ``0.5 * sum_d |p - p*|``.

    ``marginals``: (..., n, D) estimated marginals (normalized; e.g.
    ``trace.marg / trace.iters[-1] * updates_per_call`` — or the per-call
    count the runner used); returns (..., n).
    """
    marginals = np.asarray(marginals, np.float64)
    exact = np.asarray(exact, np.float64)
    return 0.5 * np.abs(marginals - exact).sum(axis=-1)


def exact_gibbs_gap(graph: MatchGraph) -> float:
    """Exact spectral gap of single-site random-scan Gibbs on ``graph``
    (reuses the transition-matrix validator in ``core/spectral.py``)."""
    tg = TabularPairwiseGraph.from_match_graph(graph)
    T, pi, _ = spectral.gibbs_transition_matrix(tg)
    return spectral.spectral_gap(T, pi)


def empirical_spectral_gap(tel: Telemetry) -> float:
    """Spectral-gap estimate (per site update) from streaming telemetry.

    The slowest site's lag-1 *snapshot* autocorrelation rho satisfies
    rho ~ (1 - gamma)^u for a chain with gap gamma and u site updates per
    snapshot, so gamma ~ 1 - rho^(1/u).  A crude slowest-mode estimate —
    compare against :func:`exact_gibbs_gap` on enumerable graphs; expect
    order-of-magnitude agreement, not digits.  Returns NaN with too little
    data.  One host read of the carry.
    """
    stats = _lag1_stats(tel)
    if stats is None:
        return float("nan")
    cnt, cn, var, cov1 = stats
    if cnt <= 2.0 or cn <= 1.0:
        return float("nan")
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.where(var > 0.0, cov1 / np.maximum(var, 1e-300), np.nan)
    rho = rho[np.isfinite(rho)]
    if rho.size == 0:
        return float("nan")
    rho_max = float(np.clip(rho.max(), 1e-6, 1.0 - 1e-6))
    # site updates per snapshot, per chain
    u = float(tel.updates.cpu()) / cnt
    return 1.0 - rho_max ** (1.0 / u)
