"""The paper's five sampling algorithms on a batched :class:`ChainState`
(x of shape (C, n)): single-site reference steps and the fused multi-site
sweeps the Engine API assembles.

  * ``make_*_step(graph, ...)`` — ``step(state) -> state`` advances every
    chain by one update at an i.i.d.-uniform site: vanilla Gibbs
    (Algorithm 1), MIN-Gibbs (2), Local Minibatch Gibbs (3), MGPMH (4) and
    DoubleMIN (5).  They are the distributional ground truth the sweeps are
    held to, and ``_build_step_sweep`` makes a sweep of S of them (the
    unfused sweep the fused ones are compared with).  Their energies go
    through ``kernels.ops.bucket_energy`` (the exact pass and the local
    minibatches); MIN-Gibbs and DoubleMIN count matches with
    ``min_gibbs_estimate``.
  * ``_build_*_sweep(...)`` — ``sweep(state) -> state``: ``sweep_len``
    sequentially composed site updates per call, all randomness (sites,
    Poisson totals, alias-table uniforms, Gumbel noise, MH uniforms) drawn
    up front in one batched pass on the state's device, and the
    x-dependent pipeline run as one ``kernels.ops`` call — one kernel launch
    on the card.  Each sub-step is exactly one iteration of the single-site
    chain at an i.i.d.-uniform site.  Gibbs also runs on the chromatic
    schedule.  Local Minibatch Gibbs draws only its sites and a Philox
    seed up front; its subsets and Gumbels are drawn in the call (in-kernel
    on the card).

The four fused builders of Gibbs, MGPMH, MIN-Gibbs and DoubleMIN take the
JAX package's three extensions of the ``sweep(state) -> state`` contract:

  * ``collect_stats=True`` (build time): the sweep also returns a
    :class:`~repro_torch.diagnostics.telemetry.SiteDraws`, its per-site
    proposal/acceptance counters left to the telemetry update to count
    (the sites it updated; acceptances: Gibbs and MIN-Gibbs the hits,
    MGPMH and DoubleMIN, whose kernels keep acceptance inside, the
    accepted moves, a lower bound), the instrumented variant
    ``Engine.sweep`` uses when it threads telemetry;
  * ``sites=`` (call time): a (C, sweep_len) int32 site array in place of
    the uniform draw, which is then skipped — the hook AdaptiveScan drives;
  * ``evidence=`` (call time): an ``(ev_mask (n,) float32, ev_vals (n,)
    int32)`` pair of data tensors; the sites are drawn uniformly over the
    unobserved sites through the masked inverse-CDF (:func:`evidence_cdf`),
    so observed sites are never resampled.  The caller must have clamped
    ``state.x`` at the observed sites (``Engine.clamp``); the chromatic
    sweep re-clamps x after every color class instead.

With one sequential generator, skipping the site draw (``sites=``) or
replacing it (``evidence=``: one uniform per site) shifts the draws after
it: the JAX package keeps its default streams by splitting keys, so the
two agree in distribution, not in bits.

RNG contract: every state carries ONE ``torch.Generator`` on its device
(``state.gen``), and a step or sweep draws everything it needs from it, in
a fixed order, advancing it in place.  The state it returns shares that
generator, so re-running from an older state does not repeat its draws;
seed a fresh generator to replay.  The streams differ from the JAX
package's (threefry) streams, so the two agree in distribution, not in bits.

MIN-Gibbs and DoubleMIN carry an augmented state, the cached energy
estimate ``state.cache`` (eps of the current value for MIN-Gibbs, xi_x for
DoubleMIN), threaded through the kernel's sub-steps.  It is seeded with one
estimator draw per chain (``init_min_gibbs_cache`` /
``init_double_min_cache``, run by ``Engine.init``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .estimators import (draw_global_minibatch, draw_local_minibatch,
                         min_gibbs_estimate, min_gibbs_lscale)
from .factor_graph import MatchGraph, build_alias_table, pack_alias
from ..diagnostics.telemetry import SiteDraws, SweepStats
from ..kernels import ops as kernel_ops
from ..kernels.ref import gumbel_from_uniform

__all__ = [
    "ChainState",
    "init_state",
    "make_gibbs_step",
    "make_min_gibbs_step",
    "make_local_gibbs_step",
    "make_mgpmh_step",
    "make_double_min_step",
    "local_gibbs_draws",
    "gibbs_select",
    "mh_accept",
    "min_gibbs_select",
    "at_code",
    "gumbel",
    "gumbel_from_uniform",
    "gibbs_draws",
    "mgpmh_rate",
    "mgpmh_draws",
    "min_gibbs_draws",
    "double_min_draws",
    "init_min_gibbs_cache",
    "init_double_min_cache",
    "evidence_cdf",
    "inverse_cdf_sites",
    "validate_coloring",
]

class ChainState(NamedTuple):
    """Batched chain state.

    ``cache`` is the cached energy estimate of the MIN-Gibbs-type samplers;
    unused (0) by Gibbs and MGPMH.  ``accepts`` counts MH acceptances per
    chain (MGPMH, DoubleMIN).
    """
    x: torch.Tensor        # (C, n) int32
    cache: torch.Tensor    # (C,) float32
    gen: torch.Generator   # on x's device
    accepts: torch.Tensor  # (C,) int32


def init_state(gen: torch.Generator, graph: MatchGraph, n_chains: int, *,
               start: str = "constant") -> ChainState:
    """Paper: "unmixed configuration where each site takes on the same
    state" (``constant``), or i.i.d. uniform values (``random``)."""
    dev = graph.device
    shape = (n_chains, graph.n)
    if start == "constant":
        x = torch.zeros(shape, dtype=torch.int32, device=dev)
    elif start == "random":
        x = torch.randint(0, graph.D, shape, generator=gen, device=dev,
                          dtype=torch.int32)
    else:
        raise ValueError(start)
    return ChainState(x=x,
                      cache=torch.zeros((n_chains,), device=dev),
                      gen=gen,
                      accepts=torch.zeros((n_chains,), dtype=torch.int32,
                                          device=dev))


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)`` from ``gen``: a ``torch.rand``
    draw through :func:`gumbel_from_uniform`, in place in the one buffer
    the draw returns."""
    return gumbel_from_uniform(torch.rand(shape, generator=gen,
                                          device=device))


def gibbs_select(eps: torch.Tensor, gumbel_noise: torch.Tensor) -> torch.Tensor:
    """Categorical draw over (C, D) energies via Gumbel-argmax
    (``categorical(exp eps)`` == ``argmax(eps + gumbel)``, first maximum)."""
    return torch.argmax(eps + gumbel_noise, dim=-1).to(torch.int32)


def mh_accept(logu, exact_diff, eps_xi, eps_v) -> torch.Tensor:
    """The MGPMH acceptance rule:
    ``log a = (exact(y) - exact(x)) + (eps_x - eps_v)``; accept iff
    ``logu < log a``."""
    return logu < exact_diff + (eps_xi - eps_v)


def min_gibbs_select(eps, cache, xi, gumbel_noise, rows):
    """Alg 2's augmented-state recursion at one sub-step: overwrite the
    current-value slot with the cached estimate, Gumbel-argmax, cache the
    winner's estimate.  eps (C, D); cache (C,); xi (C,) current values.
    Returns ``(v (C,) int32, new_cache (C,))``; ``eps`` is not modified.
    A current value outside [0, D) owns no slot (as in the kernels)."""
    slot = torch.arange(eps.shape[-1], device=eps.device) == xi[:, None]
    eps = torch.where(slot, cache[:, None], eps)
    v = gibbs_select(eps, gumbel_noise)
    return v, eps[rows, v.long()]


def at_code(t: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """``t[c, code[c]]`` for every row c of a (C, D) table, and 0 where
    ``code[c]`` lies outside [0, D): a corrupt site value indexes nothing
    (the kernels' convention; the health guard reports it)."""
    D = t.shape[-1]
    idx = code.long().clamp(0, D - 1)
    return torch.where(idx == code, t.gather(1, idx[:, None])[:, 0],
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _uniform_sites(gen, C: int, S: int, n: int, device, sites):
    """``sites`` if given (the draw is skipped), else (C, S) int32 sites
    drawn uniformly from ``gen``."""
    if sites is not None:
        return sites
    return torch.randint(0, n, (C, S), generator=gen, device=device,
                         dtype=torch.int32)


def gibbs_draws(gen, C: int, S: int, n: int, D: int, device, sites=None):
    """The pre-drawn inputs of one Gibbs sweep call, in the sweep's draw
    order: sites (C, S) int32 (skipped when ``sites`` is given), then
    Gumbels (C, S, D)."""
    i = _uniform_sites(gen, C, S, n, device, sites)
    return i, gumbel((C, S, D), gen, device)


def mgpmh_rate(graph: MatchGraph, lam: float) -> torch.Tensor:
    """The per-site Poisson rate ``(lam / L) * L_i`` (n,) of MGPMH's local
    minibatch totals (the same float32 products the draws take per site)."""
    return (lam / graph.L) * graph.row_sum


def mgpmh_draws(gen, graph: MatchGraph, C: int, S: int, rate: torch.Tensor,
                capacity: int, sites=None):
    """The pre-drawn inputs of one MGPMH sweep call, in the sweep's draw
    order: sites (C, S) int32 (skipped when ``sites`` is given); Poisson
    totals
    ``B = min(Poisson(lam * L_i / L), capacity)`` (footnote 7 on the local
    minibatch over A[i]) int32; alias index uniforms (C, S, K); alias accept
    uniforms (C, S, K); Gumbels (C, S, D); log MH uniforms (C, S).
    ``rate`` is ``mgpmh_rate(graph, lam)``, made once by the caller."""
    dev, K = graph.device, capacity
    i = _uniform_sites(gen, C, S, graph.n, dev, sites)
    lam_i = rate.index_select(0, i.view(-1)).view(C, S)
    B = torch.poisson(lam_i, generator=gen).clamp_(max=K).to(torch.int32)
    u_idx = torch.rand((C, S, K), generator=gen, device=dev)
    u_alias = torch.rand((C, S, K), generator=gen, device=dev)
    g = gumbel((C, S, graph.D), gen, dev)
    logu = torch.rand((C, S), generator=gen, device=dev).log_()
    return i, B, u_idx, u_alias, g, logu


def min_gibbs_draws(gen, graph: MatchGraph, C: int, S: int, lam: float,
                    capacity: int, sites=None):
    """The pre-drawn inputs of one MIN-Gibbs sweep call, in the sweep's draw
    order: sites (C, S) int32 (skipped when ``sites`` is given);
    per-candidate Poisson totals
    ``B = min(Poisson(lam), capacity)`` (C, S, D) int32; the four two-stage
    pair-draw uniform streams u_node, u_nacc, u_row, u_racc (C, S, D, K);
    Gumbels (C, S, D)."""
    dev, D, K = graph.device, graph.D, capacity
    i = _uniform_sites(gen, C, S, graph.n, dev, sites)
    rate = torch.full((C, S, D), float(lam), device=dev)
    B = torch.poisson(rate, generator=gen).clamp_(max=K).to(torch.int32)
    u4 = [torch.rand((C, S, D, K), generator=gen, device=dev)
          for _ in range(4)]
    return (i, B, *u4, gumbel((C, S, D), gen, dev))


def double_min_draws(gen, graph: MatchGraph, C: int, S: int, lam1: float,
                     capacity1: int, lam2: float, capacity2: int,
                     sites=None):
    """The pre-drawn inputs of one DoubleMIN sweep call, in the sweep's draw
    order: sites (C, S) int32 (skipped when ``sites`` is given);
    ``B1 = min(Poisson(lam1 * L_i / L), K1)``;
    u_idx, u_alias (C, S, K1); Gumbels (C, S, D);
    ``B2 = min(Poisson(lam2), K2)`` (C, S); u_node, u_nacc, u_row, u_racc
    (C, S, K2); log MH uniforms (C, S)."""
    dev, K1, K2 = graph.device, capacity1, capacity2
    i = _uniform_sites(gen, C, S, graph.n, dev, sites)
    lam_i = (lam1 / graph.L) * graph.row_sum[i.long()]
    B1 = torch.poisson(lam_i, generator=gen).clamp_(max=K1).to(torch.int32)
    u_idx = torch.rand((C, S, K1), generator=gen, device=dev)
    u_alias = torch.rand((C, S, K1), generator=gen, device=dev)
    g = gumbel((C, S, graph.D), gen, dev)
    rate = torch.full((C, S), float(lam2), device=dev)
    B2 = torch.poisson(rate, generator=gen).clamp_(max=K2).to(torch.int32)
    v4 = [torch.rand((C, S, K2), generator=gen, device=dev)
          for _ in range(4)]
    logu = torch.log(torch.rand((C, S), generator=gen, device=dev))
    return (i, B1, u_idx, u_alias, g, B2, *v4, logu)


def init_min_gibbs_cache(gen, graph: MatchGraph, state: ChainState,
                         lam: float, capacity: int) -> ChainState:
    """Seed every chain's cache with one eq.-(2) estimate of its energy:
    one global minibatch per chain, drawn from ``gen``."""
    idx, B = draw_global_minibatch(gen, graph, lam, capacity,
                                   (state.x.shape[0],))
    return state._replace(cache=min_gibbs_estimate(graph, state.x, idx, B,
                                                   lam))


def init_double_min_cache(gen, graph: MatchGraph, state: ChainState,
                          lam2: float, capacity2: int) -> ChainState:
    """Seed every chain's cached xi_x with one eq.-(2) estimate at the
    second-batch size ``lam2``: one global minibatch per chain, from
    ``gen``."""
    return init_min_gibbs_cache(gen, graph, state, lam2, capacity2)


# ---------------------------------------------------------------------------
# Single-site reference steps: one update per chain at a uniform site
# ---------------------------------------------------------------------------

def _sites(gen, graph: MatchGraph, C: int) -> torch.Tensor:
    """One uniform site per chain, (C,) int64."""
    return torch.randint(0, graph.n, (C,), generator=gen, device=graph.device)


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[c, idx[c]]`` for every row c."""
    return t.gather(1, idx.long()[:, None])[:, 0]


def _set_sites(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor):
    """A copy of x with ``x[c, i[c]] = v[c]``."""
    return x.scatter(1, i[:, None], v.to(x.dtype)[:, None])


def make_gibbs_step(graph: MatchGraph):
    """Algorithm 1.  Per chain: a uniform site i, the exact conditional
    energies ``eps_u = sum_j W[i, j] 1[x_j = u]`` (one bucket-energy call,
    w = W[i], v = x, K = n), then ``x_i ~ exp(eps)`` by Gumbel-argmax.
    Draws the sites, then the Gumbels."""
    D, dev = graph.D, graph.device

    def step(state: ChainState) -> ChainState:
        C = state.x.shape[0]
        i = _sites(state.gen, graph, C)
        eps = kernel_ops.bucket_energy(graph.W[i], state.x, D)
        v = gibbs_select(eps, gumbel((C, D), state.gen, dev))
        return state._replace(x=_set_sites(state.x, i, v))

    return step


def make_min_gibbs_step(graph: MatchGraph, lam: float, capacity: int):
    """Algorithm 2, with the bias-adjusted global estimator of eq. (2).
    Per chain: a uniform site i; for every candidate value u an independent
    global minibatch, evaluated at ``x[i <- u]`` (``min_gibbs_estimate``'s
    match counts); the current value's slot takes the cached estimate, and
    the Gumbel-argmax winner's estimate becomes the cache.  Draws the sites,
    the (C, D) global minibatches, then the Gumbels."""
    D, dev = graph.D, graph.device
    values = torch.arange(D, dtype=torch.int32, device=dev)

    def step(state: ChainState) -> ChainState:
        x, gen = state.x, state.gen
        C = x.shape[0]
        i = _sites(gen, graph, C)
        idx, B = draw_global_minibatch(gen, graph, lam, capacity, (C, D))
        y = x[:, None, :].repeat(1, D, 1)                    # (C, D, n)
        y.scatter_(2, i[:, None, None].expand(C, D, 1),
                   values[None, :, None].expand(C, D, 1))
        eps = min_gibbs_estimate(graph, y, idx, B, lam)      # (C, D)
        rows = torch.arange(C, device=dev)
        v, cache = min_gibbs_select(eps, state.cache, _at(x, i),
                                    gumbel((C, D), gen, dev), rows)
        return state._replace(x=_set_sites(x, i, v), cache=cache)

    return step


def local_gibbs_draws(gen, C: int, n: int, batch_size: int, D: int, device):
    """The draws of one Local Minibatch Gibbs update per chain, in draw
    order: sites i (C,) int64; ``batch_size`` distinct neighbours
    j (C, batch_size) int64, none equal to i; Gumbels (C, D).

    The neighbours are the top ``batch_size`` of n - 1 i.i.d. float64
    uniform keys (so every subset of the other sites is equally likely; a
    tie between keys, which could bias the pick, has probability ~n^2/2^53),
    mapped past i by ``j + (j >= i)`` as the JAX step does.  The keys take
    C*(n-1)*8 bytes per update."""
    i = torch.randint(0, n, (C,), generator=gen, device=device)
    keys = torch.rand((C, n - 1), generator=gen, device=device,
                      dtype=torch.float64)
    j = keys.topk(batch_size, dim=1, sorted=False).indices
    j = j + (j >= i[:, None])
    return i, j, gumbel((C, D), gen, device)


def _local_scale(n: int, batch_size: int) -> float:
    """|A[i]| / |S| of Algorithm 3, after checking 1 <= B <= n - 1."""
    if not 1 <= batch_size <= n - 1:
        raise ValueError(f"batch_size must lie in [1, n - 1 = {n - 1}], got "
                         f"{batch_size}")
    return (n - 1) / batch_size


def make_local_gibbs_step(graph: MatchGraph, batch_size: int):
    """Algorithm 3, Local Minibatch Gibbs: one shared uniform minibatch S of
    ``batch_size`` distinct factors of A[i] (drawn without replacement, the
    paper's uniform-subset statement) for every candidate value, and
    ``eps_u = (n - 1)/B * sum_{j in S} W[i, j] 1[x_j = u]`` — one
    bucket-energy call (w = W[i, j], v = x[j], K = B) per update.  Biased
    for B < n - 1; exactly Gibbs at B = n - 1."""
    n, D, dev = graph.n, graph.D, graph.device
    scale = _local_scale(n, batch_size)

    def step(state: ChainState) -> ChainState:
        x = state.x
        i, j, g = local_gibbs_draws(state.gen, x.shape[0], n, batch_size, D,
                                    dev)
        eps = scale * kernel_ops.bucket_energy(graph.W[i[:, None], j],
                                               x.gather(1, j), D)
        return state._replace(x=_set_sites(x, i, gibbs_select(eps, g)))

    return step


def _mgpmh_proposal(graph: MatchGraph, gen, x, i, lam: float, capacity: int):
    """The proposal of Algorithms 4 and 5 at sites i (C,): the local
    minibatch of ``draw_local_minibatch``, its energies
    ``eps = bucket_energy((L/lam) * mask, x[j])`` and a Gumbel-argmax draw.
    Returns (v (C,) int32, eps (C, D))."""
    j, B = draw_local_minibatch(gen, graph, i, lam, capacity)
    live = torch.arange(capacity, device=graph.device) < B[:, None]
    w = (graph.L / lam) * live.to(torch.float32)
    eps = kernel_ops.bucket_energy(w, x.gather(1, j.long()), graph.D)
    v = gibbs_select(eps, gumbel((x.shape[0], graph.D), gen, graph.device))
    return v, eps


def make_mgpmh_step(graph: MatchGraph, lam: float, capacity: int):
    """Algorithm 4.  Per chain: a uniform site i, the minibatch proposal,
    the exact conditional pass (w = W[i], v = x) and the MH test
    ``log u < (exact_v - exact_xi) + (eps_xi - eps_v)``.  Draws the sites,
    the proposal (totals, alias draws, Gumbels), then the MH uniforms."""
    dev = graph.device

    def step(state: ChainState) -> ChainState:
        x, gen = state.x, state.gen
        C = x.shape[0]
        i = _sites(gen, graph, C)
        v, eps = _mgpmh_proposal(graph, gen, x, i, lam, capacity)
        exact = kernel_ops.bucket_energy(graph.W[i], x, graph.D)
        xi = _at(x, i)
        logu = torch.log(torch.rand((C,), generator=gen, device=dev))
        accept = mh_accept(logu, _at(exact, v) - at_code(exact, xi),
                           at_code(eps, xi), _at(eps, v))
        return state._replace(
            x=_set_sites(x, i, torch.where(accept, v, xi)),
            accepts=state.accepts + accept.to(torch.int32))

    return step


def make_double_min_step(graph: MatchGraph, lam1: float, capacity1: int,
                         lam2: float, capacity2: int):
    """Algorithm 5.  The MGPMH proposal, then a second (global,
    bias-adjusted) minibatch at ``y = x[i <- v]`` in the test
    ``log u < (xi_y - xi_x) + (eps_xi - eps_v)``; the cached xi_x rides
    ``state.cache``.  Draws the sites, the proposal, the second batch, then
    the MH uniforms."""
    dev = graph.device

    def step(state: ChainState) -> ChainState:
        x, gen = state.x, state.gen
        C = x.shape[0]
        i = _sites(gen, graph, C)
        v, eps = _mgpmh_proposal(graph, gen, x, i, lam1, capacity1)
        y = _set_sites(x, i, v)
        idx, B = draw_global_minibatch(gen, graph, lam2, capacity2, (C,))
        xi_y = min_gibbs_estimate(graph, y, idx, B, lam2)
        logu = torch.log(torch.rand((C,), generator=gen, device=dev))
        accept = mh_accept(logu, xi_y - state.cache,
                           at_code(eps, _at(x, i)), _at(eps, v))
        return state._replace(
            x=torch.where(accept[:, None], y, x),
            cache=torch.where(accept, xi_y, state.cache),
            accepts=state.accepts + accept.to(torch.int32))

    return step


def _build_step_sweep(step, sweep_len: int):
    """``sweep_len`` applications of a single-site ``step`` per call: the
    unfused sweep of an algorithm, one launch of each of its step's kernels
    per sub-step on the card (Local Minibatch Gibbs's fused sweep,
    ``_build_local_gibbs_sweep``, is held to it in distribution)."""
    def sweep(state: ChainState) -> ChainState:
        for _ in range(sweep_len):
            state = step(state)
        return state

    return sweep


def _node_alias_table(graph: MatchGraph):
    """Alias table over sites with p_a = L_a / 2Psi — stage one of the
    two-stage global factor draw (stage two is the per-row table; the
    product is exactly M_phi / Psi).  Built from the float32 row sums, as
    the JAX package builds it, so the two tables are identical."""
    prob, alias = build_alias_table(graph.row_sum.cpu().numpy())
    return (torch.from_numpy(prob).to(graph.device),
            torch.from_numpy(alias).to(graph.device))


def evidence_cdf(ev_mask: torch.Tensor) -> torch.Tensor:
    """(n,) cumulative site-selection table, uniform over UNOBSERVED sites.

    ``ev_mask`` is (n,) float32 with 1.0 at observed (clamped) sites.  The
    partial sums are integers below 2^24, exact in any summation order
    (also the card's parallel scan), so an observed site keeps an exact tie
    with its predecessor and the last entry is exactly 1.0: a
    ``searchsorted(cdf, u, right=True)`` draw with u in [0, 1) never lands
    on an observed site.  An all-zero mask gives the uniform table."""
    c = torch.cumsum(1.0 - ev_mask, 0)
    return c / c[-1].clamp_min(1e-30)


def inverse_cdf_sites(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Site of each uniform in ``u`` under the cumulative table ``cdf``
    ((n,)): the first index whose entry exceeds u, at most n - 1; int32,
    u's shape."""
    i = torch.searchsorted(cdf, u, right=True, out_int32=True)
    return i.clamp_max_(cdf.shape[0] - 1)


def _draw_sites(gen, C: int, S: int, n: int, sites, evidence, device):
    """The (C, S) int32 sites chosen for one sweep call, or None.  Explicit
    ``sites`` win (AdaptiveScan); with ``evidence`` one uniform per (chain,
    sub-step) goes through the masked inverse-CDF (:func:`evidence_cdf`);
    with neither it returns None and the ``*_draws`` function makes the
    uniform draw in the same place of the draw order."""
    if sites is not None or evidence is None:
        return sites
    u = torch.rand((C, S), generator=gen, device=device)
    return inverse_cdf_sites(evidence_cdf(evidence[0]), u)


def _build_gibbs_sweep(graph: MatchGraph, sweep_len: int, *,
                       collect_stats: bool = False):
    """``sweep_len`` sequential vanilla-Gibbs updates per call, one fused
    kernel launch (or its plain version on the CPU) for all chains.
    Returns ``sweep(state, sites=None, evidence=None)`` (see the module
    docstring); with ``collect_stats`` it returns (state, SiteDraws): the
    site hits as proposals and acceptances (exact accept)."""
    n, D, dev = graph.n, graph.D, graph.device

    def sweep(state: ChainState, sites=None, evidence=None):
        C = state.x.shape[0]
        i = _draw_sites(state.gen, C, sweep_len, n, sites, evidence, dev)
        i, g = gibbs_draws(state.gen, C, sweep_len, n, D, dev, sites=i)
        x = kernel_ops.gibbs_sweep(state.x, graph.W, i, g, D=D)
        new = state._replace(x=x)
        if not collect_stats:
            return new
        return new, SiteDraws(i)

    return sweep


def _build_local_gibbs_sweep(graph: MatchGraph, batch_size: int,
                             sweep_len: int):
    """``sweep_len`` sequential Local Minibatch Gibbs updates (Algorithm 3
    per sub-step) per call, one fused launch for all chains.  Per call it
    draws the sites (C, S) int32, then a (1,) int32 Philox seed, from
    ``state.gen`` on the state's device (no host sync); the B-subsets
    (Floyd's algorithm, uniform over the B-subsets of the other sites) and
    the Gumbels come from Philox under that seed, in-kernel on the card and
    in ``ref.local_gibbs_sweep_ref`` on the CPU, with the same bits."""
    n, D, dev = graph.n, graph.D, graph.device
    scale = _local_scale(n, batch_size)

    def sweep(state: ChainState) -> ChainState:
        i = torch.randint(0, n, (state.x.shape[0], sweep_len),
                          generator=state.gen, device=dev, dtype=torch.int32)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=state.gen,
                             device=dev, dtype=torch.int32)
        x = kernel_ops.local_gibbs_sweep(state.x, graph.W, i, seed,
                                         B=batch_size, D=D, scale=scale)
        return state._replace(x=x)

    return sweep


def _build_mgpmh_sweep(graph: MatchGraph, lam: float, capacity: int,
                       sweep_len: int, *, collect_stats: bool = False):
    """``sweep_len`` sequential MGPMH updates (Algorithm 4 per sub-step) per
    call, one fused launch for all chains, fed by :func:`mgpmh_draws`; it
    reads the row alias tables as packed records (``graph.row_pack``).
    Distributionally identical to ``sweep_len`` single-site MGPMH steps —
    Theorems 3/4 apply unchanged.  The per-site Poisson rate is made once
    here.  ``sites=`` / ``evidence=`` / ``collect_stats`` as in the module
    docstring (per-site acceptances: accepted moves)."""
    n, D, dev = graph.n, graph.D, graph.device
    scale = float(graph.L / lam)
    W, row_pack = graph.W, graph.row_pack
    rate = mgpmh_rate(graph, lam)

    def sweep(state: ChainState, sites=None, evidence=None):
        C = state.x.shape[0]
        i = _draw_sites(state.gen, C, sweep_len, n, sites, evidence, dev)
        draws = mgpmh_draws(state.gen, graph, C, sweep_len, rate, capacity,
                            sites=i)
        x, acc = kernel_ops.mgpmh_sweep(state.x, W, row_pack, *draws, D=D,
                                        scale=scale)
        new = state._replace(x=x, accepts=state.accepts + acc)
        if not collect_stats:
            return new
        return new, SiteDraws(draws[0], moves=True)

    return sweep


def _build_min_gibbs_sweep(graph: MatchGraph, lam: float, capacity: int,
                           sweep_len: int, *, collect_stats: bool = False):
    """``sweep_len`` sequential MIN-Gibbs updates (Algorithm 2 per sub-step)
    per call, one fused launch for all chains, fed by
    :func:`min_gibbs_draws`; the cached estimate rides ``state.cache``.
    The global minibatches use the two-stage pair draw (node table, then
    row table), so the sweep never reads the flat factor table; it reads
    both tables as packed records (``graph.row_pack``).  ``sites=`` /
    ``evidence=`` / ``collect_stats`` as in the module docstring (per-site
    acceptances: hits, exact accept)."""
    n, D, dev = graph.n, graph.D, graph.device
    lscale = min_gibbs_lscale(graph.psi, lam)
    node_pack = pack_alias(*_node_alias_table(graph))
    row_pack = graph.row_pack

    def sweep(state: ChainState, sites=None, evidence=None):
        C = state.x.shape[0]
        i = _draw_sites(state.gen, C, sweep_len, n, sites, evidence, dev)
        draws = min_gibbs_draws(state.gen, graph, C, sweep_len, lam,
                                capacity, sites=i)
        x, cache = kernel_ops.min_gibbs_sweep(
            state.x, node_pack, row_pack, *draws, state.cache, D=D,
            lscale=lscale)
        new = state._replace(x=x, cache=cache)
        if not collect_stats:
            return new
        return new, SiteDraws(draws[0])

    return sweep


def _build_double_min_sweep(graph: MatchGraph, lam1: float, capacity1: int,
                            lam2: float, capacity2: int, sweep_len: int, *,
                            collect_stats: bool = False):
    """``sweep_len`` sequential DoubleMIN updates (Algorithm 5 per
    sub-step) per call: MGPMH proposal plus a second global minibatch in
    the acceptance test, one fused launch fed by :func:`double_min_draws`.
    The cached xi_x rides ``state.cache``; accepts add to
    ``state.accepts``.  ``sites=`` / ``evidence=`` / ``collect_stats`` as
    in the module docstring (per-site acceptances: accepted moves)."""
    n, D, dev = graph.n, graph.D, graph.device
    scale1 = float(graph.L / lam1)
    lscale2 = min_gibbs_lscale(graph.psi, lam2)
    node_pack = pack_alias(*_node_alias_table(graph))
    row_pack = graph.row_pack

    def sweep(state: ChainState, sites=None, evidence=None):
        C = state.x.shape[0]
        i = _draw_sites(state.gen, C, sweep_len, n, sites, evidence, dev)
        draws = double_min_draws(state.gen, graph, C, sweep_len, lam1,
                                 capacity1, lam2, capacity2, sites=i)
        x, cache, acc = kernel_ops.double_min_sweep(
            state.x, row_pack, node_pack, *draws, state.cache, D=D,
            scale1=scale1, lscale2=lscale2)
        new = state._replace(x=x, cache=cache, accepts=state.accepts + acc)
        if not collect_stats:
            return new
        return new, SiteDraws(draws[0], moves=True)

    return sweep


def validate_coloring(graph: MatchGraph, colors) -> list:
    """Check ``colors`` is a proper coloring of ``graph`` (non-empty
    classes, no same-color factors) and return the color classes as numpy
    index arrays."""
    colors = np.asarray(colors)
    n = graph.n
    if colors.shape != (n,):
        raise ValueError(f"colors must have shape ({n},), got {colors.shape}")
    n_colors = int(colors.max()) + 1
    classes = [np.flatnonzero(colors == c) for c in range(n_colors)]
    for c, sites in enumerate(classes):
        if sites.size == 0:
            raise ValueError(f"color class {c} is empty")
        idx = torch.as_tensor(sites, device=graph.device)
        if bool((graph.W[idx][:, idx] != 0.0).any()):
            raise ValueError(
                f"colors is not a proper coloring: class {c} shares factors")
    return classes


def _build_chromatic_gibbs_sweep(graph: MatchGraph, colors, *,
                                 collect_stats: bool = False):
    """One full chromatic Gibbs sweep per call: every color class updated as
    a block, one class-kernel launch per class.

    Same-color sites share no factor (checked at build time), so every
    in-class update reads energies of the state the class started from:
    the class kernel updates all (chain, site) pairs of a class at once,
    walking W's neighbour table (``graph.nbr_pack``, built here), and
    writes the class in place into the call's one copy of the state.  Per
    class, in color order, the sweep draws uniforms (C, |class|, D) from
    ``state.gen`` (the draw :func:`gumbel` makes), and the class update
    makes their Gumbels itself (in-kernel on the card): per class one
    ``torch.rand`` and one launch.  ``updates_per_call`` is n.

    ``evidence=`` (an ``(ev_mask, ev_vals)`` pair) re-clamps x after every
    class launch: the class kernel resamples whole classes, observed sites
    included, and later classes condition on earlier ones, so the clamp is
    restored between classes, not once at the end (a resampled observed
    site is never read by its own class).  ``collect_stats``: every site
    is updated once per chain and call, all exact block-Gibbs updates.
    """
    n, D, dev = graph.n, graph.D, graph.device
    classes = [torch.as_tensor(s, dtype=torch.int32, device=dev)
               for s in validate_coloring(graph, colors)]
    W, nbr = graph.W, graph.nbr_pack

    def sweep(state: ChainState, evidence=None):
        C = state.x.shape[0]
        x = state.x.clone()
        if evidence is not None:
            observed = evidence[0] > 0.0
            values = evidence[1].to(x.dtype)
        for sites in classes:
            u = torch.rand((C, sites.shape[0], D), generator=state.gen,
                           device=dev)
            kernel_ops.gibbs_class_sweep(x, W, nbr, sites, u, D=D)
            if evidence is not None:
                x.copy_(torch.where(observed, values, x))
        new = state._replace(x=x)
        if not collect_stats:
            return new
        hits = torch.full((n,), float(C), device=dev)
        return new, SweepStats(site_prop=hits, site_acc=hits)

    return sweep
