"""Adaptive-scan control: telemetry-driven non-uniform site selection and
the minibatch-size (lambda) auto-tuner.  A copy of the JAX package's
``diagnostics/adaptive.py`` on torch tensors.

Smolyakov et al.'s adaptive-scan observation (PAPERS.md) is that a
random-scan sampler wastes updates on sites that are already effectively
independent between snapshots; selection probabilities driven by online
statistics equalize *information* per update instead.

  * :class:`AdaptiveState` wraps the sampler's ChainState with the
    telemetry carry, a cumulative site-selection table, and a call counter;
  * :func:`make_adaptive_engine` builds an :class:`~repro_torch.core.engine.
    Engine` whose sweep draws its sites from the carried table (inverse-CDF
    via ``searchsorted``) and hands them to the fused sweep (``sites=``).
    The JAX package refreshes the table every ``refresh_every`` sweeps
    under a ``lax.cond`` on the device; here the call counter lives on the
    host, so the refresh is a plain ``if`` on a Python int — still no host
    sync, and the refresh itself runs on the device;
  * :func:`autotune_lambda` pilot-runs an MH minibatch engine with
    telemetry and adjusts lambda geometrically until the measured
    acceptance lands in a target band.

Weighting rule: per-site flip rate r_i = flips_i / hits_i estimates the
per-update move probability; w_i = 1 / (r_i + smoothing) is the estimated
number of updates per independent move, and the selection probability is
``uniform_mix / n + (1 - uniform_mix) * w_i / sum(w)``.  Between refreshes
the site distribution is fixed, so each segment is an ordinary (valid)
random-scan chain.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.engine import AdaptiveScan, Engine
from ..core import samplers as S
from .telemetry import (Telemetry, acceptance_rate, telemetry_init,
                        telemetry_update)

__all__ = ["AdaptiveScan", "AdaptiveState", "make_adaptive_engine",
           "refresh_cdf", "masked_cdf", "run_with_telemetry",
           "autotune_lambda"]


class AdaptiveState(NamedTuple):
    """Sampler state + control state of an adaptive-scan engine.

    ``inner`` is the wrapped ChainState; ``cdf`` the cumulative
    site-selection table the next sweeps draw from; ``tel`` the streaming
    telemetry feeding the next refresh (lag ring of depth 1); ``calls`` the
    host-side sweep-call counter.  ``x`` / ``accepts`` forward to ``inner``,
    so the runner and ``Engine.sweep``'s telemetry path work unchanged.
    A sweep consumes the state's ``tel`` (updated in place).
    """
    inner: Any
    cdf: torch.Tensor    # (n,) float32 cumulative selection probabilities
    tel: Telemetry
    calls: int

    @property
    def x(self):
        return self.inner.x

    @property
    def accepts(self):
        return self.inner.accepts


def refresh_cdf(flips: torch.Tensor, props: torch.Tensor, n: int,
                uniform_mix: float, smoothing: float) -> torch.Tensor:
    """New cumulative selection table from raw per-site flip/proposal
    counters, on their device (no host sync)."""
    rate = flips / props.clamp_min(1.0)
    w = 1.0 / (rate + smoothing)
    p = uniform_mix / n + (1.0 - uniform_mix) * w / w.sum()
    return torch.cumsum(p, 0)


def masked_cdf(cdf: torch.Tensor, ev_mask: torch.Tensor) -> torch.Tensor:
    """The table ``cdf`` with the observed sites' (``ev_mask == 1``)
    selection mass removed and the rest renormalized.

    An observed site gets an exact tie with its predecessor by
    construction — its entry is set to 0 and a running maximum fills it
    with the entry before — so a ``searchsorted(..., right=True)`` draw
    never lands on it, whatever order the card's parallel scan sums in.
    With an all-zero mask this is the carried table renormalized."""
    p = torch.diff(cdf, prepend=cdf.new_zeros(1)) * (1.0 - ev_mask)
    c = torch.cumsum(p, 0).masked_fill_(ev_mask > 0.0, 0.0)
    c = torch.cummax(c, 0).values
    return c / c[-1].clamp_min(1e-30)


def make_adaptive_engine(name: str, graph, schedule: AdaptiveScan,
                         backend: str, *, core, chain_init,
                         params: Dict[str, Any], exact_accept: bool = False,
                         cache_init=None) -> Engine:
    """Assemble the AdaptiveScan :class:`Engine` for a gibbs-family sampler.

    ``core`` is the instrumented fused sweep ``(state, sites=...) ->
    (state, SiteDraws)`` (``collect_stats=True``); ``chain_init`` the
    plain state's ``init_fn``.  The sweep draws one uniform per (chain,
    sub-step) from ``state.gen`` for the sites, then ``core`` draws the
    rest; it threads the control telemetry and refreshes the table every
    ``refresh_every`` calls.  Called by ``engine.make``.
    """
    n, D = graph.n, graph.D
    sweep_len, K = schedule.sweep_len, schedule.refresh_every
    mix, r0 = schedule.uniform_mix, schedule.smoothing

    def init_fn(gen, n_chains: int, *, start: str = "constant"):
        st = chain_init(gen, n_chains, start=start)
        cdf = torch.cumsum(torch.full((n,), 1.0 / n, device=st.x.device), 0)
        # the control loop feeds on flip/hit counters only: a lag-1 ring
        # keeps the carried state small (thread a separate Telemetry
        # through Engine.sweep for deep-lag ESS)
        return AdaptiveState(inner=st, cdf=cdf,
                             tel=telemetry_init(st.x, lags=1), calls=0)

    def sweep_fn(ast: AdaptiveState, evidence=None) -> AdaptiveState:
        st = ast.inner
        cdf = ast.cdf if evidence is None else masked_cdf(ast.cdf,
                                                          evidence[0])
        u = torch.rand((st.x.shape[0], sweep_len), generator=st.gen,
                       device=st.x.device)
        new, stats = core(st, sites=S.inverse_cdf_sites(cdf, u))
        tel = telemetry_update(ast.tel, st.x, new.x, sweep_len,
                               new.accepts - st.accepts, stats,
                               cache=new.cache, n_values=D)
        calls = ast.calls + 1
        cdf = (refresh_cdf(tel.site_flips, tel.site_prop, n, mix, r0)
               if calls % K == 0 else ast.cdf)
        return AdaptiveState(inner=new, cdf=cdf, tel=tel, calls=calls)

    return Engine(
        name=name, backend=backend, device=graph.device, schedule=schedule,
        updates_per_call=sweep_len, marginal_samples_per_call=1, graph=graph,
        params=params, init_fn=init_fn, sweep_fn=sweep_fn,
        exact_accept=exact_accept, supports_evidence=True,
        cache_init=cache_init)


# ---------------------------------------------------------------------------
# Telemetry-driven pilot runs + the lambda auto-tuner
# ---------------------------------------------------------------------------

def run_with_telemetry(engine: Engine, state, telemetry, n_calls: int):
    """``n_calls`` sweep calls threading the telemetry carry (consumed).
    Returns ``(state, telemetry)``; no host sync."""
    for _ in range(n_calls):
        state, telemetry = engine.sweep(state, telemetry)
    return state, telemetry


def autotune_lambda(name: str, graph, *,
                    target: Tuple[float, float] = (0.5, 0.9),
                    sweep: int = 16, n_chains: int = 16,
                    pilot_calls: int = 32, max_rounds: int = 10,
                    lam0: Optional[float] = None, seed: int = 0,
                    device=None, **params) -> Tuple[Engine, List[dict]]:
    """Auto-tune the minibatch rate lambda of an MH minibatch engine
    (mgpmh / doublemin) until pilot-run mean acceptance lands in ``target``.

    Larger lambda means bigger minibatches, tighter energy estimates and
    higher acceptance (Thm 4: rate >= exp(-L^2/lambda) for MGPMH) at more
    work per update; the tuner searches lambda geometrically (doubling /
    halving, bisecting in log space once both sides of the band have been
    seen).  Each round builds the engine at its lambda and runs
    ``pilot_calls`` telemetry'd sweeps over ``n_chains`` chains, then reads
    the acceptance on the host once.

    Returns ``(engine, history)``: the tuned Engine plus one
    ``{"lam": ..., "acceptance": ...}`` record per round.  Raises for
    engines with no MH acceptance to tune.
    """
    from ..core import engine as engine_lib
    lo, hi = target
    if not (0.0 < lo < hi <= 1.0):
        raise ValueError(f"target must satisfy 0 < lo < hi <= 1, got {target}")
    lam_key = "lam1" if name == "doublemin" else "lam"
    lam = lam0
    lam_lo = lam_hi = None          # bracket: too-low / too-high lambdas
    history: List[dict] = []
    eng = None
    for _ in range(max_rounds):
        kw = dict(params)
        if lam is not None:
            kw[lam_key] = lam
        eng = engine_lib.make(name, graph, sweep=sweep, device=device, **kw)
        if eng.exact_accept:
            raise ValueError(f"engine {name!r} accepts every update by "
                             f"construction; there is no acceptance to tune")
        lam = float(eng.params[lam_key])
        st = eng.init(seed, n_chains)
        tel = eng.init_telemetry(st)
        st, tel = run_with_telemetry(eng, st, tel, pilot_calls)
        acc = acceptance_rate(tel)
        history.append({"lam": lam, "acceptance": acc})
        if lo <= acc <= hi:
            break
        if acc < lo:
            lam_lo = lam
            lam = lam * 2.0 if lam_hi is None else math.sqrt(lam * lam_hi)
        else:
            lam_hi = lam
            lam = lam / 2.0 if lam_lo is None else math.sqrt(lam * lam_lo)
    else:
        warnings.warn(
            f"autotune_lambda: acceptance {history[-1]['acceptance']:.3f} "
            f"(lam={history[-1]['lam']:.3g}) never landed in {target} "
            f"within {max_rounds} rounds; returning the last pilot engine",
            RuntimeWarning, stacklevel=2)
    return eng, history
