"""Streaming convergence telemetry: a device-resident carry threaded through
``Engine.sweep``, updated in place with no host sync.

A copy of the JAX package's ``diagnostics/telemetry.py`` on torch tensors.
The carry holds, per (chain, site):

  * **Welford running moments** of the site value over the whole run and
    over its second half, so split-R-hat follows at summary time (the
    first half by Chan's combine formula run backwards);
  * **a lag-K ring of snapshots and K sums of cross-products**
    ``x_t * x_{t-k}`` (default K = 8), feeding Geyer's initial-sequence
    ESS estimator; ``lags=1`` is the lag-1 geometric estimate;
  * **per-site counters**: proposals (``site_prop``), MH acceptances
    (``site_acc``), value changes (``site_flips``, from state diffs);
  * **per-chain MH acceptance** totals and the health guards (a sticky
    bad-state flag and an exponentially windowed acceptance).

Where the JAX carry is rebuilt by XLA each call, this one is updated in
place: :func:`telemetry_update` consumes the carry it is given (its tensors
are overwritten) and returns it.  The snapshot ring is a double ring
``prev`` of 2K slots with a host-side head, so the K lags are one
contiguous slice and one in-place product updates every lag sum; the
ring's exported order is the JAX package's (``prev[k-1] = x_{t-k}``,
:func:`telemetry_to_numpy`).  The carry keeps two host-side copies,
``count`` (of ``samples``) and ``split`` (of ``half_at``), which decide
from the host which lags and which half a snapshot feeds: no Python
``if`` reads a device tensor.  The scalar fields stay 0-d or (K,) float32
tensors on the device, exact counting below 2^24.

On the card the update is one launch of a fused kernel
(``kernels/csrc/telemetry_update.cu``), which gets those host-side
decisions as arguments and gives the plain version's bits; on the CPU it is
the plain version's ~30 eager operations (:func:`telemetry_update_plain`).

Summaries (:func:`split_rhat`, :func:`ess_per_site`, :func:`summarize`,
:func:`health_report`) are host-side numpy, as in the JAX package: call
them after the run, not inside it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.telemetry_update import telemetry_update_cuda

__all__ = [
    "Telemetry", "SweepStats", "SiteDraws", "telemetry_init",
    "telemetry_update", "telemetry_update_plain", "telemetry_from_numpy",
    "telemetry_to_numpy", "TELEMETRY_FIELDS",
    "split_rhat", "ess_per_site", "acceptance_rate", "summarize",
    "state_health", "health_report", "clear_health", "HEALTH_DECAY",
]

# per-sweep-call decay of the windowed acceptance counters: ~last
# 1/(1-decay) = 50 calls dominate, so a collapse shows within a few dozen
# sweeps instead of being averaged away by a long healthy history
HEALTH_DECAY = 0.98

# the JAX package's Telemetry fields, in its order (the numpy exchange
# format of telemetry_from_numpy / telemetry_to_numpy)
TELEMETRY_FIELDS = (
    "samples", "updates", "half_at", "mean", "m2", "samples_h", "mean_h",
    "m2_h", "prev", "cross", "cross_n", "accepts", "site_prop", "site_acc",
    "site_flips", "bad_state", "win_prop", "win_acc")


class SweepStats(NamedTuple):
    """Per-call site counters emitted by an instrumented sweep.

    ``site_prop[i]``: proposals (site updates attempted) at site i this call;
    ``site_acc[i]``:  MH acceptances at site i (== site_prop for exact-accept
    samplers; the MGPMH and DoubleMIN kernels keep acceptance inside, so
    there it counts accepted *moves* — a documented lower bound).
    """
    site_prop: torch.Tensor   # (n,) float32
    site_acc: torch.Tensor    # (n,) float32


class SiteDraws(NamedTuple):
    """An instrumented sweep's per-site counters before they are counted:
    the sites its sub-steps updated and whether its acceptances are the
    hits themselves (exact-accept samplers) or the sites' value changes
    (``moves``: the MGPMH and DoubleMIN kernels keep acceptance inside).

    :func:`telemetry_update` counts them: the card's kernel from ``sites``
    in the same launch, the plain version through :meth:`counters`, which
    gives the :class:`SweepStats` the sweep would otherwise have made (the
    same values: counts below 2^24 are exact in any order)."""
    sites: torch.Tensor       # (C, S) int32 site of each sub-step
    moves: bool = False

    def counters(self, old_x: torch.Tensor, new_x: torch.Tensor,
                 n: int) -> SweepStats:
        """The per-site proposal and acceptance counts ((n,) float32)."""
        i = self.sites.reshape(-1).long()
        hits = torch.zeros(n, device=i.device).index_add_(
            0, i, torch.ones(i.shape, device=i.device))
        acc = ((old_x != new_x).sum(0, dtype=torch.float32) if self.moves
               else hits)
        return SweepStats(site_prop=hits, site_acc=acc)


class Telemetry(NamedTuple):
    """Device-resident streaming convergence statistics (float32 fields).

    The fields are the JAX package's, but for ``prev``: here a double ring
    of 2K snapshot slots, slot ``head + k - 1`` (and its copy K slots on)
    holding ``x_{t-k}``.  ``half_at`` (``inf``: no split; summaries then
    fall back to the plain multi-chain R-hat) marks the snapshot index where
    the second-half accumulator starts.  ``head``, ``count`` and ``split``
    are host-side ints/floats: the ring head, and copies of ``samples`` and
    ``half_at`` that the update reads instead of the device.
    """
    samples: torch.Tensor     # () snapshots accumulated
    updates: torch.Tensor     # () site updates accumulated
    half_at: torch.Tensor     # () first snapshot index of the second half
    mean: torch.Tensor        # (C, n) Welford mean of the site value
    m2: torch.Tensor          # (C, n) Welford M2
    samples_h: torch.Tensor   # () snapshots in the second half
    mean_h: torch.Tensor      # (C, n) second-half Welford mean
    m2_h: torch.Tensor        # (C, n) second-half Welford M2
    prev: torch.Tensor        # (2K, C, n) double ring of the last K snapshots
    cross: torch.Tensor       # (K, C, n) sums of products x_t * x_{t-k}
    cross_n: torch.Tensor     # (K,) pairs accumulated into each cross[k-1]
    accepts: torch.Tensor     # (C,) MH acceptances accumulated
    site_prop: torch.Tensor   # (n,) per-site proposals
    site_acc: torch.Tensor    # (n,) per-site MH acceptances
    site_flips: torch.Tensor  # (n,) per-site value changes (state diffs)
    bad_state: torch.Tensor   # () sticky flag: non-finite cache or a site
    #                           value out of [0, D) seen in any sweep
    win_prop: torch.Tensor    # () decayed site-update count (window)
    win_acc: torch.Tensor     # () decayed MH-acceptance count (window)
    head: int = 0             # ring slot of x_{t-1}
    count: int = 0            # host copy of ``samples``
    split: float = math.inf   # host copy of ``half_at``


def _lags(tel: Telemetry) -> int:
    return tel.cross.shape[0]


def telemetry_init(x: torch.Tensor, half_at: Optional[float] = None,
                   lags: int = 8) -> Telemetry:
    """Zeroed telemetry for a batched state ``x`` of shape (C, n), on x's
    device.

    ``half_at``: snapshot index where the second-half accumulator starts
    (``total_snapshots // 2`` gives a proper split-R-hat; the marginal
    runner passes it).  ``None`` disables the split.  ``lags``: depth K of
    the autocovariance ring feeding the initial-sequence ESS estimator.
    """
    if lags < 1:
        raise ValueError(f"lags must be >= 1, got {lags}")
    C, n = x.shape
    dev = x.device
    split = math.inf if half_at is None else float(half_at)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return Telemetry(
        samples=zeros(), updates=zeros(),
        half_at=torch.full((), split, dtype=torch.float32, device=dev),
        mean=zeros(C, n), m2=zeros(C, n), samples_h=zeros(),
        mean_h=zeros(C, n), m2_h=zeros(C, n), prev=zeros(2 * lags, C, n),
        cross=zeros(lags, C, n), cross_n=zeros(lags), accepts=zeros(C),
        site_prop=zeros(n), site_acc=zeros(n), site_flips=zeros(n),
        bad_state=zeros(), win_prop=zeros(), win_acc=zeros(),
        head=0, count=0, split=split)


def telemetry_update(tel: Telemetry, old_x: torch.Tensor,
                     new_x: torch.Tensor, updates: int,
                     accept_delta: Optional[torch.Tensor] = None,
                     stats=None,
                     cache: Optional[torch.Tensor] = None,
                     n_values: Optional[int] = None) -> Telemetry:
    """One streaming update from a sweep call that advanced ``old_x`` to
    ``new_x`` (both (C, n) int) in ``updates`` site updates per chain.

    Dispatched by the carry's device: a CPU carry goes to
    :func:`telemetry_update_plain`; a carry on the card to the fused kernel
    (``kernels/telemetry_update.py``, one launch, the plain version's bits;
    x int32, ``accept_delta`` int32 or float32, every input float32 or
    int32 on the carry's device), which launches or raises.  Nothing falls
    back from one to the other.  CONSUMES ``tel`` either way (see
    :func:`telemetry_update_plain`).  ``stats`` is a :class:`SweepStats`
    or a :class:`SiteDraws` (what the engines' instrumented sweeps emit:
    the kernel counts the sites itself).
    """
    device = tel.mean.device.type
    if device == "cpu":
        return telemetry_update_plain(tel, old_x, new_x, updates,
                                      accept_delta, stats, cache, n_values)
    if device != "cuda":
        raise ValueError(f"telemetry_update runs a carry on 'cpu' or "
                         f"'cuda', got {tel.mean.device}")
    plan = telemetry_update_cuda(tel, old_x, new_x, updates, accept_delta,
                                 stats, cache, n_values, decay=HEALTH_DECAY)
    return tel._replace(head=plan.new_head, count=plan.count_new)


def telemetry_update_plain(tel: Telemetry, old_x: torch.Tensor,
                           new_x: torch.Tensor, updates: int,
                           accept_delta: Optional[torch.Tensor] = None,
                           stats=None,
                           cache: Optional[torch.Tensor] = None,
                           n_values: Optional[int] = None) -> Telemetry:
    """The plain PyTorch version of :func:`telemetry_update` (eager
    operations on any device; the CPU path, and the card kernel's yardstick
    in the tests and ``chip_smoke.py``).

    CONSUMES ``tel``: its tensors are updated in place and the returned
    carry shares them (rebind: ``tel = telemetry_update(tel, ...)``).
    O(C*n) elementwise work plus one pass over the K lag sums, all on the
    device, no host sync.  ``accept_delta``: per-chain MH-acceptance
    increment ((C,), optional); ``stats``: the instrumented sweep's
    per-site counters (optional).

    ``cache`` (the state's cached energy estimate) and ``n_values`` (the
    site domain size D) feed the health guards: ``bad_state`` latches when
    any cache entry is non-finite or any site value leaves [0, D), and
    ``win_prop`` / ``win_acc`` keep an exponentially windowed acceptance
    rate so a lambda-mistuning acceptance collapse (De Sa et al. 2018,
    Thm. 2) shows long before the cumulative rate moves.
    """
    K = _lags(tel)
    if isinstance(stats, SiteDraws):
        stats = stats.counters(old_x, new_x, tel.mean.shape[1])
    xf = new_x.to(torch.float32)
    tel.samples.add_(1.0)
    d = xf - tel.mean
    tel.mean.add_(d / tel.samples)
    tel.m2.addcmul_(d, xf - tel.mean)

    # second-half accumulator (split-R-hat): snapshots from half_at on
    if tel.count >= tel.split:
        tel.samples_h.add_(1.0)
        dh = xf - tel.mean_h
        tel.mean_h.add_(dh / tel.samples_h)
        tel.m2_h.addcmul_(dh, xf - tel.mean_h)

    # lag-k cross-products, k = 1..K: slots head .. head+K-1 hold x_{t-1}
    # .. x_{t-K} (zeros until that many snapshots were seen, so an unfilled
    # lag adds +0); lag k counts its pairs once k snapshots were seen
    tel.cross.addcmul_(tel.prev[tel.head:tel.head + K], xf.unsqueeze(0))
    tel.cross_n[:min(tel.count, K)].add_(1.0)
    head = (tel.head - 1) % K
    tel.prev.view(2, K, *xf.shape)[:, head].copy_(xf)

    tel.site_flips.add_((old_x != new_x).sum(0, dtype=torch.float32))
    if accept_delta is not None:
        tel.accepts.add_(accept_delta.to(torch.float32))
    if stats is not None:
        tel.site_prop.add_(stats.site_prop)
        tel.site_acc.add_(stats.site_acc)

    # health guards: sticky bad-state flag + windowed acceptance counters
    torch.maximum(tel.bad_state, state_health(new_x, cache, n_values),
                  out=tel.bad_state)
    tel.win_prop.mul_(HEALTH_DECAY).add_(float(updates))
    tel.win_acc.mul_(HEALTH_DECAY)
    if accept_delta is None:
        tel.win_acc.add_(float(updates))
    else:
        tel.win_acc.add_(accept_delta.to(torch.float32).mean())
    tel.updates.add_(float(updates))
    return tel._replace(head=head, count=tel.count + 1)


def state_health(x: torch.Tensor, cache: Optional[torch.Tensor] = None,
                 n_values: Optional[int] = None) -> torch.Tensor:
    """() float32 flag on x's device: 1.0 iff the chain state is degenerate.

    Degenerate means a non-finite cached energy or a site value outside
    [0, D) (D = ``n_values``; x is integral, so corruption shows as
    out-of-domain codes rather than NaN).  A device reduction, no host
    sync: usable inside the telemetry carry and as a one-off check."""
    lo, hi = torch.aminmax(x)
    bad = lo < 0
    if n_values is not None:
        bad = bad | (hi >= n_values)
    if cache is not None:
        bad = bad | ~torch.isfinite(cache.to(torch.float32)).all()
    return bad.to(torch.float32)


def clear_health(tel: Telemetry) -> Telemetry:
    """Reset the health guards (sticky flag + acceptance window) — call
    after a rollback so the pre-rollback incident doesn't re-trigger."""
    return tel._replace(bad_state=torch.zeros_like(tel.bad_state),
                        win_prop=torch.zeros_like(tel.win_prop),
                        win_acc=torch.zeros_like(tel.win_acc))


def health_report(tel: Telemetry, exact_accept: bool = False) -> dict:
    """ONE host read of the health guards (supervisor boundary).

    ``win_acceptance`` is the exponentially windowed per-update acceptance
    (1.0 for exact-accept samplers and before any window accumulates)."""
    bad = bool(_np(tel.bad_state) > 0.0)
    wp = float(_np(tel.win_prop))
    if exact_accept or wp <= 0.0:
        win = 1.0
    else:
        win = float(_np(tel.win_acc)) / wp
    return {"bad_state": bad, "win_acceptance": win}


# ---------------------------------------------------------------------------
# The carry as numpy arrays, in the JAX package's layout
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def telemetry_to_numpy(tel: Telemetry) -> Dict[str, np.ndarray]:
    """The carry as a dict of float32 numpy arrays keyed by
    ``TELEMETRY_FIELDS``, in the JAX package's layout: ``prev`` is (K, C, n)
    with ``prev[k-1] = x_{t-k}``.  One host read."""
    K = _lags(tel)
    out = {f: _np(getattr(tel, f)) for f in TELEMETRY_FIELDS if f != "prev"}
    out["prev"] = _np(tel.prev[tel.head:tel.head + K])
    return {f: out[f] for f in TELEMETRY_FIELDS}


def telemetry_from_numpy(fields: Any, device=None) -> Telemetry:
    """A carry from numpy arrays in the JAX package's layout: a mapping
    keyed by ``TELEMETRY_FIELDS`` or an object with those attributes (the
    JAX ``Telemetry`` itself).  On ``device`` (the card unless told
    otherwise).  Reads ``samples`` and ``half_at`` on the host once, for
    the carry's host copies."""
    dev = resolve_device(device)
    get = (fields.__getitem__ if isinstance(fields, Mapping)
           else lambda f: getattr(fields, f))
    arr = {f: np.array(get(f), np.float32) for f in TELEMETRY_FIELDS}
    prev = arr.pop("prev")
    t = {f: torch.from_numpy(a).to(dev) for f, a in arr.items()}
    ring = torch.from_numpy(np.concatenate([prev, prev])).to(dev)
    return Telemetry(**t, prev=ring, head=0, count=int(arr["samples"]),
                     split=float(arr["half_at"]))


# ---------------------------------------------------------------------------
# Host-side summaries (numpy; call after the run)
# ---------------------------------------------------------------------------

def _f64(t: torch.Tensor) -> np.ndarray:
    return _np(t).astype(np.float64)


def _halves(tel: Telemetry):
    """(count, mean, m2) for each half, per (chain, site).

    The second half is accumulated directly; the first half is the full-run
    accumulator minus the second, via Chan's pairwise-combine formula
    inverted:  M2_a = M2 - M2_b - (n_a n_b / n) (mean_a - mean_b)^2.
    """
    n = float(_np(tel.samples))
    n_b = float(_np(tel.samples_h))
    n_a = n - n_b
    mean, m2 = _f64(tel.mean), _f64(tel.m2)
    mean_b, m2_b = _f64(tel.mean_h), _f64(tel.m2_h)
    if n_b <= 1.0 or n_a <= 1.0:
        return None
    mean_a = (n * mean - n_b * mean_b) / n_a
    m2_a = m2 - m2_b - (n_a * n_b / n) * (mean_a - mean_b) ** 2
    m2_a = np.maximum(m2_a, 0.0)
    return (n_a, mean_a, m2_a), (n_b, mean_b, m2_b)


def split_rhat(tel: Telemetry) -> np.ndarray:
    """Per-site split-R-hat over the 2C half-chains ((n,) float64).

    Falls back to the plain multi-chain R-hat (C whole chains) when the
    split accumulator holds fewer than two snapshots.  Sites whose
    within-chain variance is zero everywhere report 1.0 (no evidence of
    disagreement — typically an unvisited or frozen site)."""
    halves = _halves(tel)
    if halves is None:
        cnt = float(_np(tel.samples))
        if cnt <= 1.0:
            return np.ones(tel.mean.shape[1])
        means = _f64(tel.mean)                             # (C, n)
        variances = _f64(tel.m2) / (cnt - 1.0)
    else:
        (n_a, mean_a, m2_a), (n_b, mean_b, m2_b) = halves
        cnt = min(n_a, n_b)
        means = np.concatenate([mean_a, mean_b], axis=0)  # (2C, n)
        variances = np.concatenate([m2_a / max(n_a - 1.0, 1.0),
                                    m2_b / max(n_b - 1.0, 1.0)], axis=0)
    W = variances.mean(axis=0)                            # within-chain
    B = cnt * means.var(axis=0, ddof=1)                   # between-chain
    var_plus = (cnt - 1.0) / cnt * W + B / cnt
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.sqrt(var_plus / W)
    return np.where(W > 0.0, r, 1.0)


def _lag1_stats(tel: Telemetry):
    """(count, pairs, per-(chain,site) variance, lag-1 autocovariance) as
    float64 numpy, or None with fewer than two snapshots / one lag-1 pair.
    The autocovariance is E[x_t x_{t-1}] - mean^2 with the full-run mean;
    shared by the ESS estimate and ``exact.empirical_spectral_gap``."""
    cnt = float(_np(tel.samples))
    cn = float(_np(tel.cross_n[0]))
    if cnt <= 1.0 or cn <= 0.0:
        return None
    mean = _f64(tel.mean)
    var = _f64(tel.m2) / (cnt - 1.0)
    cov1 = _f64(tel.cross[0]) / cn - mean ** 2
    return cnt, cn, var, cov1


def _rho_lags(tel: Telemetry):
    """Chain-site lag-k autocorrelations rho[k-1], k = 1..K, as (K, C, n)
    float64 (0 where the lag has no accumulated pairs), plus (cnt, var)."""
    cnt = float(_np(tel.samples))
    mean = _f64(tel.mean)
    var = _f64(tel.m2) / max(cnt - 1.0, 1.0)
    cn = _f64(tel.cross_n)                                # (K,)
    cov = (_f64(tel.cross) / np.maximum(cn, 1.0)[:, None, None]
           - mean[None] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.clip(cov / np.maximum(var, 1e-300)[None], -0.999, 0.999)
    rho = np.where((var[None] > 0.0) & (cn[:, None, None] > 0.0), rho, 0.0)
    return rho, cnt, var


def ess_per_site(tel: Telemetry) -> np.ndarray:
    """Per-site effective sample size summed over chains ((n,) float64).

    With K > 1 lags, Geyer's initial-sequence estimate: tau = -1 + 2 *
    sum_m Gamma_m over the pair sums Gamma_m = rho_{2m} + rho_{2m+1}
    (rho_0 = 1), truncated at the first non-positive Gamma_m; ESS = N / tau
    per chain.  With K = 1 the geometric AR(1) form N (1 - rho1)/(1 + rho1).
    Sites with zero variance (never moved) report 0."""
    C, n = tel.mean.shape
    K = _lags(tel)
    cnt = float(_np(tel.samples))
    if cnt <= 1.0 or float(_np(tel.cross_n[0])) <= 0.0:
        return np.zeros(n)
    rho, cnt, var = _rho_lags(tel)                        # (K, C, n)
    if K == 1:
        r1 = rho[0]
        ess = cnt * (1.0 - r1) / (1.0 + r1)
    else:
        # rho_0 = 1 prepended; odd tail zero-padded so lags pair up
        full = np.concatenate(
            [np.ones((1, C, n)), rho,
             np.zeros(((K + 1) % 2, C, n))], axis=0)      # even length
        gamma = full[0::2] + full[1::2]                   # (M, C, n)
        keep = np.cumprod(gamma > 0.0, axis=0)            # initial positive
        tau = np.maximum(-1.0 + 2.0 * (gamma * keep).sum(axis=0), 1e-3)
        ess = cnt / tau
    return np.where(var > 0.0, ess, 0.0).sum(axis=0)


def acceptance_rate(tel: Telemetry, exact_accept: bool = False) -> float:
    """Mean MH acceptance per site update (1.0 for exact-accept samplers)."""
    if exact_accept:
        return 1.0
    upd = float(_np(tel.updates))
    if upd <= 0.0:
        return float("nan")
    return float(_np(tel.accepts).mean() / upd)


def summarize(tel: Telemetry, exact_accept: bool = False,
              elapsed_sec: Optional[float] = None) -> dict:
    """Machine-readable summary (the JAX package's fields).
    ``elapsed_sec`` (optional wall time) adds ``ess_per_sec``."""
    r = split_rhat(tel)
    ess = ess_per_site(tel)
    prop = _f64(tel.site_prop)
    updates = float(_np(tel.updates))
    out = {
        "samples": int(_np(tel.samples)),
        "updates": int(updates),
        "mean_acceptance": acceptance_rate(tel, exact_accept),
        "max_split_rhat": float(r.max()),
        "mean_split_rhat": float(r.mean()),
        "ess_mean_site": float(ess.mean()),
        "ess_min_site": float(ess.min()),
        "flip_rate": float(_np(tel.site_flips).sum()
                           / max(updates * tel.mean.shape[0], 1.0)),
    }
    if prop.sum() > 0.0:                  # instrumented per-site counters
        acc = _f64(tel.site_acc)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_site = np.where(prop > 0, acc / np.maximum(prop, 1.0), np.nan)
        out["site_acceptance_min"] = float(np.nanmin(per_site))
        out["site_hit_cv"] = float(prop.std() / max(prop.mean(), 1e-12))
    if elapsed_sec is not None and elapsed_sec > 0.0:
        out["ess_per_sec"] = float(ess.mean() / elapsed_sec)
    return out
