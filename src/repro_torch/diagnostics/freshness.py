"""Telemetry-gated freshness: is this chain mixed enough to serve?  A copy
of the JAX package's ``diagnostics/freshness.py`` over the port's carry.

The serving layer answers marginal queries from a resident chain's running
snapshot average; an answer taken before the chain has mixed is silently
biased toward the init.  A :class:`FreshnessPolicy` of split-R-hat and ESS
thresholds, evaluated host-side over exactly the sites a query can ask
about, turns the streaming
:class:`~repro_torch.diagnostics.telemetry.Telemetry` carry into a
serve/refuse gate.

Evidence interaction: clamped sites never move, so their within-chain
variance is zero — split-R-hat degenerates to 1.0 (vacuously converged)
but ESS reports 0, which would keep a conditioned lane stale forever.
Callers therefore pass ``site_mask`` selecting the UNOBSERVED sites; the
gate only inspects coordinates the conditional chain actually samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from .telemetry import Telemetry, ess_per_site, health_report, split_rhat

__all__ = ["FreshnessPolicy", "freshness_report", "fresh"]


@dataclasses.dataclass(frozen=True)
class FreshnessPolicy:
    """Serve/refuse thresholds over the streaming telemetry.

    ``max_rhat``: worst acceptable per-site split-R-hat (1.0 = perfect
    mixing; 1.1 is the classic screening bound).  ``min_ess_per_site``:
    smallest acceptable per-site effective sample size summed over chains.
    ``min_samples``: snapshots the telemetry must hold before R-hat/ESS are
    even looked at (both are noise on a handful of snapshots).
    """
    max_rhat: float = 1.1
    min_ess_per_site: float = 64.0
    min_samples: int = 16

    def __post_init__(self):
        if not self.max_rhat >= 1.0:
            raise ValueError(f"max_rhat must be >= 1, got {self.max_rhat}")
        if self.min_ess_per_site < 0.0 or self.min_samples < 0:
            raise ValueError("thresholds must be non-negative")


def freshness_report(tel: Telemetry, policy: FreshnessPolicy, *,
                     site_mask: Optional[np.ndarray] = None,
                     include_health: bool = False,
                     exact_accept: bool = False) -> Dict[str, Any]:
    """Evaluate ``policy`` against the telemetry (host reads of the carry).

    ``site_mask``: optional (n,) boolean — True at sites the gate should
    inspect (the complement of the evidence mask).  Returns a JSON-safe
    dict: ``fresh`` (bool), ``reason`` (None when fresh, else which
    threshold failed), ``samples``, and the measured ``max_rhat`` /
    ``min_ess`` over the inspected sites (None before ``min_samples``).

    ``include_health=True`` also folds in the health guards
    (:func:`~.telemetry.health_report`); a latched ``bad_state`` forces
    ``fresh=False``.
    """
    samples = int(tel.samples.cpu())
    out: Dict[str, Any] = {"fresh": False, "reason": None,
                           "samples": samples, "max_rhat": None,
                           "min_ess": None}
    if include_health:
        out.update(health_report(tel, exact_accept=exact_accept))
        if out["bad_state"]:
            out["reason"] = "bad_state latched (degenerate chain state)"
            return out
    if samples < policy.min_samples:
        out["reason"] = (f"samples {samples} < min_samples "
                         f"{policy.min_samples}")
        return out
    r = split_rhat(tel)
    ess = ess_per_site(tel)
    if site_mask is not None:
        site_mask = np.asarray(site_mask, bool)
        if site_mask.shape != r.shape:
            raise ValueError(f"site_mask shape {site_mask.shape} != "
                             f"(n,) = {r.shape}")
        if not site_mask.any():     # every site observed: nothing to mix
            out["fresh"] = True
            return out
        r, ess = r[site_mask], ess[site_mask]
    out["max_rhat"] = float(np.max(r))
    out["min_ess"] = float(np.min(ess))
    if not np.all(np.isfinite(r)) or out["max_rhat"] > policy.max_rhat:
        out["reason"] = (f"split-rhat {out['max_rhat']:.4g} > "
                         f"{policy.max_rhat}")
        return out
    if out["min_ess"] < policy.min_ess_per_site:
        out["reason"] = (f"ess {out['min_ess']:.4g} < "
                         f"{policy.min_ess_per_site}")
        return out
    out["fresh"] = True
    return out


def fresh(tel: Telemetry, policy: FreshnessPolicy, *,
          site_mask: Optional[np.ndarray] = None) -> bool:
    """True when the telemetry passes every threshold of ``policy``."""
    return freshness_report(tel, policy, site_mask=site_mask)["fresh"]
