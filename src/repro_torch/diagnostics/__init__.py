"""Convergence diagnostics of the port (the JAX package's
``diagnostics``):

  * :mod:`.telemetry` — the streaming ``Telemetry`` carry ``Engine.sweep``
    threads on the device (Welford moments, split-R-hat / ESS inputs,
    per-site counters, health guards) and its host-side summaries;
  * :mod:`.adaptive` — the ``AdaptiveScan`` engine machinery (telemetry ->
    non-uniform site-selection tables) and the lambda auto-tuner;
  * :mod:`.exact` — exact references on enumerable graphs (marginals,
    evidence-clamped conditionals, spectral gaps) and the telemetry's
    empirical spectral gap;
  * :mod:`.freshness` — the serving layer's telemetry-gated serve/refuse
    predicate.

Only :mod:`.telemetry` (no ``repro_torch.core`` imports) loads eagerly;
the rest resolve lazily, so ``repro_torch.core`` can import the telemetry
types without an import cycle.
"""
from .telemetry import (Telemetry, SweepStats, SiteDraws, telemetry_init,
                        telemetry_update, telemetry_update_plain,
                        telemetry_from_numpy,
                        telemetry_to_numpy, split_rhat, ess_per_site,
                        acceptance_rate, summarize, state_health,
                        health_report, clear_health)

__all__ = [
    "Telemetry", "SweepStats", "SiteDraws", "telemetry_init",
    "telemetry_update", "telemetry_update_plain", "telemetry_from_numpy",
    "telemetry_to_numpy",
    "split_rhat", "ess_per_site", "acceptance_rate", "summarize",
    "state_health", "health_report", "clear_health",
    # lazy (see __getattr__): adaptive control + exact references
    "AdaptiveScan", "AdaptiveState", "make_adaptive_engine",
    "refresh_cdf", "run_with_telemetry", "autotune_lambda",
    "exact_marginals", "exact_conditional_marginals", "tv_to_exact",
    "exact_gibbs_gap", "empirical_spectral_gap",
    "FreshnessPolicy", "freshness_report", "fresh",
]

_LAZY = {
    "AdaptiveScan": "adaptive", "AdaptiveState": "adaptive",
    "make_adaptive_engine": "adaptive", "refresh_cdf": "adaptive",
    "run_with_telemetry": "adaptive", "autotune_lambda": "adaptive",
    "exact_marginals": "exact", "exact_conditional_marginals": "exact",
    "tv_to_exact": "exact",
    "exact_gibbs_gap": "exact", "empirical_spectral_gap": "exact",
    "FreshnessPolicy": "freshness", "freshness_report": "freshness",
    "fresh": "freshness",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
