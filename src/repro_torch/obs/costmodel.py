"""Analytic per-sweep-call FLOP and byte models for the sweep engines.

A copy of the JAX package's ``obs/costmodel.py`` (pure Python): the same
engine name and shape give the same numbers.

These are *documented approximations*, not measurements: roofline plots
and the ``sweep_flops_per_call`` / ``sweep_bytes_per_call`` gauges need
an algorithm-level work estimate that is stable across backends, and
the dominant terms below are exact up to small constant factors.

Conventions (one ``Engine.sweep`` call, C chains, n sites, domain D,
S fused updates per call):

* **gibbs** — each update scans the full conditional: n neighbor weights
  × D candidate values, one multiply-add each → ``2·C·S·n·D`` flops.
  Bytes: the W row (n·4) plus the state vector (n·4) per update, per
  chain (the x rewrite is the same order).
* **mgpmh** — per update: λ local minibatch draws (alias lookup + bucket
  scatter, ~4 flops each) + the D-bucket proposal/MH correction
  (~8 flops per value) → ``C·S·(4λ + 8D)``.  Bytes: alias rows touch
  2 entries each (8 B) plus the per-value buckets (D·4).
* **min-gibbs** — λ draws feed a D-value candidate count tensor, then an
  exact D-way Gibbs step over the estimated conditional:
  ``C·S·(4λ + 8D)``; same traffic shape as mgpmh.
* **doublemin** — two staged estimates (λ1 then λ2) plus the D-way step:
  ``C·S·(4·(λ1+λ2) + 8D)``.
* **chromatic** — one call sweeps every site once through the fused
  kernel: equivalent to gibbs with S=n → ``2·C·n·n·D`` flops (the
  per-color masking does not change the dominant term).

Distributed backends do the same arithmetic sharded; their *extra*
cost is the collective payload, which both packages account separately
via ``runtime/dist_gibbs.psum_footprint`` (the ``psum_payload_bytes`` and
``collectives_per_sweep`` gauges, 0 off the dist backend), not folded in
here.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["sweep_cost"]

_F32 = 4  # bytes


def _base(algo: str) -> str:
    # registry names sometimes carry a suffix (e.g. "local-gibbs")
    for known in ("doublemin", "min-gibbs", "mgpmh", "chromatic", "gibbs"):
        if known in algo:
            return known
    return algo


def sweep_cost(algo: str, *, chains: int, n: int, D: int, sweep: int,
               params: Dict = None) -> Dict[str, float]:
    """Approximate ``{"flops_per_call", "bytes_per_call"}`` for one
    ``Engine.sweep`` call.  Unknown algorithms get the dense-gibbs model
    (the conservative upper bound)."""
    params = params or {}
    C, S = float(chains), float(sweep)
    base = _base(algo)
    lam = float(params.get("lam", 0.0))
    lam2 = float(params.get("lam2", 0.0))

    if base == "mgpmh" or base == "min-gibbs":
        flops = C * S * (4.0 * lam + 8.0 * D)
        bytes_ = C * S * (lam * 2 * _F32 + D * _F32 + 2 * _F32)
    elif base == "doublemin":
        lam1 = float(params.get("lam", params.get("lam1", 0.0)))
        flops = C * S * (4.0 * (lam1 + lam2) + 8.0 * D)
        bytes_ = C * S * ((lam1 + lam2) * 2 * _F32 + D * _F32 + 2 * _F32)
    elif base == "chromatic":
        flops = 2.0 * C * n * n * D
        bytes_ = C * n * (2 * n * _F32)
    else:  # gibbs and anything unrecognized
        flops = 2.0 * C * S * n * D
        bytes_ = C * S * (2 * n * _F32)
    return {"flops_per_call": flops, "bytes_per_call": bytes_}
