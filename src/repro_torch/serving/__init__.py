"""Marginal-inference serving: warm resident chains answering live queries
(the JAX package's ``serving`` on the port).

The paper's cheap single-site updates make it viable to keep hot Markov
chains resident on large graphical models and amortize their sweeps across
many concurrent queries — this package is that serving surface:

  * :mod:`.query` — the :class:`Query` / :class:`Answer` request types
    (per-request evidence, marginal or MAP, deadlines/priorities in,
    freshness + staleness + degradation rung back), copied;
  * :mod:`.pool` — :class:`ChainPool`, the warm pool: one Engine + ONE
    sweep chunk per workload, evidence clamping as data (the same kernels
    and launches for clamped and unclamped requests), telemetry-gated
    freshness, copy-on-publish snapshots read on a side stream;
  * :mod:`.resilience` — the serving-resilience policies: bounded
    admission control, per-lane circuit breakers over the committed-chunk
    health guards, the graceful-degradation ladder bounds, and the
    supervised background driver, copied.

The request front is ``repro_torch.launch.serve`` (batched submission,
workload routing, SupervisedRun-wrapped drivers for crash-resume).
"""
from .query import Query, Answer
from .pool import ChainPool, PoolWorkload
from .resilience import (AdmissionController, AdmissionPolicy,
                         BreakerPolicy, CircuitBreaker, DegradePolicy,
                         SupervisedDriver)

__all__ = ["Query", "Answer", "ChainPool", "PoolWorkload",
           "AdmissionController", "AdmissionPolicy", "BreakerPolicy",
           "CircuitBreaker", "DegradePolicy", "SupervisedDriver"]
