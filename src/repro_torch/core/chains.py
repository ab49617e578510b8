"""Multi-chain execution and the paper's convergence diagnostic.

The paper evaluates convergence by the running average of per-variable
marginals against the fully-mixed (uniform) marginal: the "average
l2-distance error in the estimated marginals" (Figs 1-2).
`run_marginal_experiment` reproduces that trajectory for any
:class:`~repro_torch.core.engine.Engine`.  The (C, n, D) marginal sums, the
snapshot errors and the optional telemetry carry stay on the engine's
device: the run makes no host sync (it runs under
``torch.cuda.set_sync_debug_mode("error")``); the caller reads what it
needs after it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .engine import Engine
from .factor_graph import MatchGraph
from .samplers import ChainState

__all__ = ["MarginalTrace", "init_chains", "run_marginal_experiment",
           "marginal_error", "accumulate_marginals"]


class MarginalTrace(NamedTuple):
    iters: torch.Tensor  # (snapshots,) site updates at the snapshot points
    error: torch.Tensor  # (snapshots,) mean-over-chains marginal error (l2
    #                      to uniform, or TV to ``ref_marginals``)
    final: Any           # final batched ChainState
    marg: torch.Tensor   # (C, n, D) final one-hot sums (marginal estimate =
    #                      marg / (iters[-1] / updates_per_call))
    telemetry: Any = None  # Telemetry carry when telemetry=True


def init_chains(gen: torch.Generator, graph: MatchGraph, n_chains: int,
                init_fn: Callable[[torch.Generator, MatchGraph], ChainState]
                ) -> ChainState:
    """Batched chain init from a single-chain ``init_fn`` (prefer
    ``Engine.init``, which also seeds estimator caches).

    The reference vmaps ``init_fn`` over ``n_chains`` split keys; here
    ``init_fn(gen, graph)`` is called ``n_chains`` times with the one
    explicit generator, each call drawing the next values of its stream,
    and returns a state of one chain (``x`` (1, n) or (n,), ``cache`` and
    ``accepts`` of one entry).  The chains are stacked in call order into
    ``Engine.init``'s layout: x (C, n) int32, cache (C,) float32, accepts
    (C,) int32, the state owning ``gen``."""
    parts = [init_fn(gen, graph) for _ in range(n_chains)]
    return ChainState(
        x=torch.cat([p.x.reshape(1, graph.n) for p in parts]),
        cache=torch.cat([p.cache.reshape(1) for p in parts]),
        gen=gen,
        accepts=torch.cat([p.accepts.reshape(1) for p in parts]))


def marginal_error(marg_sum: torch.Tensor, count) -> torch.Tensor:
    """Average l2 distance between estimated marginals and uniform.

    marg_sum: (..., n, D) one-hot sums over iterations; count: scalar.
    Returns (...,) error averaged over variables.
    """
    D = marg_sum.shape[-1]
    p = marg_sum / count
    return torch.sqrt(torch.sum((p - 1.0 / D) ** 2, dim=-1)).mean(dim=-1)


def accumulate_marginals(marg: torch.Tensor, x: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """``marg[c, j, x[c, j]] += 1`` in place for every site value in
    [0, D), D = ``marg.shape[-1]``; a value outside [0, D) (a corrupt
    state, which the health guard reports) counts nowhere.  ``weight`` is
    a (C, n) float32 scratch buffer the caller keeps.  No host sync.

    Two elementwise passes before the scatter, as many as a conversion of
    ``x`` to int64 and a scatter of ones took: the clamp, which keeps
    ``x``'s dtype (``scatter_add_`` takes an int32 index), and the mask."""
    idx = x.clamp(0, marg.shape[-1] - 1)
    torch.eq(idx, x, out=weight)
    return marg.scatter_add_(2, idx.unsqueeze(-1), weight.unsqueeze(-1))


def run_marginal_experiment(engine: Engine, state, *, n_iters: int,
                            n_snapshots: int, D: int | None = None,
                            telemetry: bool = False, ref_marginals=None,
                            site_reduce: str = "mean") -> MarginalTrace:
    """Run ``n_iters`` site updates over C chains, collecting the
    marginal-error trajectory at ``n_snapshots`` evenly spaced points.

    One ``sweep`` call advances ``updates_per_call`` site updates and
    contributes one marginal sample.  ``n_iters`` is rounded DOWN to a whole
    number of sweep calls per snapshot; ``iters`` reports the updates that
    ran.  ``error`` stays on the device.  ``telemetry=True`` threads a
    streaming :class:`~repro_torch.diagnostics.telemetry.Telemetry` carry
    through the run (split-halved at the middle snapshot, so split-R-hat
    is exact) and returns it in ``trace.telemetry``.  ``ref_marginals``
    ((n, D); pass a tensor on the engine's device to keep the run free of
    host copies) switches ``error`` from the paper's l2-to-uniform proxy
    to the total-variation distance to those marginals, aggregated over
    sites by ``site_reduce`` ("mean" or "max").
    """
    if not isinstance(engine, Engine):
        raise TypeError(
            f"run_marginal_experiment requires an Engine (got "
            f"{type(engine).__name__}); build one with "
            f"repro_torch.core.engine.make(name, graph, sweep=S)")
    if site_reduce not in ("mean", "max"):
        raise ValueError(f"site_reduce must be 'mean' or 'max', got "
                         f"{site_reduce!r}")
    D = engine.graph.D if D is None else D
    updates = engine.updates_per_call
    calls = n_iters // (n_snapshots * updates)   # sweep calls per snapshot
    if calls == 0:
        raise ValueError(
            f"n_iters={n_iters} must cover at least one sweep call per "
            f"snapshot: n_snapshots={n_snapshots} x updates_per_call="
            f"{updates}")
    if engine.marginal_samples_per_call != 1:
        raise NotImplementedError(
            f"run_marginal_experiment accumulates one marginal sample per "
            f"sweep call; engine {engine.name!r} declares "
            f"marginal_samples_per_call={engine.marginal_samples_per_call}")
    C, n = state.x.shape
    dev = state.x.device
    ref = None if ref_marginals is None else torch.as_tensor(
        ref_marginals, dtype=torch.float32, device=dev)
    tel = (engine.init_telemetry(state, half_at=(n_snapshots * calls) // 2)
           if telemetry else None)
    marg = torch.zeros((C, n, D), dtype=torch.float32, device=dev)
    weight = torch.empty((C, n), dtype=torch.float32, device=dev)
    errors = []
    for k in range(n_snapshots):
        for _ in range(calls):
            if tel is None:
                state = engine.sweep(state)
            else:
                state, tel = engine.sweep(state, tel)
            accumulate_marginals(marg, state.x, weight)
        cnt = (k + 1.0) * calls                  # samples accumulated
        if ref is None:
            errors.append(marginal_error(marg, cnt).mean())
        else:
            tv = 0.5 * torch.abs(marg / cnt - ref).sum(-1)   # (C, n)
            per_site = tv.mean(dim=0)
            errors.append(per_site.max() if site_reduce == "max"
                          else per_site.mean())
    iters = (torch.arange(n_snapshots) + 1) * calls * updates
    return MarginalTrace(iters=iters, error=torch.stack(errors),
                         final=state, marg=marg, telemetry=tel)
