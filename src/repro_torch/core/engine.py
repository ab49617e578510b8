"""The sampler Engine API of the port: one contract over the fused-sweep and
chromatic execution paths.

  engine = make("mgpmh", graph, sweep=64)            # on the card
  state  = engine.init(seed=0, n_chains=256)
  state  = engine.sweep(state)                       # always batched: x (C, n)

An :class:`Engine` carries explicit metadata — ``updates_per_call``,
``marginal_samples_per_call``, ``backend``, ``schedule`` — so consumers
never sniff attributes off bare functions.

Schedules decide *which sites* a call updates:
  * :class:`UniformSites(S)` — S sequentially composed i.i.d.-uniform site
    updates per call (the paper's update loop, fused S at a time);
  * :class:`ChromaticBlocks(colors)` — one full sweep per call: each color
    class updated as a block through the fused Gibbs kernel.

The backend follows the device: ``"cuda"`` runs the hand-written kernels
(``kernels/csrc``), ``"torch"`` their plain PyTorch versions on the CPU.
``make`` runs on the card unless given ``device="cpu"``.

Engines: ``gibbs`` (uniform + chromatic), ``mgpmh``, ``min-gibbs``,
``doublemin`` and ``local-gibbs`` (uniform) — every engine of the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .factor_graph import (MatchGraph, make_ising_graph, make_potts_graph,
                           make_lattice_ising, lattice_colors,
                           make_pair_ising, pair_colors)
from .estimators import recommended_capacity
from . import samplers as S

__all__ = [
    "Engine", "Schedule", "UniformSites", "ChromaticBlocks",
    "make", "names", "backends", "register",
    "Workload", "WORKLOADS", "make_workload", "workload_names",
]

# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

class Schedule:
    """Site-selection policy of one ``sweep`` call."""

    def describe(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformSites(Schedule):
    """``sweep_len`` sequentially composed updates at i.i.d.-uniform sites
    per call — the paper's update loop, fused S at a time."""
    sweep_len: int = 1

    def __post_init__(self):
        if self.sweep_len < 1:
            raise ValueError(f"sweep_len must be >= 1, got {self.sweep_len}")

    def describe(self) -> str:
        return f"uniform-sites(S={self.sweep_len})"


@dataclasses.dataclass(frozen=True)
class ChromaticBlocks(Schedule):
    """One full chromatic sweep per call: every color class updated as a
    block through the fused sweep kernel (same-color sites share no factor,
    so the kernel's sequential loop IS the block update).  Exact for proper
    colorings (checked at engine build time)."""
    colors: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "colors",
                           tuple(int(c) for c in np.asarray(self.colors)))

    @property
    def colors_array(self) -> np.ndarray:
        return np.asarray(self.colors, np.int32)

    @property
    def n_colors(self) -> int:
        return max(self.colors) + 1

    def describe(self) -> str:
        return f"chromatic-blocks(k={self.n_colors}, n={len(self.colors)})"


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False, frozen=True)
class Engine:
    """A constructed sampler: ``init`` makes a batched state, ``sweep``
    advances it, metadata says how much work one call does.

    ``updates_per_call``          site updates one ``sweep`` call performs.
    ``marginal_samples_per_call`` snapshot samples one call contributes to a
                                  running marginal estimate.
    ``backend``                   'cuda' (the kernels) | 'torch' (the plain
                                  versions, on the CPU).
    ``exact_accept``              True for Gibbs-type engines whose every
                                  update is accepted by construction.
    ``cache_init``                ``state -> state`` that seeds the
                                  augmented-energy cache (MIN-Gibbs,
                                  DoubleMIN) from ``state.gen``; run by
                                  ``init``.
    """
    name: str
    backend: str
    device: torch.device
    schedule: Schedule
    updates_per_call: int
    marginal_samples_per_call: int
    graph: MatchGraph
    params: Dict[str, Any] = dataclasses.field(repr=False)
    sweep_fn: Callable = dataclasses.field(repr=False)
    exact_accept: bool = False
    cache_init: Optional[Callable] = dataclasses.field(default=None,
                                                       repr=False)

    def init(self, seed, n_chains: int, *, start: str = "constant"):
        """Batched initial state for ``n_chains`` chains.  ``seed`` is an
        int (seeds a new generator on the engine's device) or a
        ``torch.Generator`` on that device, which the state then owns.
        Engines with a cache seed it with one estimator draw per chain,
        from the same generator, after the start state is drawn."""
        if isinstance(seed, torch.Generator):
            gen = seed
            if gen.device.type != self.device.type:
                raise ValueError(f"generator is on {gen.device}, engine on "
                                 f"{self.device}")
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        state = S.init_state(gen, self.graph, n_chains, start=start)
        if self.cache_init is not None:
            state = self.cache_init(state)
        return state

    def sweep(self, state):
        """Advance every chain by ``updates_per_call`` site updates."""
        return self.sweep_fn(state)

    def describe(self) -> Dict[str, Any]:
        """Machine-readable identity."""
        return {"engine": self.name, "backend": self.backend,
                "device": str(self.device),
                "schedule": self.schedule.describe(),
                "updates_per_call": self.updates_per_call}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_BUILDERS: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}


def register(name: str, *, backends: Tuple[str, ...]):
    """Register an engine builder under ``name``.  The builder is called as
    ``builder(graph, schedule=..., backend=..., **params)`` with the graph
    already on the engine's device."""
    def deco(builder):
        _BUILDERS[name] = (builder, tuple(backends))
        return builder
    return deco


def names() -> Tuple[str, ...]:
    """Registered engine names."""
    return tuple(sorted(_BUILDERS))


def backends(name: str) -> Tuple[str, ...]:
    """Backends supported by engine ``name``."""
    return _BUILDERS[name][1]


def make(name: str, graph: MatchGraph, *, sweep: Optional[int] = None,
         schedule: Optional[Schedule] = None, device=None,
         **params) -> Engine:
    """Build an :class:`Engine` by registry name.

    ``sweep=S`` is shorthand for ``schedule=UniformSites(S)``; pass a
    :class:`Schedule` for anything else (:class:`ChromaticBlocks`, gibbs
    only).  ``device`` defaults to the card and raises without one; the
    graph is moved there.  Algorithm parameters (lam, capacity) are keyword
    ``params`` with paper-recipe defaults.
    """
    if name not in _BUILDERS:
        raise KeyError(f"unknown engine {name!r}; available: {list(names())}")
    builder, supported = _BUILDERS[name]
    if schedule is None:
        schedule = UniformSites(sweep if sweep is not None else 1)
    elif sweep is not None:
        raise ValueError("pass either sweep= or schedule=, not both")
    if not isinstance(schedule, Schedule):
        raise TypeError(f"schedule must be a Schedule, got {schedule!r}")
    if not isinstance(schedule, (UniformSites, ChromaticBlocks)):
        raise NotImplementedError(
            f"schedule {schedule.describe()} is not ported to repro_torch "
            f"yet; ported: UniformSites, ChromaticBlocks")
    device = resolve_device(device)
    backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in supported:
        raise ValueError(f"engine {name!r} supports backends {supported}, "
                         f"got {backend!r} (device {device})")
    return builder(graph.to(device), schedule=schedule, backend=backend,
                   **params)


def _engine(name, backend, schedule, upd, graph, params, sweep_fn,
            exact_accept=False, cache_init=None):
    return Engine(name=name, backend=backend, device=graph.device,
                  schedule=schedule, updates_per_call=upd,
                  marginal_samples_per_call=1, graph=graph, params=params,
                  sweep_fn=sweep_fn, exact_accept=exact_accept,
                  cache_init=cache_init)


def _reject_unknown(name, params):
    if params:
        raise TypeError(f"engine {name!r} got unknown params "
                        f"{sorted(params)}")


@register("gibbs", backends=("torch", "cuda"))
def _gibbs_builder(graph, *, schedule, backend, **params):
    _reject_unknown("gibbs", params)
    if isinstance(schedule, ChromaticBlocks):
        sweep_fn = S._build_chromatic_gibbs_sweep(graph,
                                                  schedule.colors_array)
        upd = graph.n
    else:
        sweep_fn = S._build_gibbs_sweep(graph, schedule.sweep_len)
        upd = schedule.sweep_len
    return _engine("gibbs", backend, schedule, upd, graph, {}, sweep_fn,
                   exact_accept=True)


def _require_uniform(name, schedule):
    if not isinstance(schedule, UniformSites):
        raise ValueError(f"engine {name!r} supports only the UniformSites "
                         f"schedule, got {schedule.describe()}")


def _global_lam(graph) -> float:
    """Default global-minibatch size: the paper's 2 Psi^2, capped at 16384
    as the JAX package caps it (the host-drawn streams are
    O(C*S*D*capacity))."""
    return float(min(2.0 * graph.psi ** 2, 16384.0))


@register("mgpmh", backends=("torch", "cuda"))
def _mgpmh_builder(graph, *, schedule, backend, lam=None, capacity=None,
                   **params):
    _reject_unknown("mgpmh", params)
    _require_uniform("mgpmh", schedule)
    lam = float(4.0 * graph.L ** 2) if lam is None else float(lam)
    capacity = recommended_capacity(lam) if capacity is None else capacity
    sweep_fn = S._build_mgpmh_sweep(graph, lam, capacity, schedule.sweep_len)
    return _engine("mgpmh", backend, schedule, schedule.sweep_len, graph,
                   dict(lam=lam, capacity=capacity), sweep_fn)


@register("min-gibbs", backends=("torch", "cuda"))
def _min_gibbs_builder(graph, *, schedule, backend, lam=None, capacity=None,
                       **params):
    _reject_unknown("min-gibbs", params)
    _require_uniform("min-gibbs", schedule)
    lam = _global_lam(graph) if lam is None else float(lam)
    capacity = recommended_capacity(lam) if capacity is None else capacity
    sweep_fn = S._build_min_gibbs_sweep(graph, lam, capacity,
                                        schedule.sweep_len)
    cache_init = lambda st: S.init_min_gibbs_cache(st.gen, graph, st, lam,
                                                   capacity)
    return _engine("min-gibbs", backend, schedule, schedule.sweep_len, graph,
                   dict(lam=lam, capacity=capacity), sweep_fn,
                   exact_accept=True, cache_init=cache_init)


@register("doublemin", backends=("torch", "cuda"))
def _doublemin_builder(graph, *, schedule, backend, lam1=None,
                       capacity1=None, lam2=None, capacity2=None, **params):
    _reject_unknown("doublemin", params)
    _require_uniform("doublemin", schedule)
    lam1 = float(4.0 * graph.L ** 2) if lam1 is None else float(lam1)
    lam2 = _global_lam(graph) if lam2 is None else float(lam2)
    capacity1 = recommended_capacity(lam1) if capacity1 is None else capacity1
    capacity2 = recommended_capacity(lam2) if capacity2 is None else capacity2
    sweep_fn = S._build_double_min_sweep(graph, lam1, capacity1, lam2,
                                         capacity2, schedule.sweep_len)
    cache_init = lambda st: S.init_double_min_cache(st.gen, graph, st, lam2,
                                                    capacity2)
    return _engine("doublemin", backend, schedule, schedule.sweep_len, graph,
                   dict(lam1=lam1, capacity1=capacity1, lam2=lam2,
                        capacity2=capacity2), sweep_fn, cache_init=cache_init)


@register("local-gibbs", backends=("torch", "cuda"))
def _local_gibbs_builder(graph, *, schedule, backend, batch_size=None,
                         **params):
    """Algorithm 3, S sub-steps per call in one fused launch
    (``S._build_local_gibbs_sweep``): the subsets (Floyd's algorithm) and
    the Gumbels are drawn from Philox in the call, in-kernel on the card and
    by the plain version on the CPU.  The JAX package scans S single-site
    steps instead; the two agree in distribution."""
    _reject_unknown("local-gibbs", params)
    _require_uniform("local-gibbs", schedule)
    batch_size = min(32, graph.n - 1) if batch_size is None else batch_size
    return _engine("local-gibbs", backend, schedule, schedule.sweep_len,
                   graph, dict(batch_size=batch_size),
                   S._build_local_gibbs_sweep(graph, batch_size,
                                              schedule.sweep_len),
                   exact_accept=True)


# ---------------------------------------------------------------------------
# Workload registry (the paper's experimental models + chromatic lattice)
# ---------------------------------------------------------------------------

WORKLOADS: Dict[str, Dict[str, Any]] = {
    "ising-20x20":        dict(kind="ising", grid=20, beta=1.0, D=2),
    "potts-20x20":        dict(kind="potts", grid=20, beta=4.6, D=10),
    "ising-128x128":      dict(kind="ising", grid=128, beta=1.0, D=2),
    "potts-64x64":        dict(kind="potts", grid=64, beta=4.6, D=10),
    # sparse nearest-neighbor lattice: the chromatic workload
    "lattice-ising-64x64": dict(kind="lattice", grid=64, beta=0.4, D=2),
    # heterogeneous pair-Ising: uniform exact marginals, strongly bimodal
    # site mixing times
    "hetero-pairs-24":   dict(kind="pairs", n_strong=2, n_weak=10,
                              w_strong=3.5, w_weak=0.25),
    "hetero-pairs-1024": dict(kind="pairs", n_strong=64, n_weak=448,
                              w_strong=3.5, w_weak=0.25),
}


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named graph (plus its coloring when the graph is colorable, so
    ``ChromaticBlocks(workload.colors)`` is one line away)."""
    name: str
    graph: MatchGraph
    colors: Optional[np.ndarray] = None


def workload_names() -> Tuple[str, ...]:
    return tuple(sorted(WORKLOADS))


def make_workload(name: str, device=None) -> Workload:
    """Build a registered workload by name, on ``device`` (the card unless
    told otherwise)."""
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; available: "
                       f"{list(workload_names())}")
    c = WORKLOADS[name]
    if c["kind"] == "ising":
        return Workload(name, make_ising_graph(c["grid"], c["beta"],
                                               device=device))
    if c["kind"] == "potts":
        return Workload(name, make_potts_graph(c["grid"], c["beta"], c["D"],
                                               device=device))
    if c["kind"] == "lattice":
        return Workload(name, make_lattice_ising(c["grid"], c["beta"],
                                                 device=device),
                        colors=lattice_colors(c["grid"]))
    if c["kind"] == "pairs":
        n_pairs = c["n_strong"] + c["n_weak"]
        return Workload(name, make_pair_ising(c["n_strong"], c["n_weak"],
                                              c["w_strong"], c["w_weak"],
                                              device=device),
                        colors=pair_colors(n_pairs))
    raise ValueError(f"unknown workload kind {c['kind']!r}")
