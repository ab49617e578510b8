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
    class updated as a block through the fused Gibbs kernel;
  * :class:`AdaptiveScan(S)` — S fused updates per call at sites drawn from
    a table learned from the sweep's own telemetry
    (``repro_torch.diagnostics.adaptive``).

The backend follows the device: ``"cuda"`` runs the hand-written kernels
(``kernels/csrc``), ``"torch"`` their plain PyTorch versions on the CPU.
``make`` runs on the card unless given ``device="cpu"``.  Given a
``mesh=`` (a ``DeviceMesh`` over ("data", "model"), ``launch/mesh.py``) it
builds the ``"dist"`` backend instead (``runtime/dist_gibbs.py``): the
graph column-sharded over "model", the chains over "data", one all-reduce
per sweep call, on the mesh's device.

Engines: ``gibbs`` (uniform + chromatic), ``mgpmh``, ``min-gibbs``,
``doublemin`` (these four also adaptive, and with evidence clamping) and
``local-gibbs`` (uniform) — every engine of the JAX package.  ``sweep``
threads a streaming :class:`~repro_torch.diagnostics.telemetry.Telemetry`
carry when given one, on the device with no host sync.
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
from .estimators import (draw_global_minibatch, min_gibbs_estimate,
                         recommended_capacity)
from . import samplers as S
from ..diagnostics.telemetry import telemetry_init, telemetry_update
from ..obs.recorder import annotate

__all__ = [
    "Engine", "Schedule", "UniformSites", "ChromaticBlocks", "AdaptiveScan",
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


@dataclasses.dataclass(frozen=True)
class AdaptiveScan(Schedule):
    """``sweep_len`` fused updates per call at sites drawn from a *learned*
    non-uniform distribution (gibbs / mgpmh / min-gibbs / doublemin).

    The selection table is driven by the per-site telemetry the sweep
    collects: sites that rarely change value per update ("sticky") are
    upweighted in proportion to their estimated persistence, equalizing
    *independent* samples per site instead of raw updates.  The cumulative
    table is refreshed every ``refresh_every`` sweeps (a host-side call
    counter decides; the refresh itself runs on the device, no host sync),
    mixed with ``uniform_mix`` of the uniform distribution so every site
    keeps positive probability — each inter-refresh segment is a valid
    random-scan chain with the target stationary distribution.
    ``smoothing`` regularizes the inverse-flip-rate weight.  Construction
    lives in ``repro_torch.diagnostics.adaptive``; ``make`` routes there.
    """
    sweep_len: int = 16
    refresh_every: int = 8
    uniform_mix: float = 0.25
    smoothing: float = 0.05

    def __post_init__(self):
        if self.sweep_len < 1 or self.refresh_every < 1:
            raise ValueError("sweep_len and refresh_every must be >= 1")
        if not (0.0 < self.uniform_mix <= 1.0):
            raise ValueError("uniform_mix must be in (0, 1] (a zero floor "
                             "can starve sites and break ergodicity)")

    def describe(self) -> str:
        return (f"adaptive-scan(S={self.sweep_len}, K={self.refresh_every}, "
                f"mix={self.uniform_mix})")


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
                                  versions, on the CPU) | 'dist' (sharded
                                  over ``mesh``).
    ``exact_accept``              True for Gibbs-type engines whose every
                                  update is accepted by construction.
    ``init_fn``                   ``(gen, n_chains, start=...) -> state``,
                                  run by ``init``.
    ``sweep_stats_fn``            the instrumented sweep, ``state ->
                                  (state, SiteDraws | SweepStats)``; None
                                  where the engine has none (local-gibbs,
                                  AdaptiveScan) — telemetry then counts
                                  state diffs only.
    ``supports_evidence``         True when the sweeps take ``evidence=``
                                  (the gibbs family; not local-gibbs).
    ``cache_init``                ``state -> state`` that seeds the
                                  augmented-energy cache (MIN-Gibbs,
                                  DoubleMIN) from ``state.gen`` at the
                                  current x; run by ``init`` and by
                                  ``clamp`` (the JAX package's
                                  ``refresh_cache_fn``).
    ``mesh``                      the dist backend's ``DeviceMesh``; None
                                  on the others.
    """
    name: str
    backend: str
    device: torch.device
    schedule: Schedule
    updates_per_call: int
    marginal_samples_per_call: int
    graph: MatchGraph
    params: Dict[str, Any] = dataclasses.field(repr=False)
    init_fn: Callable = dataclasses.field(repr=False)
    sweep_fn: Callable = dataclasses.field(repr=False)
    sweep_stats_fn: Optional[Callable] = dataclasses.field(default=None,
                                                           repr=False)
    exact_accept: bool = False
    supports_evidence: bool = False
    cache_init: Optional[Callable] = dataclasses.field(default=None,
                                                       repr=False)
    mesh: Any = dataclasses.field(default=None, repr=False)

    @property
    def refresh_cache_fn(self) -> Optional[Callable]:
        """Re-draws the cached energy estimate at the current x (the JAX
        package's field): ``cache_init``, which draws from ``state.gen``."""
        return self.cache_init

    def init(self, seed, n_chains: int, *, start: str = "constant"):
        """Batched initial state for ``n_chains`` chains.  ``seed`` is an
        int (seeds a new generator on the engine's device) or a
        ``torch.Generator`` on that device, which the state then owns.
        Engines with a cache seed it with one estimator draw per chain,
        from the same generator, after the start state is drawn.  A dist
        engine derives its rank's generators from the seed
        (``dist_gibbs.shard_seeds``) and holds this rank's chains only."""
        if isinstance(seed, torch.Generator):
            gen = seed
            if gen.device.type != self.device.type:
                raise ValueError(f"generator is on {gen.device}, engine on "
                                 f"{self.device}")
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return self.init_fn(gen, n_chains, start=start)

    def init_telemetry(self, state, half_at: Optional[int] = None,
                       lags: int = 8):
        """Zeroed :class:`~repro_torch.diagnostics.telemetry.Telemetry`
        sized for ``state``, on its device (``half_at=total_snapshots //
        2`` for split-R-hat; ``lags`` is the depth of the ESS ring)."""
        return telemetry_init(state.x, half_at=half_at, lags=lags)

    def sweep(self, state, telemetry=None, evidence=None):
        """Advance every chain by ``updates_per_call`` site updates.

        With ``telemetry=`` (a carry from :meth:`init_telemetry`) the call
        returns ``(state, telemetry)``: the streaming statistics are
        updated from the instrumented sweep where there is one and from
        state diffs otherwise, on the device with no host sync.  The carry
        passed in is CONSUMED (updated in place): rebind it.

        With ``evidence=`` (an ``(ev_mask (n,) float32, ev_vals (n,)
        int32)`` pair of tensors on the engine's device) the sweep samples
        the CONDITIONAL chain given ``x[i] = ev_vals[i]`` wherever
        ``ev_mask[i] == 1``: sites are drawn from the masked inverse-CDF
        (the chromatic schedule re-clamps after every color class instead).
        Evidence is data: an all-zero mask is the unconditional chain.  The
        state must already be clamped at the observed sites
        (:meth:`clamp`).  Raises for engines without ``supports_evidence``.

        A dist engine's state holds this rank's chains and columns; its
        running marginals (``state.marg``) are updated in place: rebind,
        don't reuse (``st = eng.sweep(st)``).
        """
        if evidence is not None and not self.supports_evidence:
            raise ValueError(
                f"engine {self.name!r} (schedule "
                f"{self.schedule.describe()}) does not support evidence "
                f"clamping; serve conditioned queries from a gibbs-family "
                f"engine")
        kw = {} if evidence is None else {"evidence": evidence}
        # profiler ranges (obs.annotate): free unless a profiler records
        with annotate(f"repro.sweep/{self.name}/{self.backend}"):
            if telemetry is None:
                return self.sweep_fn(state, **kw)
            if self.sweep_stats_fn is not None:
                new, stats = self.sweep_stats_fn(state, **kw)
            else:
                new, stats = self.sweep_fn(state, **kw), None
            # the state's cached energy and the site domain feed the health
            # guards riding the carry (bad_state flag, windowed acceptance)
            with annotate("repro.sweep/telemetry"):
                telemetry = telemetry_update(
                    telemetry, state.x, new.x, self.updates_per_call,
                    new.accepts - state.accepts, stats,
                    cache=getattr(new, "cache", None), n_values=self.graph.D)
            return new, telemetry

    def clamp(self, state, evidence):
        """Overwrite the observed sites of every chain with their evidence
        values and return the clamped state.

        ``evidence = (ev_mask (n,) float32, ev_vals (n,) int32)``; sites
        with ``ev_mask == 1`` are set to ``ev_vals``, the rest keep their
        current value.  For engines with a cached energy estimate (MIN-Gibbs
        eps, DoubleMIN xi) the cache is re-drawn at the clamped
        configuration by ``cache_init``, from ``state.gen`` (the JAX
        package draws it from a key): the old cache estimates the
        pre-clamp energy and would bias the first accepts.  Handles the
        AdaptiveScan state transparently.
        """
        ev_mask, ev_vals = evidence
        inner = getattr(state, "inner", None)
        st = state if inner is None else inner
        x = torch.where(ev_mask > 0.0, ev_vals.to(st.x.dtype), st.x)
        st = st._replace(x=x)
        if self.cache_init is not None:
            st = self.cache_init(st)
        return st if inner is None else state._replace(inner=st)

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
    already on the engine's device (and ``mesh=`` on the dist backend)."""
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
         schedule: Optional[Schedule] = None, device=None, mesh=None,
         **params) -> Engine:
    """Build an :class:`Engine` by registry name.

    ``sweep=S`` is shorthand for ``schedule=UniformSites(S)``; pass a
    :class:`Schedule` for anything else (:class:`ChromaticBlocks`, gibbs
    only; :class:`AdaptiveScan`, gibbs / mgpmh / min-gibbs / doublemin,
    whose state carries its own telemetry).  ``device`` defaults to the
    card and raises without one; the graph is moved there.  Algorithm
    parameters (lam, capacity) are keyword ``params`` with paper-recipe
    defaults.  ``mesh`` (a ``DeviceMesh`` with a "model" dimension) builds
    the dist backend on the mesh's device: gibbs, mgpmh, min-gibbs and
    doublemin on UniformSites and AdaptiveScan, gibbs on ChromaticBlocks.
    Its ``Engine.graph`` is a host copy of the graph; only this rank's
    shard of it goes to the device.
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
    if mesh is not None:
        if "dist" not in supported:
            raise _dist_unsupported(name, schedule)
        mesh_dev = _mesh_device(mesh)
        if device is not None and torch.device(device).type != mesh_dev.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type!r}")
        # the full graph stays on the host: the card holds this rank's
        # shard only
        return builder(graph.to("cpu"), schedule=schedule,
                       backend="dist", mesh=mesh, **params)
    device = resolve_device(device)
    backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in supported:
        raise ValueError(f"engine {name!r} supports backends {supported}, "
                         f"got {backend!r} (device {device})")
    return builder(graph.to(device), schedule=schedule, backend=backend,
                   **params)


def _mesh_device(mesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on: its current card
    on a ``cuda`` mesh."""
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _chain_init(graph, cache_init=None):
    """``init_fn`` of a plain ChainState: the start state, then the cache
    seeded from the same generator when the algorithm has one."""
    def init(gen, n_chains: int, *, start: str = "constant"):
        state = S.init_state(gen, graph, n_chains, start=start)
        return state if cache_init is None else cache_init(state)
    return init


def _engine(name, backend, schedule, upd, graph, params, sweep_fn,
            stats_fn=None, exact_accept=False, supports_evidence=False,
            cache_init=None):
    return Engine(name=name, backend=backend, device=graph.device,
                  schedule=schedule, updates_per_call=upd,
                  marginal_samples_per_call=1, graph=graph, params=params,
                  init_fn=_chain_init(graph, cache_init), sweep_fn=sweep_fn,
                  sweep_stats_fn=stats_fn, exact_accept=exact_accept,
                  supports_evidence=supports_evidence, cache_init=cache_init)


def _adaptive(name, graph, schedule, backend, build, params,
              exact_accept=False, cache_init=None):
    """The AdaptiveScan engine around ``build(True)``, the instrumented
    sweep at given sites (``repro_torch.diagnostics.adaptive``)."""
    from ..diagnostics.adaptive import make_adaptive_engine
    return make_adaptive_engine(
        name, graph, schedule, backend, core=build(True),
        chain_init=_chain_init(graph, cache_init), params=params,
        exact_accept=exact_accept, cache_init=cache_init)


def _reject_unknown(name, params):
    if params:
        raise TypeError(f"engine {name!r} got unknown params "
                        f"{sorted(params)}")


@register("gibbs", backends=("torch", "cuda", "dist"))
def _gibbs_builder(graph, *, schedule, backend, mesh=None, **params):
    _reject_unknown("gibbs", params)
    if backend == "dist":
        return _dist_engine("gibbs", graph, schedule, mesh, {})
    if isinstance(schedule, ChromaticBlocks):
        build = lambda cs: S._build_chromatic_gibbs_sweep(
            graph, schedule.colors_array, collect_stats=cs)
        upd = graph.n
    else:
        build = lambda cs: S._build_gibbs_sweep(graph, schedule.sweep_len,
                                                collect_stats=cs)
        upd = schedule.sweep_len
    if isinstance(schedule, AdaptiveScan):
        return _adaptive("gibbs", graph, schedule, backend, build, {},
                         exact_accept=True)
    return _engine("gibbs", backend, schedule, upd, graph, {}, build(False),
                   stats_fn=build(True), exact_accept=True,
                   supports_evidence=True)


def _require_uniform(name, schedule, adaptive: bool = False):
    """Refuse every schedule but UniformSites (and AdaptiveScan where the
    engine takes it)."""
    ok = (UniformSites, AdaptiveScan) if adaptive else (UniformSites,)
    if not isinstance(schedule, ok):
        names = " or ".join(k.__name__ for k in ok)
        raise ValueError(f"engine {name!r} supports only the {names} "
                         f"schedule, got {schedule.describe()}")


def _global_lam(graph) -> float:
    """Default global-minibatch size: the paper's 2 Psi^2, capped at 16384
    as the JAX package caps it (the host-drawn streams are
    O(C*S*D*capacity))."""
    return float(min(2.0 * graph.psi ** 2, 16384.0))


@register("mgpmh", backends=("torch", "cuda", "dist"))
def _mgpmh_builder(graph, *, schedule, backend, mesh=None, lam=None,
                   capacity=None, **params):
    _reject_unknown("mgpmh", params)
    lam = float(4.0 * graph.L ** 2) if lam is None else float(lam)
    if backend == "dist":
        return _dist_engine("mgpmh", graph, schedule, mesh,
                            dict(lam=lam, capacity=capacity))
    _require_uniform("mgpmh", schedule, adaptive=True)
    capacity = recommended_capacity(lam) if capacity is None else capacity
    build = lambda cs: S._build_mgpmh_sweep(graph, lam, capacity,
                                            schedule.sweep_len,
                                            collect_stats=cs)
    params = dict(lam=lam, capacity=capacity)
    if isinstance(schedule, AdaptiveScan):
        return _adaptive("mgpmh", graph, schedule, backend, build, params)
    return _engine("mgpmh", backend, schedule, schedule.sweep_len, graph,
                   params, build(False), stats_fn=build(True),
                   supports_evidence=True)


@register("min-gibbs", backends=("torch", "cuda", "dist"))
def _min_gibbs_builder(graph, *, schedule, backend, mesh=None, lam=None,
                       capacity=None, **params):
    _reject_unknown("min-gibbs", params)
    lam = _global_lam(graph) if lam is None else float(lam)
    if backend == "dist":
        return _dist_engine("min-gibbs", graph, schedule, mesh,
                            dict(lam=lam, capacity=capacity))
    _require_uniform("min-gibbs", schedule, adaptive=True)
    capacity = recommended_capacity(lam) if capacity is None else capacity
    build = lambda cs: S._build_min_gibbs_sweep(graph, lam, capacity,
                                                schedule.sweep_len,
                                                collect_stats=cs)
    cache_init = lambda st: S.init_min_gibbs_cache(st.gen, graph, st, lam,
                                                   capacity)
    params = dict(lam=lam, capacity=capacity)
    if isinstance(schedule, AdaptiveScan):
        return _adaptive("min-gibbs", graph, schedule, backend, build,
                         params, exact_accept=True, cache_init=cache_init)
    return _engine("min-gibbs", backend, schedule, schedule.sweep_len, graph,
                   params, build(False), stats_fn=build(True),
                   exact_accept=True, supports_evidence=True,
                   cache_init=cache_init)


@register("doublemin", backends=("torch", "cuda", "dist"))
def _doublemin_builder(graph, *, schedule, backend, mesh=None, lam1=None,
                       capacity1=None, lam2=None, capacity2=None, **params):
    _reject_unknown("doublemin", params)
    lam1 = float(4.0 * graph.L ** 2) if lam1 is None else float(lam1)
    lam2 = _global_lam(graph) if lam2 is None else float(lam2)
    if backend == "dist":
        return _dist_engine("doublemin", graph, schedule, mesh,
                            dict(lam1=lam1, capacity1=capacity1, lam2=lam2,
                                 capacity2=capacity2))
    _require_uniform("doublemin", schedule, adaptive=True)
    capacity1 = recommended_capacity(lam1) if capacity1 is None else capacity1
    capacity2 = recommended_capacity(lam2) if capacity2 is None else capacity2
    build = lambda cs: S._build_double_min_sweep(
        graph, lam1, capacity1, lam2, capacity2, schedule.sweep_len,
        collect_stats=cs)
    cache_init = lambda st: S.init_double_min_cache(st.gen, graph, st, lam2,
                                                    capacity2)
    params = dict(lam1=lam1, capacity1=capacity1, lam2=lam2,
                  capacity2=capacity2)
    if isinstance(schedule, AdaptiveScan):
        return _adaptive("doublemin", graph, schedule, backend, build,
                         params, cache_init=cache_init)
    return _engine("doublemin", backend, schedule, schedule.sweep_len, graph,
                   params, build(False), stats_fn=build(True),
                   supports_evidence=True, cache_init=cache_init)


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
# Distributed backend (torch.distributed over a (data, model) mesh)
# ---------------------------------------------------------------------------

def _dist_unsupported(name: str, schedule: Schedule) -> ValueError:
    """The ONE error the dist backend raises for an unsupported request,
    always naming the full supported (engine, schedule) table (the JAX
    package's message, word for word)."""
    return ValueError(
        f"backend='dist' supports (engine, schedule) combinations: "
        f"gibbs/mgpmh/min-gibbs/doublemin x UniformSites(S >= 1), "
        f"gibbs/mgpmh/min-gibbs/doublemin x AdaptiveScan, and "
        f"gibbs x ChromaticBlocks; got engine {name!r} with schedule "
        f"{schedule.describe()}")


def _dist_engine(name: str, graph: MatchGraph, schedule: Schedule, mesh,
                 params: Dict[str, Any]) -> Engine:
    """The ``runtime/dist_gibbs`` sweep template as an Engine: this rank's
    column shard of the graph over the mesh's "model" dimension, its data
    shard's chains, state and marginals in a ``DistState``
    (``DistAdaptiveState`` under AdaptiveScan).  One all-reduce per call
    on the uniform and adaptive schedules, one per color class on the
    chromatic one.  ``start='constant'`` only; no evidence clamping.
    ``graph`` is on the host and stays there: the device holds the shard's
    tables only."""
    from ..runtime import dist_gibbs as DG

    chromatic = isinstance(schedule, ChromaticBlocks)
    adaptive = isinstance(schedule, AdaptiveScan)
    if (name not in DG.DIST_ALGOS or (chromatic and name != "gibbs")
            or not (chromatic or adaptive
                    or isinstance(schedule, UniformSites))):
        raise _dist_unsupported(name, schedule)
    shard = DG.MeshShard.of(mesh)
    if graph.n % shard.mp:
        raise ValueError(f"graph.n={graph.n} must divide into "
                         f"mp={shard.mp} column shards")

    # shard only the tables this algorithm reads
    dev = _mesh_device(mesh)
    gs = DG.ShardedMatchGraph.from_graph(
        graph, shard.mp, shard.mp_index,
        row_tables=name in ("mgpmh", "doublemin"),
        pair_tables=name in ("min-gibbs", "doublemin"), device=dev)

    # paper-recipe defaults; capacities sized for the WORST shard's thinned
    # rate (shard ownership can be skewed: sizing for the uniform lam/mp
    # would truncate the hot shard's Poisson draws and bias the estimator)
    def cap_rows(lam, explicit):
        if explicit is not None:
            return explicit
        frac = gs.row_sum_max / graph.L
        return recommended_capacity(max(lam * frac, 1.0)) + 8

    def cap_pairs(lam, explicit):
        if explicit is not None:
            return explicit
        frac = gs.psi_loc_max / graph.psi
        return recommended_capacity(max(lam * frac, 1.0)) + 8

    def global_cache_fn(lam_g):
        # seed the cached eps / xi with one full-rate estimator draw per
        # chain (the estimator the per-shard thinned sum realizes), on the
        # host from the host graph, with a generator every model shard of
        # the data shard seeds alike: every model shard holds the same cache
        cap_full = recommended_capacity(lam_g)

        def cache_fn(gen, x):
            idx, B = draw_global_minibatch(gen, graph, lam_g, cap_full,
                                           (x.shape[0],))
            return min_gibbs_estimate(graph, x.cpu(), idx, B,
                                      lam_g).to(x.device)
        return cache_fn

    cache_fn = None
    if name == "gibbs":
        resolved, algo_params = {}, {}
    elif name in ("mgpmh", "min-gibbs"):
        lam = params["lam"]
        cap = (cap_rows if name == "mgpmh" else cap_pairs)(
            lam, params.get("capacity"))
        resolved = algo_params = dict(lam=lam, capacity=cap)
        if name == "min-gibbs":
            cache_fn = global_cache_fn(lam)
    else:  # doublemin
        lam1, lam2 = params["lam1"], params["lam2"]
        c1 = cap_rows(lam1, params.get("capacity1"))
        c2 = cap_pairs(lam2, params.get("capacity2"))
        resolved = dict(lam1=lam1, capacity1=c1, lam2=lam2, capacity2=c2)
        algo_params = dict(lam=lam1, capacity=c1, lam2=lam2, capacity2=c2)
        cache_fn = global_cache_fn(lam2)

    if chromatic:
        S.validate_coloring(graph, schedule.colors_array)
        step = DG.make_dist_chromatic_sweep(gs, schedule.colors_array, shard)
        upd = graph.n
    elif adaptive:
        step = DG.make_dist_adaptive_sweep(gs, name, schedule, shard,
                                           **algo_params)
        upd = schedule.sweep_len
    else:
        step = DG.make_dist_sweep(gs, name, schedule.sweep_len, shard,
                                  **algo_params)
        upd = schedule.sweep_len

    def init_fn(gen, n_chains: int, *, start: str = "constant"):
        if start != "constant":
            raise ValueError("dist engines support start='constant' only")
        return DG.dist_init_state(gen.initial_seed(), n_chains, gs, shard,
                                  cache_fn=cache_fn, adaptive=adaptive)

    return Engine(name=name, backend="dist", device=dev,
                  schedule=schedule, updates_per_call=upd,
                  marginal_samples_per_call=1, graph=graph, params=resolved,
                  init_fn=init_fn, sweep_fn=step,
                  exact_accept=name in ("gibbs", "min-gibbs"), mesh=mesh)


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
