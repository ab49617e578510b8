"""ChainPool: warm resident chains multiplexing live marginal queries — the
JAX package's ``serving/pool.py`` on the port.

One registered workload owns one Engine, ONE sweep chunk, and a set of
lanes — the resident unconditional lane plus an LRU of conditioned lanes,
one per distinct evidence set currently being queried.  The design
invariants:

  * **One chunk per workload, evidence as data.**  The chunk is a host
    loop of ``sweeps_per_chunk`` telemetry'd ``Engine.sweep(state, tel,
    evidence=)`` calls, each followed by ``accumulate_marginals``; the
    resident lane passes the all-zero mask, conditioned lanes pass theirs,
    so every lane — clamped or not — runs the same operations and, on the
    card, launches the same kernels the same number of times (one sweep
    kernel and one telemetry kernel per sweep call).
    ``compiled_cache_size`` counts the distinct argument signatures the
    chunk has run (the counterpart of a jit cache) and stays 1.
    Conditioning a new evidence set costs a clamp + cache refresh, never
    a rebuild.
  * **Snapshots are copies, and reading one is free and non-perturbing.**
    The port's state is updated in place — the telemetry carry, the
    running marginal sums and the state's ``torch.Generator`` — so each
    lane owns working buffers.  A chunk advances them, then publishes an
    immutable ``_Snapshot``: a copy of the state tensors, the carry and
    the sums, a generator set to the working one's state, and (on the
    card) a CUDA event recorded after the copy.  A published snapshot is
    never written again.  Answering a query reads the latest snapshot on
    a side stream that waits on that event only, so an answer never
    queues behind a chunk issued after it; the reader holds the snapshot
    until its last read, a blocking copy to the host, so the caching
    allocator cannot hand the snapshot's memory to the driver while a
    read is in flight.  No host sync is added to the sweep path, and
    serving traffic cannot perturb the chain (the resident lane's
    trajectory, generator state included, is bit-identical with or
    without serving, asserted in tests).
  * **Every query gets a structured answer.**  ``submit`` runs through
    bounded admission (overload sheds lowest-priority queries with
    ``status='shed'``), honors per-query deadlines (past the deadline the
    pool stops sweeping for freshness and degrades), and walks a
    graceful-degradation ladder — fresh snapshot → bounded-staleness
    snapshot → exact conditional enumeration (small components) →
    structured refusal — recording the rung on ``Answer.source``.  Never
    an unhandled exception or a hang.
  * **Per-lane circuit breakers.**  Each lane's committed-chunk health
    (sticky ``bad_state`` + windowed acceptance, read at the freshness
    gate's existing host-sync boundary — zero new syncs on the sweep
    path) feeds a closed → open → half-open breaker
    (:mod:`.resilience`).  An open breaker quarantines the lane — the
    last healthy snapshot keeps serving stale answers, the degenerate
    state is never advanced or served — until a half-open probe chunk
    proves recovery; the probe rewinds the working buffers AND the lane's
    generator to the last healthy snapshot.
  * **Conditioned lanes fork warm, behind an epoch fence.**  A new
    evidence set copies the resident lane's latest snapshot onto the
    lane's own generator, seeded from (workload seed, crc32 of the
    signature), and clamps it (:meth:`Engine.clamp`, whose cache redraw
    then draws from the lane's generator, never the resident's), so lanes
    draw independent streams.  Lanes remember the workload epoch they
    forked at; :meth:`invalidate` (called by the supervised owner on
    rollback) bumps the epoch so every lane forked from since-discarded
    chunks is atomically dropped and re-forked from the restored snapshot
    — no answer is ever computed from a rolled-back ancestor.

Drive the pool three ways: synchronously (:meth:`advance`), on the
supervised background driver (:meth:`start`/:meth:`stop` — a
:class:`~.resilience.SupervisedDriver` with watchdog heartbeat and
budgeted restarts, not a silently-dying daemon), or externally by an
owner loop that pushes snapshots via :meth:`publish` — the supervised
serving front (``launch/serve.py``) does the latter so resident chains get
checkpoint crash-resume from :class:`~repro_torch.runtime.supervisor.
SupervisedRun` for free; :meth:`publish` copies too, since the owner goes
on updating its buffers in place.

The streams differ from the JAX package's (threefry), so the lanes agree
with it in distribution, not in bits.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import engine as engine_lib
from ..core.chains import accumulate_marginals
from ..diagnostics.exact import exact_conditional_marginals
from ..diagnostics.freshness import FreshnessPolicy, freshness_report
from ..diagnostics.telemetry import clear_health
from ..obs import get_recorder
from .query import Query, Answer
from .resilience import (AdmissionController, AdmissionPolicy, BreakerPolicy,
                         CircuitBreaker, DegradePolicy, SupervisedDriver)

__all__ = ["ChainPool", "PoolWorkload"]

Signature = Tuple[Tuple[int, int], ...]


class _Snapshot(NamedTuple):
    """Immutable published view of a lane after some chunk: everything an
    answer needs, read without touching the advancing chain."""
    st: Any              # state copy; its generator holds the state's draws
    tel: Any             # carry copy
    marg: torch.Tensor   # (C, n, D) running one-hot sums (copy)
    count: int           # snapshots accumulated
    sweeps: int          # lane sweeps completed at publish time
    ready: Any = None    # torch.cuda.Event recorded after the copy (card)


class _Work(NamedTuple):
    """A lane's working buffers: what its next chunk advances in place."""
    st: Any
    tel: Any
    marg: torch.Tensor
    count: int
    weight: Optional[torch.Tensor]   # accumulate_marginals' (C, n) scratch


def _gen_of(st) -> torch.Generator:
    """The state's generator (through an AdaptiveScan wrapper)."""
    return getattr(st, "inner", st).gen


def _copy(tree, gen: Optional[torch.Generator] = None):
    """A copy of a state or carry: tensors cloned, NamedTuples rebuilt,
    host numbers kept; a generator becomes ``gen`` when given (its state
    left as it is), else a new generator set to its state."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, torch.Generator):
        if gen is not None:
            return gen
        out = torch.Generator(device=tree.device)
        out.set_state(tree.get_state())
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_copy(v, gen) for v in tree))
    return tree


def _publish(work: _Work, sweeps: int) -> _Snapshot:
    """Copy-on-publish: the snapshot shares no tensor and no generator
    with the working buffers; on the card an event marks the copy done."""
    snap = _Snapshot(st=_copy(work.st), tel=_copy(work.tel),
                     marg=work.marg.clone(), count=int(work.count),
                     sweeps=int(sweeps))
    if snap.marg.is_cuda:
        ready = torch.cuda.Event()
        ready.record()
        snap = snap._replace(ready=ready)
    return snap


def _work_from(snap: _Snapshot, gen: torch.Generator) -> _Work:
    """Working buffers from a snapshot: copies of its tensors, on ``gen``
    (the lane's generator) set to the snapshot's generator state."""
    gen.set_state(_gen_of(snap.st).get_state())
    st = _copy(snap.st, gen)
    return _Work(st=st, tel=_copy(snap.tel), marg=snap.marg.clone(),
                 count=snap.count, weight=_weight(st))


def _weight(st) -> torch.Tensor:
    return torch.empty(st.x.shape, dtype=torch.float32, device=st.x.device)


class _Lane:
    """One (workload, evidence-signature) chain group."""

    def __init__(self, signature: Signature, evidence, site_mask,
                 work: _Work, gen: torch.Generator, *,
                 breaker: CircuitBreaker, fork_epoch: int = 0):
        self.signature = signature
        self.evidence = evidence          # (ev_mask, ev_vals) device tensors
        self.site_mask = site_mask        # (n,) bool, True = unobserved
        self.gen = gen                    # the working state's generator
        self.work: Optional[_Work] = work  # None: re-made from ``snap``
        self.snap: _Snapshot = _publish(work, 0)
        self.sweeps = 0                   # sweeps STARTED (>= snap.sweeps)
        self.lock = threading.Lock()
        self.breaker = breaker
        self.fork_epoch = fork_epoch      # workload epoch at fork time
        self.last_good: Optional[_Snapshot] = None  # last healthy snapshot
        self.quarantined = False          # open breaker: serve last_good


def _lane_tag(signature: Signature) -> str:
    """Bounded-cardinality lane label for metrics/events."""
    if signature == ():
        return "resident"
    return f"{zlib.crc32(repr(signature).encode()):08x}"


def _lane_seed(seed: int, signature: Signature) -> int:
    """The conditioned lane's generator seed: a function of the workload
    seed and the crc32 tag of the signature only."""
    tag = zlib.crc32(repr(signature).encode())
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(1)[0])


class PoolWorkload:
    """Everything the pool holds per registered workload: the Engine, the
    one chunk, the resident lane, and the conditioned-lane LRU."""

    def __init__(self, name: str, eng, chunk, resident: _Lane, *,
                 policy: FreshnessPolicy, sweeps_per_chunk: int,
                 max_conditioned: int, seed: int):
        self.name = name
        self.engine = eng
        self.chunk = chunk
        self.resident = resident
        self.policy = policy
        self.sweeps_per_chunk = sweeps_per_chunk
        self.max_conditioned = max_conditioned
        self.seed = seed
        self.lanes: "collections.OrderedDict[Signature, _Lane]" = \
            collections.OrderedDict()
        # snapshot-epoch fence: bumped by invalidate() on a supervised
        # rollback; lanes forked at an older epoch are dropped, not served
        self.epoch = 0
        self.fence_pending = False
        # per-signature cache of exact conditional marginals (the ladder's
        # enumeration rung; computing them is pure host work)
        self.exact_cache: Dict[Signature, np.ndarray] = {}
        # standard metric/trace label set for this workload's series
        self.labels = get_recorder().register_engine(
            eng, workload=name, chains=int(resident.snap.marg.shape[0]))


def _zero_evidence(n: int, device):
    return (torch.zeros((n,), dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.int32, device=device))


class ChainPool:
    """The warm pool: register workloads, advance their chains, answer
    batched queries (see the module docstring for the design).

    ``admission``/``breaker``/``degrade`` set the resilience policies
    (:mod:`.resilience`); ``clock`` is the monotonic time source every
    deadline/cooldown decision reads — injectable so tests never sleep.
    """

    def __init__(self, *, policy: Optional[FreshnessPolicy] = None,
                 seed: int = 0,
                 admission: Optional[AdmissionPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 degrade: Optional[DegradePolicy] = None,
                 clock=time.monotonic):
        self.policy = policy or FreshnessPolicy()
        self.seed = seed
        self.clock = clock
        self.admission = AdmissionController(admission or AdmissionPolicy())
        self.breaker_policy = breaker or BreakerPolicy()
        self.degrade = degrade or DegradePolicy()
        self._workloads: Dict[str, PoolWorkload] = {}
        self._lock = threading.Lock()
        self._streams: Dict[torch.device, Any] = {}
        self.driver: Optional[SupervisedDriver] = None

    # -- registration -------------------------------------------------------

    def register(self, name: str, *, graph=None, engine: str = "gibbs",
                 device=None, chains: int = 32,
                 sweep: Optional[int] = None, schedule=None,
                 sweeps_per_chunk: int = 8,
                 policy: Optional[FreshnessPolicy] = None,
                 max_conditioned: int = 8, seed: Optional[int] = None,
                 **params) -> PoolWorkload:
        """Register workload ``name``: build its Engine and its chunk,
        init the resident lane.  ``name`` doubles as the registry workload
        name when ``graph`` is omitted.  Runs on the card unless
        ``device`` names another one (``device="cpu"``: the kernels'
        plain versions); without a card it raises, never falling back.
        The engine must support evidence clamping (gibbs, mgpmh,
        min-gibbs, doublemin on one device)."""
        if name in self._workloads:
            raise ValueError(f"workload {name!r} already registered")
        if graph is None:
            graph = engine_lib.make_workload(name, device=device).graph
        if sweep is None and schedule is None:
            sweep = graph.n
        eng = engine_lib.make(engine, graph, sweep=sweep, schedule=schedule,
                              device=device, **params)
        if not eng.supports_evidence:
            raise ValueError(
                f"engine {engine!r} ({eng.backend}/"
                f"{eng.schedule.describe()}) cannot serve conditioned "
                f"queries; pick gibbs, mgpmh, min-gibbs or doublemin on "
                f"one device")
        seed = self.seed if seed is None else seed
        g = eng.graph
        st = eng.init(seed, chains)
        work = _Work(st=st, tel=eng.init_telemetry(st),
                     marg=torch.zeros((chains, g.n, g.D),
                                      dtype=torch.float32,
                                      device=eng.device),
                     count=0, weight=_weight(st))
        resident = _Lane((), _zero_evidence(g.n, eng.device),
                         np.ones((g.n,), bool), work, _gen_of(st),
                         breaker=self._new_breaker())
        w = PoolWorkload(name, eng, _Chunk(eng, sweeps_per_chunk),
                         resident, policy=policy or self.policy,
                         sweeps_per_chunk=sweeps_per_chunk,
                         max_conditioned=max_conditioned, seed=seed)
        with self._lock:
            self._workloads[name] = w
        return w

    def _new_breaker(self) -> CircuitBreaker:
        return CircuitBreaker(self.breaker_policy, clock=self.clock)

    def workload(self, name: str) -> PoolWorkload:
        try:
            return self._workloads[name]
        except KeyError:
            raise KeyError(f"workload {name!r} not registered; have "
                           f"{sorted(self._workloads)}") from None

    def engine(self, name: str):
        return self.workload(name).engine

    def snapshot(self, name: str,
                 signature: Signature = ()) -> _Snapshot:
        """The latest published snapshot of a lane (resident by default)."""
        w = self.workload(name)
        if signature == ():
            return w.resident.snap
        return w.lanes[signature].snap

    def compiled_cache_size(self, name: str) -> int:
        """Argument signatures this workload's chunk has run — stays 1
        across clamped and unclamped lanes (evidence is data)."""
        return self.workload(name).chunk.cache_size()

    # -- lanes --------------------------------------------------------------

    def _fork(self, w: PoolWorkload, signature: Signature,
              ev) -> Tuple[_Work, torch.Generator]:
        """Working buffers of a conditioned lane forked warm from the
        resident's latest snapshot, and the lane's own generator: a copy
        of the snapshot's state on that generator, clamped (the cache
        redraw draws from it), with fresh telemetry and sums."""
        gen = torch.Generator(device=w.engine.device)
        gen.manual_seed(_lane_seed(w.seed, signature))
        src = w.resident.snap
        st = w.engine.clamp(_copy(src.st, gen), ev)
        return _Work(st=st, tel=w.engine.init_telemetry(st),
                     marg=torch.zeros_like(src.marg), count=0,
                     weight=_weight(st)), gen

    def _lane_for(self, w: PoolWorkload, signature: Signature) -> _Lane:
        if signature == ():
            return w.resident
        with self._lock:
            lane = w.lanes.get(signature)
            if lane is not None and lane.fork_epoch == w.epoch:
                w.lanes.move_to_end(signature)
                return lane
            if lane is not None:
                # forked before the last rollback fence: its ancestor
                # chunks were discarded — drop and re-fork from the
                # restored resident snapshot
                del w.lanes[signature]
            g = w.engine.graph
            sites = np.asarray([s for s, _ in signature], np.int64)
            vals = np.asarray([v for _, v in signature], np.int64)
            if sites.size and (sites.min() < 0 or sites.max() >= g.n):
                raise ValueError(f"evidence sites out of range [0, {g.n})")
            if vals.size and (vals.min() < 0 or vals.max() >= g.D):
                raise ValueError(f"evidence values out of range [0, {g.D})")
            if sites.size >= g.n:
                raise ValueError("evidence observes every site; nothing "
                                 "left to sample — compute it directly")
            mask = np.zeros((g.n,), np.float32)
            mask[sites] = 1.0
            ev_vals = np.zeros((g.n,), np.int32)
            ev_vals[sites] = vals
            dev = w.engine.device
            ev = (torch.from_numpy(mask).to(dev),
                  torch.from_numpy(ev_vals).to(dev))
            rec = get_recorder()
            with rec.span("lane_fork", n_evidence=len(signature),
                          **w.labels):
                work, gen = self._fork(w, signature, ev)
                lane = _Lane(signature, ev, mask == 0.0, work, gen,
                             breaker=self._new_breaker(),
                             fork_epoch=w.epoch)
            w.lanes[signature] = lane
            while len(w.lanes) > w.max_conditioned:   # LRU eviction
                w.lanes.popitem(last=False)
                rec.count("lane_evictions_total", 1, **w.labels)
            rec.gauge("pool_lanes", 1 + len(w.lanes), **w.labels)
            return lane

    def _advance_lane(self, w: PoolWorkload, lane: _Lane, chunks: int = 1):
        rec = get_recorder()
        with lane.lock:
            # the span brackets chunk *dispatch* (the kernels are async):
            # no host sync is added to the sweep path
            with rec.span("sweep_chunk", chunks=chunks,
                          conditioned=bool(lane.signature), **w.labels):
                if lane.work is None:
                    lane.work = _work_from(lane.snap, lane.gen)
                for _ in range(chunks):
                    work = lane.work
                    lane.sweeps += w.sweeps_per_chunk
                    st, tel = w.chunk(work.st, work.tel, work.marg,
                                      work.weight, *lane.evidence)
                    lane.work = work._replace(
                        st=st, tel=tel,
                        count=work.count + w.sweeps_per_chunk)
                    lane.snap = _publish(lane.work, lane.sweeps)
            rec.count("sweeps_total", chunks * w.sweeps_per_chunk,
                      **w.labels)

    def advance(self, name: Optional[str] = None, chunks: int = 1):
        """Synchronously advance every lane of ``name`` (or of every
        workload) by ``chunks`` chunks."""
        names = [name] if name is not None else list(self._workloads)
        for nm in names:
            w = self.workload(nm)
            for lane in [w.resident, *list(w.lanes.values())]:
                self._advance_lane(w, lane, chunks)

    # -- epoch fence (rollback integration) ---------------------------------

    def invalidate(self, name: str):
        """Fence the workload's snapshot lineage: a supervised owner calls
        this when it rolls back, BEFORE publishing the restored snapshot.
        Bumps the epoch and drops every conditioned lane (they forked from
        since-discarded chunks); the fence stays pending until the next
        :meth:`publish`, which bumps again so lanes forked in the window
        between rollback and restore are also invalidated."""
        w = self.workload(name)
        with self._lock:
            w.epoch += 1
            w.fence_pending = True
            dropped = len(w.lanes)
            w.lanes.clear()
        rec = get_recorder()
        rec.event("epoch_fence", workload=name, epoch=w.epoch,
                  dropped_lanes=dropped)
        rec.gauge("pool_lanes", 1, **w.labels)

    def publish(self, name: str, st, tel, marg, count, sweeps: int):
        """External-driver path: an owner loop (the supervised serving
        front) pushes the resident lane's new snapshot after each of its
        own steps.  The owner's buffers are copied (it goes on updating
        them in place), and the resident's next chunk, if any, starts
        from that copy.  Do not mix with :meth:`start` on the same
        workload."""
        w = self.workload(name)
        lane = w.resident
        with lane.lock:
            lane.sweeps = int(sweeps)
            lane.work = None
            lane.snap = _publish(_Work(st=st, tel=tel, marg=marg,
                                       count=int(count), weight=None),
                                 int(sweeps))
        if w.fence_pending:
            # the owner published the restored snapshot: close the fence
            # (second epoch bump catches lanes forked inside the window)
            # and reset the resident breaker — pre-rollback verdicts
            # described a state that no longer exists
            with self._lock:
                w.epoch += 1
                w.fence_pending = False
                w.lanes.clear()
            lane.breaker = self._new_breaker()
            lane.quarantined = False
            lane.last_good = None

    # -- background driver --------------------------------------------------

    def start(self, interval_s: float = 0.0, *, budget=None, backoff=None):
        """Start the supervised driver: round-robin one chunk per healthy
        lane per round, ``interval_s`` sleep between rounds.  The drive
        loop runs under :class:`~.resilience.SupervisedDriver` — a crash
        is a structured event + budgeted restart, not a silent death."""
        if self.driver is not None:
            raise RuntimeError("driver already running")

        def body(stop: threading.Event):
            while not stop.is_set():
                self.driver.beat()
                for nm in list(self._workloads):
                    w = self._workloads.get(nm)
                    if w is None:
                        continue
                    for lane in [w.resident, *list(w.lanes.values())]:
                        if stop.is_set():
                            return
                        if lane.quarantined:
                            continue    # open breaker: probe path only
                        self._advance_lane(w, lane, 1)
                self.driver.note_progress()
                if interval_s:
                    stop.wait(interval_s)

        self.driver = SupervisedDriver(body, budget=budget, backoff=backoff,
                                       clock=self.clock,
                                       recorder=get_recorder())
        self.driver.start()

    def stop(self):
        if self.driver is None:
            return
        self.driver.stop()
        self.driver = None

    # -- chaos hook ---------------------------------------------------------

    def inject_lane_fault(self, name: str, signature: Signature = (), *,
                          target: str = "cache", mode: str = "nan",
                          seed: int = 0):
        """Corrupt a lane's state (tests/CI chaos drills): the working
        state, then a fresh snapshot of it is published.  At a quiescent
        boundary, on the device (no host sync) — the health guard latches
        on the next committed chunk and the lane's breaker takes it from
        there."""
        from ..runtime.faultinject import Fault, inject_state_fault
        w = self.workload(name)
        lane = w.resident if signature == () \
            else w.lanes[tuple(signature)]
        fault = Fault(step=0, kind="nan", target=target, mode=mode)
        rng = np.random.default_rng(seed)
        with lane.lock:
            if lane.work is None:
                lane.work = _work_from(lane.snap, lane.gen)
            lane.work = lane.work._replace(
                st=inject_state_fault(lane.work.st, fault, rng))
            lane.snap = _publish(lane.work, lane.snap.sweeps)
        get_recorder().event("fault", target=target,
                             lane=_lane_tag(tuple(signature)),
                             injected="lane_snapshot", **w.labels)

    # -- answering ----------------------------------------------------------

    def submit(self, queries: Sequence[Query], *,
               max_extra_sweeps: Optional[int] = None,
               serve_stale: bool = False) -> List[Answer]:
        """Answer a batch of queries; returns answers in request order.

        The batch first passes admission control (overload sheds
        lowest-priority queries: ``status='shed'``, no work done).
        Admitted queries are grouped by (workload, evidence signature) so
        one lane read serves the whole group; each group takes its lane's
        committed-chunk health verdict, feeds the circuit breaker, then
        walks the degradation ladder (module docstring).  A healthy lane
        that fails the freshness gate is advanced — at most
        ``max_extra_sweeps`` extra sweeps (default: 64 chunks' worth) and
        never past the group's earliest deadline.  ``serve_stale=True``
        lets the stale rung serve below ``min_samples`` (legacy flag).

        Malformed queries (unknown workload, out-of-domain evidence)
        raise — caller bugs, not serving failures; any *other* exception
        is converted to ``status='error'`` answers for its group."""
        rec = get_recorder()
        t_submit = rec.now_us()
        t0 = self.clock()
        answers: List[Optional[Answer]] = [None] * len(queries)
        with rec.span("admission", n_queries=len(queries)):
            admitted, shed = self.admission.admit(
                [q.priority for q in queries])
        for i in shed:
            q = queries[i]
            rec.count("shed_total", 1, workload=q.workload)
            answers[i] = Answer(
                query=q, fresh=False, staleness_sweeps=0, sweeps=0,
                status="shed",
                report={"fresh": False, "samples": 0,
                        "reason": "shed: admission queue full (max_pending="
                                  f"{self.admission.policy.max_pending})"})
        if not admitted:
            return answers    # type: ignore[return-value]
        try:
            groups: Dict[Tuple[str, Signature], List[int]] = {}
            for idx in admitted:
                q = queries[idx]
                groups.setdefault((q.workload, q.signature), []).append(idx)
            for (wname, sig), idxs in groups.items():
                w = self.workload(wname)
                # groups run sequentially: time since submit is this
                # group's queue wait (explicit-timestamp span, no sync)
                wait_us = rec.now_us() - t_submit
                rec.complete("queue_wait", t_submit, wait_us,
                             n_queries=len(idxs), **w.labels)
                rec.histogram("queue_wait_seconds", wait_us / 1e6,
                              lane=_lane_tag(sig), **w.labels)
                try:
                    self._serve_group(w, sig, idxs, queries, answers,
                                      t0=t0, rec=rec,
                                      max_extra_sweeps=max_extra_sweeps,
                                      serve_stale=serve_stale)
                except (KeyError, ValueError):
                    raise             # malformed request: caller contract
                except Exception as e:  # noqa: BLE001 — answer, don't die
                    rec.event("serve_error", error=repr(e), **w.labels)
                    for idx in idxs:
                        answers[idx] = Answer(
                            query=queries[idx], fresh=False,
                            staleness_sweeps=0, sweeps=0, status="error",
                            report={"fresh": False,
                                    "reason": f"error: {e!r}"})
                dur_us = rec.now_us() - t_submit
                for _ in idxs:
                    rec.histogram("serving_latency_seconds", dur_us / 1e6,
                                  lane=_lane_tag(sig), **w.labels)
        finally:
            self.admission.release(len(admitted))
        return answers    # type: ignore[return-value]

    # -- snapshot reads -----------------------------------------------------

    @contextlib.contextmanager
    def _reading(self, snap: _Snapshot):
        """Run the block's reads of ``snap`` on the device's side stream,
        after the snapshot's copy and nothing later (on the card; a CPU
        snapshot is read in place)."""
        if snap.ready is None:
            yield
            return
        dev = snap.marg.device
        with self._lock:
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(device=dev)
        stream.wait_event(snap.ready)
        with torch.cuda.stream(stream):
            yield

    def _snap_marginals(self, snap: _Snapshot) -> np.ndarray:
        """(n, D) float64 chain-averaged marginals of a snapshot: the sum
        over chains on the device in float64 (integer counts below 2^53:
        exact in any order), then one (n, D) copy to the host."""
        with self._reading(snap):
            total = snap.marg.sum(0, dtype=torch.float64).cpu().numpy()
        return total / (max(snap.count, 1) * snap.marg.shape[0])

    # -- the per-group serve: health, breaker, freshness, ladder ------------

    def _lane_report(self, w: PoolWorkload, lane: _Lane, snap: _Snapshot):
        """Freshness + health verdict of one snapshot: THE host-sync
        boundary (already existed as the freshness gate); the breaker's
        committed-chunk verdicts ride the same read."""
        with self._reading(snap):
            return freshness_report(snap.tel, w.policy,
                                    site_mask=lane.site_mask,
                                    include_health=True,
                                    exact_accept=w.engine.exact_accept)

    def _feed_breaker(self, w: PoolWorkload, lane: _Lane, healthy: bool,
                      rec, tag: str):
        change = lane.breaker.record(healthy)
        if change == "open":
            lane.quarantined = True
            rec.event("breaker_open", lane=tag,
                      strikes=lane.breaker.strikes, **w.labels)
        elif change == "close":
            lane.quarantined = False
            rec.event("breaker_close", lane=tag, **w.labels)
        rec.gauge("breaker_state", lane.breaker.gauge, lane=tag, **w.labels)
        return change

    def _probe(self, w: PoolWorkload, lane: _Lane, rec, tag: str) -> bool:
        """Half-open probe: rewind the working buffers and the lane's
        generator to the last healthy snapshot (or re-fork a conditioned
        lane warm from the resident), advance ONE chunk, verdict.  Returns
        True when the breaker re-closed."""
        with rec.span("breaker_probe", lane=tag, **w.labels):
            with lane.lock:
                src = lane.last_good
                if src is not None:
                    work = _work_from(src, lane.gen)
                    lane.work = work._replace(tel=clear_health(work.tel))
                    lane.snap = _publish(lane.work, src.sweeps)
                    lane.sweeps = src.sweeps
                elif lane.signature:
                    lane.work, lane.gen = self._fork(w, lane.signature,
                                                     lane.evidence)
                    lane.snap = _publish(lane.work, 0)
                    lane.sweeps = 0
                # else: resident with no healthy history — advance in
                # place (a supervised owner may have published a repaired
                # snapshot since the breaker opened)
            self._advance_lane(w, lane, 1)
            snap = lane.snap
            rep = self._lane_report(w, lane, snap)
            healthy = not lane.breaker.unhealthy(rep)
            self._feed_breaker(w, lane, healthy, rec, tag)
            if healthy:
                lane.last_good = snap
            return healthy

    def _serve_group(self, w: PoolWorkload, sig: Signature,
                     idxs: List[int], queries: Sequence[Query],
                     answers: List[Optional[Answer]], *, t0: float, rec,
                     max_extra_sweeps: Optional[int], serve_stale: bool):
        lane = self._lane_for(w, sig)
        tag = _lane_tag(sig)
        budget = (64 * w.sweeps_per_chunk
                  if max_extra_sweeps is None else max_extra_sweeps)
        dls = [q.deadline_ms if q.deadline_ms is not None
               else self.admission.policy.default_deadline_ms
               for q in (queries[i] for i in idxs)]
        dls = [d for d in dls if d is not None]
        deadline_at = (t0 + min(dls) / 1e3) if dls else None
        with rec.span("query", n_queries=len(idxs),
                      conditioned=bool(sig), **w.labels):
            healthy = False
            snap = rep = None
            spent = 0
            deadline_missed = False
            if lane.breaker.state == CircuitBreaker.OPEN \
                    and lane.breaker.allow_probe():
                self._probe(w, lane, rec, tag)
            if lane.breaker.state != CircuitBreaker.OPEN:
                with rec.span("freshness_sweeps", **w.labels):
                    while True:
                        snap = lane.snap
                        rep = self._lane_report(w, lane, snap)
                        healthy = not lane.breaker.unhealthy(rep)
                        self._feed_breaker(w, lane, healthy, rec, tag)
                        if healthy:
                            lane.last_good = snap
                        if not healthy or rep["fresh"]:
                            break
                        if spent + w.sweeps_per_chunk > budget:
                            break
                        if deadline_at is not None \
                                and self.clock() >= deadline_at:
                            deadline_missed = True
                            break
                        self._advance_lane(w, lane, 1)
                        spent += w.sweeps_per_chunk

            # -- degradation ladder --------------------------------------
            if healthy:
                serve_snap, serve_rep = snap, dict(rep)
            else:
                # quarantined (or mid-strike unhealthy): the degenerate
                # snapshot is never served — fall back to the last
                # healthy one (one extra host read, unhealthy path only)
                serve_snap = lane.last_good
                serve_rep = (self._lane_report(w, lane, serve_snap)
                             if serve_snap is not None
                             else {"fresh": False, "samples": 0,
                                   "reason": "no healthy snapshot"})
                serve_rep["quarantined"] = True
            serve_rep["breaker"] = lane.breaker.state
            if deadline_missed:
                serve_rep["deadline_missed"] = True
                rec.count("deadline_miss_total", len(idxs), **w.labels)

            staleness = (lane.sweeps - serve_snap.sweeps
                         if serve_snap is not None else 0)
            marg = source = None
            status = "ok"
            fresh_out = False
            if healthy and serve_rep["fresh"]:
                source, fresh_out = "fresh", True
                marg = self._snap_marginals(serve_snap)
            elif (serve_snap is not None
                    and serve_snap.count > 0
                    and (serve_rep["samples"] >= w.policy.min_samples
                         or serve_stale)
                    and staleness <= self.degrade.max_stale_sweeps):
                source = "stale"
                marg = self._snap_marginals(serve_snap)
            else:
                try:
                    with rec.span("degrade", rung="exact", lane=tag,
                                  **w.labels):
                        marg = self._exact_marginals(w, sig)
                    source = "exact"
                except ValueError as e:
                    status = "refused"
                    serve_rep.setdefault(
                        "reason", "every ladder rung exhausted")
                    serve_rep["exact_refused"] = str(e)
            if source in ("stale", "exact"):
                rec.count("degraded_total", len(idxs), source=source,
                          **w.labels)
            for idx in idxs:
                answers[idx] = _answer(queries[idx], serve_rep, staleness,
                                       serve_snap.sweeps if serve_snap
                                       else 0, marg,
                                       status=status, source=source,
                                       fresh=fresh_out)
        rec.count("queries_total", len(idxs), fresh=fresh_out, **w.labels)
        rec.count("sweeps_to_fresh_total", spent, **w.labels)
        rec.count("sweeps_to_fresh_count", 1, **w.labels)

    def _exact_marginals(self, w: PoolWorkload, sig: Signature
                         ) -> np.ndarray:
        """The ladder's enumeration rung, cached per evidence signature
        (pure host work; raises ValueError on oversized components)."""
        got = w.exact_cache.get(sig)
        if got is None:
            got = exact_conditional_marginals(
                w.engine.graph,
                [s for s, _ in sig], [v for _, v in sig],
                max_states=self.degrade.exact_max_states)
            w.exact_cache[sig] = got
        return got


def _answer(q: Query, rep, staleness: int, sweeps: int,
            marg: Optional[np.ndarray], *, status: str = "ok",
            source: Optional[str] = None, fresh: bool = False) -> Answer:
    ans = Answer(query=q, fresh=fresh, report=dict(rep),
                 staleness_sweeps=staleness, sweeps=sweeps,
                 status=status, source=source)
    if marg is None:
        return ans
    sel = marg if q.sites is None else marg[np.asarray(q.sites, np.int64)]
    if q.kind == "map":
        ans.map_values = np.argmax(sel, axis=-1)
    else:
        ans.marginals = sel
    return ans


def _signature(tree) -> tuple:
    """The abstract signature of a chunk argument: its type and, for every
    tensor in it, shape, dtype and device type."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device.type)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    return (type(tree).__name__,)


class _Chunk:
    """THE one chunk per workload: ``sweeps_per_chunk`` telemetry'd sweeps
    + snapshot-marginal accumulation, evidence as data.  A host loop of
    ``Engine.sweep(state, tel, evidence=)`` and ``accumulate_marginals``:
    on the card one sweep-kernel launch, one telemetry-kernel launch and
    the accumulation's three elementwise launches per sweep, clamped or
    not; no host sync.  Returns the advanced ``(state, tel)``; ``tel`` and
    ``marg`` are updated in place."""

    def __init__(self, eng, sweeps_per_chunk: int):
        self.engine = eng
        self.sweeps_per_chunk = sweeps_per_chunk
        self._signatures = set()

    def __call__(self, st, tel, marg, weight, ev_mask, ev_vals):
        self._signatures.add(tuple(_signature(a) for a in
                                   (st, tel, marg, weight, ev_mask,
                                    ev_vals)))
        eng, ev = self.engine, (ev_mask, ev_vals)
        for _ in range(self.sweeps_per_chunk):
            st, tel = eng.sweep(st, tel, evidence=ev)
            accumulate_marginals(marg, st.x, weight)
        return st, tel

    def cache_size(self) -> int:
        """Distinct argument signatures run (the jit cache's counterpart):
        1 while every lane passes tensors of the same shapes and types."""
        return len(self._signatures)
