"""Supervised sampling runtime: the driver that keeps a chain alive for
days -- the JAX package's ``runtime/supervisor.py`` on the port.

:class:`SupervisedRun` wraps any :class:`~repro_torch.core.engine.Engine`
loop with everything the bare launcher loop lacks:

  * **restarts** under a progress-refreshing retry budget with exponential
    backoff (``runtime/fault.py``), restoring from the newest checkpoint
    that passes integrity verification (``checkpoint.latest_good_step`` --
    corrupt step dirs are quarantined, never resumed from);
  * **periodic async checkpoints** of the full sampler bundle (state with
    its generators + running marginal sums + snapshot count), so resume is
    bit-exact;
  * **health guards** read ONCE per outer step: the sticky ``bad_state``
    flag and the windowed acceptance counters ride the telemetry carry
    (``diagnostics/telemetry.py``), plus one
    :func:`~repro_torch.diagnostics.telemetry.state_health` reduction at
    the boundary, in one host read (on the dist backend one all-reduce
    first, so every rank takes the same branch).  The chunk itself makes
    no host sync.  An unhealthy step is never checkpointed: the supervisor
    rolls back to the last good checkpoint and, after ``max_strikes``
    consecutive rollbacks, escalates: re-tune lambda through
    ``autotune_lambda`` on the engine's device (MH minibatch engines), or
    degrade to the exact ``gibbs`` engine (the chain state carries over --
    every engine of a backend has the same state layout);
  * **elastic restart**: a :class:`~repro_torch.runtime.faultinject.
    SimulatedDeviceLoss` (or a real loss surfacing as an exception)
    rebuilds the engine over the surviving ranks and restores the
    checkpoint onto the smaller mesh -- checkpoints hold global arrays, and
    the few per-data-shard leaves (generator states, adaptive counters)
    are re-binned by :func:`reshard_dp`;
  * **heartbeat + step watchdog + incident events** through the active
    recorder's ``events.jsonl`` stream.

The chunk is a host loop of ``Engine.sweep(state, telemetry)`` calls, each
followed (off the dist backend) by the marginal accumulation of
``core.chains.accumulate_marginals``: on the card one sweep-kernel launch,
one telemetry-kernel launch and three small elementwise launches per call.
The state's health is latched into the carry on the device before each
chunk, since the kernels overwrite an updated site whatever it held.

Ranks.  ``make_engine(name, ranks, **params)`` is the launcher's
``engine_factory`` hook: ``ranks`` is ``[]`` on one device and the mesh's
ranks on the dist backend, where every rank of the mesh runs this same
driver.  There rank 0 writes the checkpoints (global arrays, gathered
over the mesh; a barrier after every save), decides the newest good step
alone (quarantine renames directories) and broadcasts it; each rank
restores its own slice.  After a device loss every rank of the old mesh
calls ``make_engine`` over the survivors; on a rank it leaves out the
factory returns None, and :meth:`SupervisedRun.run` returns a result
marked ``left``.  The survivors' later meshes (a degrade, a retune, a
second loss) make their groups among themselves (``launch/mesh.py``), so
the ranks that left need not take part.
Faults are applied the same way on every rank (the plan is the same
everywhere), so the ranks never part ways: a rank that rolled back alone
would deadlock the next collective.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import checkpoint as ckpt
from ..core.chains import accumulate_marginals
from ..diagnostics.telemetry import health_report, state_health
from ..obs import get_recorder
from .dist_gibbs import dist_restore, dist_to_host, reshard_dp
from .fault import Backoff, Heartbeat, RestartBudget, StepWatchdog
from .faultinject import (FaultPlan, SimulatedDeviceLoss, SimulatedPreemption,
                          corrupt_checkpoint, inject_state_fault)

__all__ = ["SupervisorConfig", "SupervisedRun", "RunResult", "reshard_dp"]


class Bundle(NamedTuple):
    """What gets checkpointed: sampler state + (off the dist backend) the
    (C, n, D) marginal sums and the snapshot count.  ``marg`` / ``count``
    are None on the dist backend, which accumulates both inside its own
    state -- None subtrees vanish from the checkpoint manifest."""
    st: Any
    marg: Optional[torch.Tensor]
    count: Optional[int]


@dataclasses.dataclass
class SupervisorConfig:
    outer_steps: int                  # supervised outer steps to complete
    sweeps_per_outer: int = 8         # Engine.sweep calls per outer step
    chains: int = 16
    seed: int = 0
    ckpt_dir: str = ""                # empty: no persistence (still guards)
    ckpt_every: int = 1               # outer steps between checkpoints
    async_ckpt: bool = True
    max_restarts: int = 5
    refresh_after: Optional[int] = 8  # successes refilling the retry budget
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 2.0
    acceptance_floor: float = 0.02    # windowed-acceptance health floor
    floor_after: int = 2              # outer steps before the floor applies
    max_strikes: int = 2              # rollbacks before retune/degrade
    retune: bool = True               # try autotune_lambda before degrading
    retune_target: tuple = (0.5, 0.9)
    heartbeat: str = ""               # liveness file path (optional)
    workload: str = ""                # metric/trace label only


@dataclasses.dataclass
class RunResult:
    state: Any                        # final sampler state (this rank's)
    marginals: Optional[np.ndarray]   # (n, D) chain-averaged estimate
    outer_steps: int
    restarts: int
    rollbacks: int
    incidents: List[Dict[str, Any]]
    engine: Any                       # the final Engine (post degrade/retune)
    telemetry: Any
    watchdog: Dict[str, Any]
    left: bool = False                # this rank left the mesh (device loss)


class SupervisedRun:
    """Drive ``make_engine(name, ranks, **params)`` for
    ``config.outer_steps`` outer steps, surviving preemptions, checkpoint
    corruption, sampler divergence, and rank loss.

    ``make_engine`` is the ONE construction hook: the supervisor calls it
    with the current engine name and the surviving ranks -- on degrade it
    passes ``"gibbs"``, on retune it forwards the tuned lambda as a keyword
    -- so meshes and devices stay the caller's business.  ``ranks``
    defaults to every rank of the world when a process group is up, else
    ``[]``.
    """

    def __init__(self, engine_name: str,
                 make_engine: Callable[..., Any],
                 config: SupervisorConfig,
                 fault_plan: Optional[FaultPlan] = None, *,
                 ranks: Optional[List[int]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 on_step: Optional[Callable[..., Any]] = None,
                 on_rollback: Optional[Callable[..., Any]] = None):
        self.cfg = config
        # ``on_step(step, bundle, telemetry, engine)`` fires after every
        # COMMITTED outer step (health-checked, checkpointed); return False
        # to stop the run early.  ``on_rollback(step, bundle, telemetry,
        # engine)`` fires after any recovery that REWINDS the published
        # lineage (rollback or restart restore)
        self._on_step = on_step
        self._on_rollback = on_rollback
        self.make_engine = make_engine
        self.engine_name = engine_name
        self.plan = fault_plan
        if ranks is None:
            ranks = (list(range(dist.get_world_size()))
                     if dist.is_available() and dist.is_initialized() else [])
        self.ranks = list(ranks)
        self.engine = make_engine(engine_name, self.ranks)
        self.incidents: List[Dict[str, Any]] = []
        self.rollbacks = 0
        self._strikes = 0
        self._weight = None           # accumulate_marginals' scratch
        self._budget = RestartBudget(config.max_restarts,
                                     config.refresh_after)
        self._backoff = Backoff(config.backoff_base, config.backoff_factor,
                                config.backoff_max, sleep_fn)
        self._watchdog = StepWatchdog()
        self._heartbeat = (Heartbeat(config.heartbeat, interval_s=0.0)
                           if config.heartbeat and self._lead else None)
        self._labels = get_recorder().register_engine(
            self.engine, workload=config.workload, chains=config.chains)

    # -- the mesh as this rank sees it ----------------------------------------

    @property
    def _dist(self) -> bool:
        return self.engine is not None and self.engine.backend == "dist"

    @property
    def _lead(self) -> bool:
        """This rank writes checkpoints, files and logs (always on one
        device)."""
        return (not self.ranks or not dist.is_initialized()
                or dist.get_rank() == self.ranks[0])

    def _coords(self):
        from ..launch.mesh import mesh_coords
        return mesh_coords(self.engine.mesh)

    def _group(self):
        from ..launch.mesh import mesh_group
        return mesh_group(self.engine.mesh)

    def _barrier(self):
        """A backend-neutral barrier over the mesh: one tiny all-reduce."""
        dist.all_reduce(torch.zeros(1, device=self.engine.device),
                        group=self._group())

    def _broadcast(self, value: float) -> float:
        """The lead rank's ``value`` on every rank of the mesh."""
        t = torch.tensor([value], dtype=torch.float64,
                         device=self.engine.device)
        dist.broadcast(t, src=self.ranks[0], group=self._group())
        return float(t.item())

    # -- incident log -------------------------------------------------------

    def _incident(self, kind: str, **info):
        rec = {"time": time.time(), "kind": kind, **info}
        self.incidents.append(rec)
        if self._lead:
            print(f"[supervisor] {kind}: "
                  f"{json.dumps({k: v for k, v in info.items()})}",
                  flush=True)
        get_recorder().event(kind, **info)

    # -- bundle lifecycle ---------------------------------------------------

    def _init_bundle(self) -> Bundle:
        eng = self.engine
        st = eng.init(self.cfg.seed, self.cfg.chains)
        if self._dist:
            return Bundle(st=st, marg=None, count=None)
        g = eng.graph
        return Bundle(st=st,
                      marg=torch.zeros((self.cfg.chains, g.n, g.D),
                                       dtype=torch.float32,
                                       device=eng.device),
                      count=0)

    def _save(self, step: int, bundle: Bundle):
        extra = {"outer_step": step, "engine": self.engine_name,
                 "backend": self.engine.backend,
                 # numeric params survive a process restart, so a resumed
                 # run rebuilds e.g. a retuned lambda, not the default
                 "params": {k: v for k, v in self.engine.params.items()
                            if isinstance(v, (int, float))}}
        tree = (dist_to_host(bundle, self.engine.mesh, self.ranks[0])
                if self._dist else bundle)
        if self._lead:
            if self.cfg.async_ckpt:
                ckpt.async_save(self.cfg.ckpt_dir, step, tree, extra=extra)
            else:
                ckpt.save(self.cfg.ckpt_dir, step, tree, extra=extra)
        if self._dist:
            self._barrier()

    def _latest_good(self) -> Optional[int]:
        """The newest step that verifies (quarantining the ones that do
        not); on the dist backend rank 0 decides alone and broadcasts."""
        if not self.cfg.ckpt_dir:
            return None
        step = None
        if self._lead:
            ckpt.wait_pending()
            step = ckpt.latest_good_step(self.cfg.ckpt_dir, quarantine=True)
        if self._dist:
            step = int(self._broadcast(-1 if step is None else step))
            step = None if step < 0 else step
        return step

    def _recover(self, reason: str):
        """(bundle, telemetry, outer_step) from the newest checkpoint that
        verifies -- quarantining corrupt ones -- or from scratch."""
        step = self._latest_good()
        if step is None:
            bundle = self._init_bundle()
            tel = self.engine.init_telemetry(bundle.st)
            self._incident("restore", source="scratch", reason=reason)
            return bundle, tel, 0
        saved = ckpt.read_manifest(self.cfg.ckpt_dir, step).get("extra", {})
        if reason == "start":
            # a fresh process adopts the checkpoint's engine (a degraded /
            # retuned run resumes as such); in-session recoveries keep the
            # CURRENT engine -- a post-escalation rollback must not swap the
            # old engine back in from a pre-escalation checkpoint
            name = saved.get("engine", self.engine_name)
            params = saved.get("params", {})
            current = {k: v for k, v in self.engine.params.items()
                       if isinstance(v, (int, float))}
            if name != self.engine_name or (params and params != current):
                self._swap_engine(name, note="resume", **params)
        template = self._init_bundle()
        if self._dist:
            bundle = dist_restore(self.cfg.ckpt_dir, step, template,
                                  self.engine.mesh)
        else:
            bundle = reshard_dp(ckpt.restore(self.cfg.ckpt_dir, step,
                                             template), template)
        tel = self.engine.init_telemetry(bundle.st)
        self._incident("restore", source=f"step_{step}", reason=reason)
        return bundle, tel, int(saved.get("outer_step", step))

    # -- engine swaps (degrade / retune / elastic) --------------------------

    def _swap_engine(self, name: str, note: str, **params):
        self.engine = self.make_engine(name, self.ranks, **params)
        self.engine_name = name       # only once the engine is built
        if self.engine is None:       # this rank is not in the new mesh
            return
        self._labels = get_recorder().register_engine(
            self.engine, workload=self.cfg.workload, chains=self.cfg.chains)
        if note != "resume":
            self._incident(note, engine=name, ranks=len(self.ranks),
                           **params)

    def _escalate(self):
        """Too many consecutive rollbacks: retune lambda (MH engines) or
        degrade to exact gibbs.  State carries over via the next checkpoint
        restore (same state layout on every engine of a backend)."""
        eng = self.engine
        if (self.cfg.retune and not eng.exact_accept
                and eng.name in ("mgpmh", "doublemin")):
            from ..diagnostics.adaptive import autotune_lambda
            lam_key = "lam1" if eng.name == "doublemin" else "lam"
            lam0 = float(eng.params.get(lam_key, 0.0)) or None
            tuned, _ = autotune_lambda(
                eng.name, eng.graph, target=self.cfg.retune_target,
                sweep=8, n_chains=8, pilot_calls=16,
                lam0=None if lam0 is None else 2.0 * lam0,
                seed=self.cfg.seed + 1, device=eng.device)
            lam = float(tuned.params[lam_key])
            if self._dist:            # every rank takes the lead's lambda
                lam = self._broadcast(lam)
            self._swap_engine(eng.name, note="retune", **{lam_key: lam})
        else:
            self._swap_engine("gibbs", note="degrade")
        self._strikes = 0

    # -- the outer step -----------------------------------------------------

    def _outer_step(self, bundle: Bundle, tel):
        """``sweeps_per_outer`` sweep calls: no host sync."""
        eng, st = self.engine, bundle.st
        # latch the entering state's health: the kernels overwrite an
        # updated site whatever it held, and the carry's own latch sees
        # only the states the sweeps return
        torch.maximum(tel.bad_state,
                      state_health(st.x, _cache(st), eng.graph.D),
                      out=tel.bad_state)
        marg = bundle.marg
        if marg is not None and (self._weight is None
                                 or self._weight.shape != st.x.shape
                                 or self._weight.device != marg.device):
            self._weight = torch.empty(st.x.shape, dtype=torch.float32,
                                       device=marg.device)
        for _ in range(self.cfg.sweeps_per_outer):
            st, tel = eng.sweep(st, tel)
            if marg is not None:
                accumulate_marginals(marg, st.x, self._weight)
        count = bundle.count
        return Bundle(st=st, marg=marg,
                      count=None if count is None
                      else count + self.cfg.sweeps_per_outer), tel

    def _healthy(self, bundle: Bundle, tel, step: int):
        """ONE host read per outer step of the device-resident guards
        (after one all-reduce on the dist backend).  Returns ``(ok,
        report)`` -- the report is the same host read, so metric gauges
        piggyback it for free."""
        eng = self.engine
        bad = torch.maximum(tel.bad_state, state_health(
            bundle.st.x, _cache(bundle.st), eng.graph.D))
        if self._dist:
            # the verdict every rank shares, from one all-reduce (a sum:
            # gloo reduces card tensors by sum only) of (bad_state,
            # 1 - windowed acceptance): any bad rank marks every rank, and
            # the acceptance is the mean over the mesh's ranks
            wp, wa = tel.win_prop, tel.win_acc
            win = torch.where(wp > 0, wa / wp.clamp_min(1e-30),
                              torch.ones_like(wp))
            buf = torch.stack([bad, 1.0 - win])
            dist.all_reduce(buf, group=self._group())
            bad_v, miss = buf.tolist()
            size = self.engine.mesh.size()
            rep = {"bad_state": bad_v > 0.0,
                   "win_acceptance": 1.0 if eng.exact_accept
                   else 1.0 - miss / size}
        else:
            host = torch.stack([bad, tel.win_prop, tel.win_acc]).cpu()
            rep = health_report(tel._replace(
                bad_state=host[0], win_prop=host[1], win_acc=host[2]),
                eng.exact_accept)
        if rep["bad_state"]:
            self._incident("health", guard="bad_state", outer_step=step)
            return False, rep
        if (not eng.exact_accept and step >= self.cfg.floor_after
                and rep["win_acceptance"] < self.cfg.acceptance_floor):
            self._incident("health", guard="acceptance_floor",
                           outer_step=step,
                           win_acceptance=rep["win_acceptance"])
            return False, rep
        return True, rep

    def _apply_faults(self, bundle: Bundle, step: int) -> Bundle:
        if self.plan is None:
            return bundle
        for f in self.plan.take(step):
            self._incident("fault", outer_step=step, fault=f.to_dict())
            if f.kind == "preempt":
                raise SimulatedPreemption(f"injected at outer step {step}")
            if f.kind == "device-loss":
                raise SimulatedDeviceLoss(f.keep)
            if f.kind == "corrupt":
                if self.cfg.ckpt_dir and self._lead:
                    ckpt.wait_pending()
                    corrupt_checkpoint(self.cfg.ckpt_dir, f.target,
                                       self.plan.rng(step))
            elif f.kind == "nan":
                kw = {}
                if self._dist:        # drawn over all chains, as on one
                    dp_index = self._coords()[0]     # device
                    c_loc = bundle.st.x.shape[0]
                    kw = dict(chains=self.cfg.chains,
                              chain0=dp_index * c_loc)
                bundle = bundle._replace(st=inject_state_fault(
                    bundle.st, f, self.plan.rng(step), **kw))
        return bundle

    # -- the supervision loop -----------------------------------------------

    def run(self) -> RunResult:
        cfg = self.cfg
        rec = get_recorder()
        bundle, tel, step = self._recover("start")
        while step < cfg.outer_steps:
            try:
                bundle = self._apply_faults(bundle, step)
                # one span per outer step: the chunk dispatch plus the
                # health read that retires it (the loop's ONE host sync,
                # which metric gauges below piggyback)
                with rec.span("sweep_chunk", step=step, **self._labels):
                    with self._watchdog:
                        new_bundle, new_tel = self._outer_step(bundle, tel)
                    ok, rep = self._healthy(new_bundle, new_tel, step)
                if not ok:
                    self._strikes += 1
                    self.rollbacks += 1
                    rec.count("rollbacks_total", 1, **self._labels)
                    if self._strikes > cfg.max_strikes:
                        self._escalate()
                    with rec.span("rollback_recover", **self._labels):
                        bundle, tel, step = self._recover("rollback")
                    if self._on_rollback is not None:
                        self._on_rollback(step, bundle, tel, self.engine)
                    rec.snapshot()
                    continue
                bundle, tel = new_bundle, new_tel
                step += 1
                self._strikes = 0
                self._budget.note_success()
                self._backoff.reset()
                if self._heartbeat is not None:
                    self._heartbeat.beat(step)
                eng = self.engine
                rec.count("sweeps_total", cfg.sweeps_per_outer,
                          **self._labels)
                rec.count("updates_total",
                          cfg.sweeps_per_outer * eng.updates_per_call,
                          **self._labels)
                rec.gauge("acceptance",
                          1.0 if eng.exact_accept
                          else float(rep["win_acceptance"]), **self._labels)
                rec.gauge("heartbeat_step", step, **self._labels)
                if cfg.ckpt_dir and (step % cfg.ckpt_every == 0
                                     or step == cfg.outer_steps):
                    self._save(step, bundle)
                rec.snapshot()
                if (self._on_step is not None
                        and self._on_step(step, bundle, tel,
                                          self.engine) is False):
                    break
            except Exception as e:     # noqa: BLE001 -- supervision boundary
                if isinstance(e, SimulatedDeviceLoss) and self._dist:
                    mp = self._coords()[3]
                    if e.keep % mp:
                        raise ValueError(
                            f"device loss keeps {e.keep} ranks, not a "
                            f"multiple of the {mp} model shards: the graph's "
                            f"columns cannot be re-sharded onto them") from e
                self._budget.consume()
                if self._budget.exhausted:
                    self._incident("giveup", error=repr(e))
                    raise
                self._incident("restart", outer_step=step, error=repr(e),
                               restart=self._budget.used,
                               backoff_s=self._backoff.next_delay())
                rec.count("restarts_total", 1, **self._labels)
                self._backoff.wait()
                if isinstance(e, SimulatedDeviceLoss):
                    self.ranks = self.ranks[:e.keep]
                    self._swap_engine(self.engine_name, note="elastic",
                                      **self.engine.params)
                    if self.engine is None:
                        return self._left(step, tel)
                with rec.span("restart_recover", **self._labels):
                    bundle, tel, step = self._recover("restart")
                if self._on_rollback is not None:
                    self._on_rollback(step, bundle, tel, self.engine)
                rec.snapshot()
        ckpt.wait_pending()
        return RunResult(
            state=bundle.st, marginals=self._marginals(bundle),
            outer_steps=step, restarts=self._budget.total,
            rollbacks=self.rollbacks, incidents=self.incidents,
            engine=self.engine, telemetry=tel,
            watchdog=self._watchdog.stats())

    def _left(self, step: int, tel) -> RunResult:
        """The result of a rank the elastic restart left out."""
        ckpt.wait_pending()
        return RunResult(state=None, marginals=None, outer_steps=step,
                         restarts=self._budget.total,
                         rollbacks=self.rollbacks, incidents=self.incidents,
                         engine=None, telemetry=tel,
                         watchdog=self._watchdog.stats(), left=True)

    def _marginals(self, bundle: Bundle) -> np.ndarray:
        """(n, D) chain-averaged marginals; on the dist backend gathered
        over the mesh (every rank takes part)."""
        if self._dist:
            from .dist_gibbs import gather_marginals
            st = bundle.st
            marg, _ = gather_marginals(st, self.engine.mesh)
            cnt = max(st.count, 1)
            return marg.sum(0).cpu().numpy() / (cnt * marg.shape[0])
        cnt = max(bundle.count, 1)
        return (bundle.marg.sum(0).cpu().numpy()
                / (cnt * bundle.marg.shape[0]))


def _cache(st):
    """The chain state's cached energy, through an adaptive wrapper."""
    return getattr(getattr(st, "inner", st), "cache", None)
