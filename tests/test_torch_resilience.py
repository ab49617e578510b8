"""The port's serving resilience (``repro_torch.serving.resilience`` + the
pool's answer path) on the CPU: the counterpart of
``tests/test_resilience.py``.

  * the policies — admission, circuit breaker, degrade bounds — give the
    JAX classes' decisions on the same call sequences, under injected fake
    clocks (nothing sleeps to reach a breaker or a deadline state);
  * the pool: shedding with structured answers, a missed deadline and a
    cold lane falling to the exact rung, the structured refusal at the
    ladder's bottom, quarantine and the half-open probe (whose rewind
    restores the lane's generator), the background driver skipping a
    quarantined lane, the epoch fence re-forking lanes;
  * ``SupervisedDriver`` restarting then giving up, refilling its budget,
    stopping cleanly;
  * the sweep path: no host-sync operation in ``advance`` and the same
    operations with and without the resilience policies (the CPU form of
    ``tests/test_resilience.py:302-331``; its wall-clock overhead test is
    not copied, ``chip_smoke.py`` phase 11 times that overhead);
  * the chaos drill, and supervised serving under a fault plan: the
    resident's published snapshot bit-equal to a clean supervised run's,
    the epoch fence on the rollback.
Every test that starts a thread joins it with a deadline.
"""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.runtime.fault import Backoff as JBackoff  # noqa: E402
from repro.runtime.fault import RestartBudget as JRestartBudget  # noqa: E402
from repro.serving import resilience as jres  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import engine as engine_lib  # noqa: E402
from repro_torch.diagnostics import (FreshnessPolicy,  # noqa: E402
                                     exact_conditional_marginals)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime.fault import Backoff, RestartBudget  # noqa: E402
from repro_torch.runtime.faultinject import Fault, FaultPlan  # noqa: E402
from repro_torch.serving import (AdmissionController,  # noqa: E402
                                 AdmissionPolicy, BreakerPolicy, ChainPool,
                                 CircuitBreaker, DegradePolicy, Query,
                                 SupervisedDriver)
from repro_torch.serving import resilience as tres  # noqa: E402

WL = "hetero-pairs-24"
GRAPH = engine_lib.make_workload(WL, device="cpu").graph
# lenient gate: lanes go fresh within a few chunks, keeping tests fast
POLICY = FreshnessPolicy(max_rhat=2.0, min_ess_per_site=4.0, min_samples=4)
DEADLINE_S = 10.0                    # every thread is joined by then


class FakeClock:
    """Injectable monotonic clock; tests advance it explicitly."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


@pytest.fixture(autouse=True)
def _null_recorder():
    obs.set_recorder(obs.NullRecorder())
    yield
    obs.set_recorder(obs.NullRecorder())


def _pool(**kw):
    kw.setdefault("policy", POLICY)
    pool = ChainPool(seed=0, **kw)
    pool.register(WL, engine="gibbs", device="cpu", chains=16, sweep=24,
                  sweeps_per_chunk=8)
    return pool


# -- the policies against the JAX classes ------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_admission_decisions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 6))
    a = AdmissionController(AdmissionPolicy(max_pending=cap))
    b = jres.AdmissionController(jres.AdmissionPolicy(max_pending=cap))
    for _ in range(40):
        if rng.random() < 0.6:
            pri = rng.integers(-2, 3, int(rng.integers(0, 7))).tolist()
            assert a.admit(pri) == b.admit(pri)
        else:
            k = int(rng.integers(0, 5))
            a.release(k)
            b.release(k)
        assert a.in_flight == b.in_flight


@pytest.mark.parametrize("seed", range(4))
def test_breaker_decisions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(open_after=int(rng.integers(1, 4)),
              cooldown_s=float(rng.integers(0, 3)),
              acceptance_floor=float(rng.choice([0.0, 0.3])))
    ca, cb = FakeClock(), FakeClock()
    a = CircuitBreaker(BreakerPolicy(**kw), clock=ca)
    b = jres.CircuitBreaker(jres.BreakerPolicy(**kw), clock=cb)
    for _ in range(60):
        r = rng.random()
        if r < 0.5:
            rep = {"bad_state": bool(rng.random() < 0.4),
                   "win_acceptance": float(rng.random())}
            assert a.unhealthy(rep) == b.unhealthy(rep)
            h = not a.unhealthy(rep)
            assert a.record(h) == b.record(h)
        elif r < 0.8:
            assert a.allow_probe() == b.allow_probe()
        else:
            dt = float(rng.integers(0, 3))
            ca.advance(dt)
            cb.advance(dt)
        assert (a.state, a.strikes, a.open_count, a.opened_at, a.gauge) == \
            (b.state, b.strikes, b.open_count, b.opened_at, b.gauge)


@pytest.mark.parametrize("cls, kw", [
    ("AdmissionPolicy", dict(max_pending=0)),
    ("BreakerPolicy", dict(open_after=0)),
    ("BreakerPolicy", dict(cooldown_s=-1.0)),
])
def test_policy_validation_equals_jax(cls, kw):
    with pytest.raises(ValueError) as got:
        getattr(tres, cls)(**kw)
    with pytest.raises(ValueError) as want:
        getattr(jres, cls)(**kw)
    assert str(got.value) == str(want.value)


def test_policy_defaults_equal_jax():
    for cls in ("AdmissionPolicy", "BreakerPolicy", "DegradePolicy"):
        assert vars(getattr(tres, cls)()) == vars(getattr(jres, cls)())


def _crashing(calls):
    def body(stop):
        calls.append(1)
        raise RuntimeError("boom")
    return body


def test_supervised_driver_restarts_then_gives_up_like_jax():
    got, want = [], []
    d = SupervisedDriver(
        _crashing(got), budget=RestartBudget(max_restarts=2,
                                             refresh_after=None),
        backoff=Backoff(base=0.0, sleep_fn=lambda s: None),
        clock=FakeClock())
    j = jres.SupervisedDriver(
        _crashing(want), budget=JRestartBudget(max_restarts=2,
                                               refresh_after=None),
        backoff=JBackoff(base=0.0, sleep_fn=lambda s: None),
        clock=FakeClock())
    d._run()                                 # synchronously: no thread
    j._run()
    assert d.gave_up and d.restarts == 2 and len(got) == 3
    assert (d.gave_up, d.restarts, len(got)) == (j.gave_up, j.restarts,
                                                 len(want))


def test_supervised_driver_records_crash_and_giveup_events(tmp_path):
    rec = obs.Recorder(metrics_dir=str(tmp_path))
    d = SupervisedDriver(
        _crashing([]), budget=RestartBudget(max_restarts=1,
                                            refresh_after=None),
        backoff=Backoff(base=0.0, sleep_fn=lambda s: None),
        recorder=rec, labels={"workload": WL})
    d._run()
    kinds = [e["name"] for e in rec.trace.events() if e.get("ph") == "i"]
    assert kinds == ["driver_crash", "driver_crash", "driver_giveup"]
    assert rec.metrics.value("driver_restarts_total", workload=WL) == 1


def test_supervised_driver_clean_stop_is_not_a_crash():
    beats = []

    def body(stop):
        while not stop.is_set():
            d.beat()
            beats.append(1)
            stop.wait(0.001)

    d = SupervisedDriver(body)
    d.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        while time.monotonic() < deadline and not beats:
            time.sleep(0.005)
        assert d.alive()
    finally:
        d.stop(timeout=DEADLINE_S)
    assert not d.gave_up and d.restarts == 0
    assert not d.alive()


def test_note_progress_refreshes_budget_and_backoff_like_jax():
    runs = []
    for mod, budget, backoff in ((tres, RestartBudget, Backoff),
                                 (jres, JRestartBudget, JBackoff)):
        sleeps = []
        d = mod.SupervisedDriver(
            lambda stop: None,
            budget=budget(max_restarts=1, refresh_after=2),
            backoff=backoff(base=0.5, sleep_fn=sleeps.append))
        d.budget.consume()
        d.backoff.wait()
        used = d.budget.used
        d.note_progress()
        d.note_progress()                    # 2 successes: budget refills
        d.backoff.wait()                     # streak reset
        runs.append((used, d.budget.used, sleeps))
    assert runs[0] == runs[1] == (1, 0, [0.5, 0.5])


# -- pool: shedding, deadlines, ladder ---------------------------------------

def test_saturated_pool_sheds_with_structured_answers():
    pool = _pool(admission=AdmissionPolicy(max_pending=2))
    pool.advance(WL, chunks=2)
    qs = [Query(WL, priority=p) for p in (0, 5, 0, 5)]
    answers = pool.submit(qs, max_extra_sweeps=0)
    assert [a.status for a in answers] == ["shed", "ok", "shed", "ok"]
    shed = answers[0]
    assert not shed.fresh and shed.marginals is None
    assert "shed" in shed.report["reason"]
    assert pool.admission.in_flight == 0     # released after the batch


def test_deadline_miss_degrades_to_exact():
    pool = _pool(clock=FakeClock())          # frozen clock: t never moves
    ans = pool.submit([Query(WL, deadline_ms=0.0)])[0]
    assert ans.status == "ok" and ans.source == "exact"
    assert ans.report["deadline_missed"]
    np.testing.assert_allclose(
        ans.marginals, exact_conditional_marginals(GRAPH, [], []),
        atol=1e-12)


def test_cold_exact_rung_matches_enumeration_conditioned():
    pool = _pool()
    ev = ((0, 1), (5, 0))
    ans = pool.submit([Query(WL, evidence=ev)], max_extra_sweeps=0)[0]
    assert ans.status == "ok" and ans.source == "exact"
    exact = exact_conditional_marginals(GRAPH, [0, 5], [1, 0])
    np.testing.assert_allclose(ans.marginals, exact, atol=1e-12)
    for s, v in ev:
        assert ans.marginals[s][v] == 1.0


def test_ladder_bottom_is_structured_refusal():
    pool = _pool(degrade=DegradePolicy(exact_max_states=2))
    ans = pool.submit([Query(WL)], max_extra_sweeps=0)[0]
    assert ans.status == "refused" and ans.source is None
    assert ans.marginals is None
    assert "exceed" in ans.report["exact_refused"]


# -- pool: breakers ----------------------------------------------------------

def test_breaker_quarantine_and_probe_recovery():
    pool = _pool(breaker=BreakerPolicy(open_after=2, cooldown_s=0.0))
    w = pool.workload(WL)
    q = Query(WL)
    warm = pool.submit([q])[0]               # sweeps to fresh, sets last_good
    assert warm.fresh and warm.source == "fresh"
    good = np.asarray(warm.marginals)

    pool.inject_lane_fault(WL, target="cache")
    pool.advance(WL, chunks=1)               # the carry's guard latches

    a1 = pool.submit([q], max_extra_sweeps=0)[0]   # strike 1: degrade
    assert a1.status == "ok" and a1.source == "stale"
    assert a1.report["quarantined"] and np.isfinite(a1.marginals).all()
    assert w.resident.breaker.state == CircuitBreaker.CLOSED

    a2 = pool.submit([q], max_extra_sweeps=0)[0]   # strike 2: opens
    assert a2.source == "stale" and np.isfinite(a2.marginals).all()
    assert w.resident.breaker.state == CircuitBreaker.OPEN
    assert w.resident.quarantined
    # the degenerate snapshot is never served: stale answers come from the
    # last healthy snapshot, identical to the pre-fault estimate
    np.testing.assert_array_equal(a1.marginals, good)

    a3 = pool.submit([q])[0]                 # half-open probe: recovery
    assert w.resident.breaker.state == CircuitBreaker.CLOSED
    assert not w.resident.quarantined
    assert a3.status == "ok" and np.isfinite(a3.marginals).all()


def test_probe_rewinds_the_generator_to_the_last_good_snapshot():
    """The probe's chunk starts from the last healthy snapshot's state AND
    generator: it equals one chunk advanced from that snapshot in a pool
    that never saw the fault."""
    pool = _pool(breaker=BreakerPolicy(open_after=1, cooldown_s=0.0))
    w = pool.workload(WL)
    pool.submit([Query(WL)])
    good = w.resident.last_good
    pool.inject_lane_fault(WL, target="cache")
    pool.advance(WL, chunks=2)               # draws on past last_good
    pool.submit([Query(WL)], max_extra_sweeps=0)
    assert w.resident.breaker.state == CircuitBreaker.OPEN
    assert pool._probe(w, w.resident, obs.get_recorder(), "resident")
    ref = _pool()
    ref.publish(WL, good.st, good.tel, good.marg, good.count, good.sweeps)
    ref.advance(WL, chunks=1)
    a, b = pool.snapshot(WL), ref.snapshot(WL)
    assert torch.equal(a.st.x, b.st.x) and torch.equal(a.marg, b.marg)
    assert torch.equal(a.st.gen.get_state(), b.st.gen.get_state())


def test_driver_skips_quarantined_lanes():
    pool = _pool(breaker=BreakerPolicy(open_after=1, cooldown_s=1e9))
    w = pool.workload(WL)
    pool.submit([Query(WL)])                 # establish last_good
    pool.inject_lane_fault(WL, target="cache")
    pool.advance(WL, chunks=1)
    pool.submit([Query(WL)], max_extra_sweeps=0)
    assert w.resident.quarantined
    sweeps_before = w.resident.sweeps
    pool.start()
    try:
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline and not pool.driver.alive():
            time.sleep(0.01)
        assert pool.driver.alive()
        time.sleep(0.05)
    finally:
        pool.stop()
    assert w.resident.sweeps == sweeps_before
    assert not any(t.name == "pool-driver" for t in threading.enumerate())


def test_driver_advances_healthy_lanes_while_answers_are_read():
    """The driver thread advances every lane while this thread answers,
    with the interpreter switching threads often: every answer is
    structured, and every published snapshot holds as many samples as
    sweeps (a lost update between the threads would break it)."""
    pool = _pool()
    w = pool.workload(WL)
    sig = ((2, 1),)
    pool.submit([Query(WL, evidence=sig)], max_extra_sweeps=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pool.start()
    try:
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline and w.resident.sweeps < 64:
            ans = pool.submit([Query(WL), Query(WL, evidence=sig)],
                              max_extra_sweeps=0, serve_stale=True)
            assert [a.status for a in ans] == ["ok", "ok"]
            for lane in (w.resident, w.lanes[sig]):
                snap = lane.snap
                assert snap.count == snap.sweeps
        assert w.resident.sweeps >= 64 and w.lanes[sig].sweeps > 0
    finally:
        pool.stop()
        sys.setswitchinterval(interval)
    assert pool.driver is None and pool.admission.in_flight == 0
    assert not any(t.name == "pool-driver" for t in threading.enumerate())
    for lane in (w.resident, w.lanes[sig]):
        assert lane.snap.count == lane.snap.sweeps == lane.sweeps


# -- pool: epoch fence --------------------------------------------------------

def test_epoch_fence_drops_and_reforks_conditioned_lanes():
    pool = _pool()
    w = pool.workload(WL)
    sig = ((3, 1),)
    pool.submit([Query(WL, evidence=sig)], max_extra_sweeps=0)
    lane_before = w.lanes[sig]
    snap = w.resident.snap
    pool.invalidate(WL)                      # supervised owner rolled back
    assert w.fence_pending and not w.lanes
    pool.submit([Query(WL, evidence=sig)], max_extra_sweeps=0)
    assert w.lanes[sig].fork_epoch == 1
    pool.publish(WL, snap.st, snap.tel, snap.marg, snap.count, snap.sweeps)
    assert not w.fence_pending and w.epoch == 2 and not w.lanes
    pool.submit([Query(WL, evidence=sig)], max_extra_sweeps=0)
    lane_after = w.lanes[sig]
    assert lane_after is not lane_before
    assert lane_after.fork_epoch == w.epoch == 2


# -- the sweep path ------------------------------------------------------------

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _advance_ops(pool, chunks=2):
    with _Ops() as mode:
        pool.advance(WL, chunks=chunks)
    return mode.ops


def test_advance_path_zero_host_syncs_with_resilience_enabled():
    """No operation that reads a tensor's value on the host (``.item()``,
    ``bool(t)``: ``aten._local_scalar_dense``) runs while advancing, with
    breakers and admission armed."""
    pool = _pool(admission=AdmissionPolicy(max_pending=4),
                 breaker=BreakerPolicy(open_after=1))
    pool.submit([Query(WL, evidence=((0, 1),))], max_extra_sweeps=0)
    ops = _advance_ops(pool, chunks=3)
    assert ops and not [o for o in ops if "_local_scalar_dense" in o]


def test_chunk_ops_identical_with_and_without_resilience():
    plain = _pool()
    armed = _pool(admission=AdmissionPolicy(max_pending=2),
                  breaker=BreakerPolicy(open_after=1, cooldown_s=5.0),
                  degrade=DegradePolicy(max_stale_sweeps=1))
    a, b = _advance_ops(plain), _advance_ops(armed)
    assert a and a == b
    assert torch.equal(plain.snapshot(WL).st.x, armed.snapshot(WL).st.x)


# -- the chaos drill and supervised serving ----------------------------------

def test_chaos_serving_every_answer_structured_and_within_tolerance():
    pool = _pool(policy=FreshnessPolicy(max_rhat=1.15,
                                        min_ess_per_site=32.0,
                                        min_samples=128),
                 admission=AdmissionPolicy(max_pending=3),
                 breaker=BreakerPolicy(open_after=2, cooldown_s=0.0))
    sig = ((7, 1),)
    base = [Query(WL), Query(WL, evidence=sig, priority=1)]
    for a in pool.submit(base):
        assert a.fresh
    exact_by_sig = {(): exact_conditional_marginals(GRAPH, [], []),
                    sig: exact_conditional_marginals(GRAPH, [7], [1])}

    pool.inject_lane_fault(WL, sig, target="cache")
    pool.advance(WL, chunks=1)

    seen_status, seen_source = set(), set()
    for rnd in range(4):
        batch = base + [Query(WL, deadline_ms=0.0),
                        Query(WL, evidence=sig),
                        Query(WL, sites=(0, 1), kind="map")]
        answers = pool.submit(batch, max_extra_sweeps=0)
        assert len(answers) == len(batch)
        for ans in answers:
            assert ans.status in ("ok", "shed", "refused", "error")
            seen_status.add(ans.status)
            if ans.source:
                seen_source.add(ans.source)
            if ans.marginals is not None:
                assert np.isfinite(ans.marginals).all()
                np.testing.assert_allclose(
                    ans.marginals, exact_by_sig[ans.query.signature][
                        list(ans.query.sites)
                        if ans.query.sites is not None else slice(None)],
                    atol=0.16)
    assert "ok" in seen_status and "shed" in seen_status
    assert "stale" in seen_source
    w = pool.workload(WL)
    lane = w.lanes[sig]
    assert lane.breaker.open_count >= 1
    recovered = pool.submit([Query(WL, evidence=sig)])[0]
    assert recovered.status == "ok"
    assert lane.breaker.state == CircuitBreaker.CLOSED
    assert pool.admission.in_flight == 0


def test_launcher_chaos_drill_recovers():
    queries = [Query(WL), Query(WL, evidence=((4, 1),))]
    res = tserve.serve_batch(WL, queries, engine="gibbs", device="cpu",
                             chains=16, sweep=24, chunk=8, policy=POLICY,
                             breaker_open_after=1, chaos_lane_fault=True)
    chaos = res["chaos"]
    assert chaos["breaker_opens"] == 1
    assert chaos["breaker_state_after"] == "closed"
    assert set(chaos["degraded_statuses"]) == {"ok"}
    assert "stale" in chaos["degraded_sources"]
    assert chaos["recovered_statuses"] == ["ok", "ok"]


SUP_PLAN = [Fault(step=2, kind="preempt"),
            Fault(step=4, kind="nan", target="x")]


def _supervised(tmp_path, name, plan, rec=None):
    published = []
    pool = ChainPool(policy=POLICY, seed=0)
    orig = pool.publish

    def publish(*a):
        orig(*a)
        published.append(pool.snapshot(WL))
    pool.publish = publish
    with obs.using(rec or obs.NullRecorder()):
        res = tserve.serve_batch(
            WL, [Query(WL), Query(WL, evidence=((0, 1),))], engine="mgpmh",
            device="cpu", chains=8, sweep=24, chunk=4, policy=POLICY,
            supervise=True, ckpt_dir=str(tmp_path / name), outer_steps=6,
            pool=pool, fault_plan=plan)
    return res, published


def test_supervised_serving_bit_equal_to_a_clean_run(tmp_path):
    rec = obs.Recorder(metrics_dir=str(tmp_path / "m"))
    res, snaps = _supervised(tmp_path, "fault", FaultPlan(list(SUP_PLAN)),
                             rec)
    clean, clean_snaps = _supervised(tmp_path, "clean", None)
    assert [a["status"] for a in res["answers"]] == ["ok", "ok"]
    assert res["answers"][1]["marginals"][0] == [0.0, 1.0]
    fences = [e for e in rec.trace.events() if e["name"] == "epoch_fence"]
    assert len(fences) == 2                  # the restart and the rollback
    # the last snapshot published by each run, at the same outer step
    a, b = snaps[-1], clean_snaps[-1]
    assert a.sweeps == b.sweeps == 6 * 4
    assert torch.equal(a.st.x, b.st.x) and torch.equal(a.marg, b.marg)
    assert torch.equal(a.st.gen.get_state(), b.st.gen.get_state())
    assert a.count == b.count == 24
