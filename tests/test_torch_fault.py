"""The port's restart policy (``repro_torch.runtime.fault``, a copy of the
JAX package's) and deterministic fault injection
(``repro_torch.runtime.faultinject``), held to the JAX package's modules:
the same budget and backoff sequences, the same plan JSON byte for byte and
the same per-step generators, ``corrupt_checkpoint`` damaging the same
bytes, ``inject_state_fault`` picking the same chain, site and code."""
import filecmp
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import faultinject as jfi  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.runtime.fault import (Backoff, RestartBudget,  # noqa: E402
                                       run_with_restarts)
from repro_torch.runtime.faultinject import (  # noqa: E402
    Fault, FaultPlan, SimulatedDeviceLoss, SimulatedPreemption,
    corrupt_checkpoint, inject_state_fault)

BAD = int(np.iinfo(np.int32).min // 2)


# -- restart budget and backoff ------------------------------------------------

def test_budget_exhausts_on_crash_loop():
    b = RestartBudget(max_restarts=2, refresh_after=4)
    b.consume()
    b.consume()
    assert not b.exhausted
    b.consume()
    assert b.exhausted and b.total == 3


def test_budget_refreshes_after_sustained_progress():
    b = RestartBudget(max_restarts=2, refresh_after=3)
    b.consume()
    b.consume()
    for _ in range(3):
        b.note_success()
    assert b.used == 0
    b.consume(); b.note_success(); b.note_success(); b.consume()  # noqa
    assert b.used == 2 and b.total == 4


def test_budget_fixed_lifetime_mode():
    b = RestartBudget(max_restarts=1, refresh_after=None)
    for _ in range(100):
        b.note_success()
    b.consume()
    b.consume()
    assert b.exhausted


def test_backoff_exponential_with_injected_clock():
    slept = []
    b = Backoff(base=0.5, factor=2.0, max_delay=3.0, sleep_fn=slept.append)
    for _ in range(4):
        b.wait()
    assert slept == [0.5, 1.0, 2.0, 3.0]
    b.reset()
    b.wait()
    assert slept[-1] == 0.5
    zero = []
    b = Backoff(base=0.0, sleep_fn=zero.append)
    b.wait()
    b.wait()
    assert zero == []


@pytest.mark.parametrize("refresh", [None, 2, 3])
def test_budget_and_backoff_sequences_equal_jax(refresh):
    """One script of successes and failures through both packages' policy
    objects: the same budget states and the same sleeps."""
    script = "FFSFSSSFFFSSSSF"
    got = []
    for mod in (jfault, __import__("repro_torch.runtime.fault",
                                   fromlist=["x"])):
        slept = []
        b = mod.RestartBudget(max_restarts=3, refresh_after=refresh)
        k = mod.Backoff(base=0.25, factor=3.0, max_delay=2.0,
                        sleep_fn=slept.append)
        trace = []
        for c in script:
            if c == "F":
                b.consume()
                k.wait()
            else:
                b.note_success()
                k.reset()
            trace.append((b.used, b.total, b.exhausted, k.failures,
                          k.next_delay()))
        got.append((trace, slept))
    assert got[0] == got[1]


def test_run_with_restarts_resumes_and_reraises():
    saved = {}
    crashed = []

    def stepper(state, step_no):
        if step_no == 5 and not crashed:
            crashed.append(step_no)
            raise RuntimeError("preempted")
        saved["state"], saved["step"] = state + 1, step_no + 1
        return state + 1

    state, restarts = run_with_restarts(
        lambda: 0, stepper, num_steps=10, max_restarts=2,
        on_restart=lambda s: (saved["state"], saved["step"]))
    assert state == 10 and restarts == 1
    slept = []
    calls = []

    def flaky(state, s):
        calls.append(s)
        if len(calls) <= 2:
            raise RuntimeError("flaky start")
        return state + 1
    run_with_restarts(lambda: 0, flaky, num_steps=2, max_restarts=3,
                      on_restart=lambda s: (0, 0), backoff_base=1.0,
                      backoff_factor=3.0, sleep_fn=slept.append)
    assert slept == [1.0, 3.0]
    with pytest.raises(RuntimeError, match="hard down"):
        run_with_restarts(lambda: 0, lambda st, s: (_ for _ in ()).throw(
            RuntimeError("hard down")), num_steps=3, max_restarts=1,
            on_restart=lambda s: (0, 0))


def test_fault_module_is_a_copy_not_an_import():
    import repro_torch.runtime.fault as tfault
    assert tfault.RestartBudget is not jfault.RestartBudget
    src = open(tfault.__file__).read()
    assert "import repro" not in src and "from repro" not in src


# -- fault plans ----------------------------------------------------------------

def test_fault_validation():
    for kw in (dict(kind="meteor"), dict(kind="corrupt", target="all"),
               dict(kind="nan", target="weights"),
               dict(kind="device-loss", keep=0)):
        with pytest.raises(ValueError):
            Fault(step=0, **kw)


def test_plan_take_is_one_shot_and_records_fired():
    plan = FaultPlan([Fault(step=2, kind="preempt"),
                      Fault(step=2, kind="nan", target="x", once=False)])
    assert [f.kind for f in plan.take(2)] == ["preempt", "nan"]
    assert [f.kind for f in plan.take(2)] == ["nan"]
    assert plan.take(3) == []
    assert [r["kind"] for r in plan.fired] == ["preempt", "nan", "nan"]
    assert [f.kind for f in plan.pending()] == ["nan"]


def _plans():
    faults = [dict(step=1, kind="corrupt", target="arrays"),
              dict(step=2, kind="preempt"),
              dict(step=3, kind="nan", target="cache", mode="inf"),
              dict(step=4, kind="device-loss", keep=4, once=False)]
    return (FaultPlan([Fault(**f) for f in faults], seed=9),
            jfi.FaultPlan([jfi.Fault(**f) for f in faults], seed=9))


def test_plan_json_is_the_jax_packages_byte_for_byte(tmp_path):
    plan, jplan = _plans()
    assert plan.to_json() == jplan.to_json()
    for text in (plan.to_json(), '[{"step": 0, "kind": "preempt"}]'):
        a, b = FaultPlan.from_json(text), jfi.FaultPlan.from_json(text)
        assert [f.to_dict() for f in a.faults] == [f.to_dict()
                                                   for f in b.faults]
        assert a.seed == b.seed
    p = tmp_path / "plan.json"
    p.write_text(jplan.to_json())
    assert FaultPlan.from_json(str(p)).to_json() == jplan.to_json()


def test_plan_rng_draws_equal_jax():
    plan, jplan = _plans()
    for step in (0, 1, 7, 123):
        a, b = plan.rng(step), jplan.rng(step)
        assert np.array_equal(a.integers(0, 1 << 30, 16),
                              b.integers(0, 1 << 30, 16))
    assert plan.rng(5).integers(0, 1 << 30) != FaultPlan(
        [], seed=4).rng(5).integers(0, 1 << 30)


# -- fault application ----------------------------------------------------------

def test_corrupt_checkpoint_trips_verify(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.arange(12, dtype=torch.int32)}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, tree)
    path = corrupt_checkpoint(d, "arrays", np.random.default_rng(0))
    assert "step_00000002" in path
    assert ckpt.verify(d, 2) != [] and ckpt.verify(d, 1) == []
    assert ckpt.latest_good_step(d) == 1
    assert corrupt_checkpoint(d, "manifest").endswith("manifest.json")
    assert ckpt.latest_step(d) == 1
    assert corrupt_checkpoint(str(tmp_path / "empty"), "arrays") == ""


@pytest.mark.parametrize("target", ["arrays", "manifest"])
def test_corrupt_checkpoint_damages_the_same_bytes_as_jax(tmp_path, target):
    d = str(tmp_path / "a")
    ckpt.save(d, 3, {"x": torch.arange(4000, dtype=torch.int32),
                     "w": torch.linspace(0, 1, 999)})
    e = str(tmp_path / "b")
    shutil.copytree(d, e)
    plan, jplan = _plans()
    p = corrupt_checkpoint(d, target, plan.rng(3))
    q = jfi.corrupt_checkpoint(e, target, jplan.rng(3))
    assert os.path.relpath(p, d) == os.path.relpath(q, e)
    assert filecmp.cmp(p, q, shallow=False)


def _states(name="mgpmh", C=4, adaptive=False):
    g = engine.make_workload("hetero-pairs-24", device="cpu").graph
    jg = jengine.make_workload("hetero-pairs-24").graph
    sched = (dict(schedule=engine.AdaptiveScan(sweep_len=2)) if adaptive
             else dict(sweep=2))
    jsched = (dict(schedule=jengine.AdaptiveScan(sweep_len=2)) if adaptive
              else dict(sweep=2))
    st = engine.make(name, g, device="cpu", **sched).init(0, C)
    jst = jengine.make(name, jg, backend="jnp", **jsched).init(
        jax.random.PRNGKey(0), C)
    return st, jst


@pytest.mark.parametrize("target", ["x", "cache"])
def test_inject_state_fault_picks_what_jax_picks(target):
    st, jst = _states("min-gibbs", C=6)
    f = dict(step=0, kind="nan", target=target,
             mode="inf" if target == "cache" else "nan")
    bad = inject_state_fault(st, Fault(**f), np.random.default_rng(11))
    jbad = jfi.inject_state_fault(jst, jfi.Fault(**f),
                                  np.random.default_rng(11))
    got = getattr(bad, target).numpy()
    want = np.asarray(getattr(jbad, target))
    before = getattr(st, target).numpy()
    changed = np.argwhere(~np.isclose(got, before, equal_nan=False)
                          | ~np.isfinite(got))
    jchanged = np.argwhere(~np.isclose(want, np.asarray(getattr(jst,
                                                                target)))
                           | ~np.isfinite(want))
    assert np.array_equal(changed, jchanged) and len(changed) == 1
    idx = tuple(changed[0])
    if target == "x":
        assert got[idx] == want[idx] == BAD
    else:
        assert np.isinf(got[idx]) and np.isinf(want[idx])
    # the leaf that was not targeted is untouched
    other = "cache" if target == "x" else "x"
    assert torch.equal(getattr(bad, other), getattr(st, other))


def test_inject_state_fault_recurses_into_adaptive_wrapper():
    st, _ = _states("gibbs", adaptive=True)
    assert hasattr(st, "inner")
    bad = inject_state_fault(st, Fault(step=0, kind="nan", target="x"),
                             np.random.default_rng(1))
    assert int(bad.x.min()) == BAD and type(bad) is type(st)


def test_inject_state_fault_on_a_rank_writes_only_its_chains():
    """On the dist backend the chain is drawn over all chains; only the
    rank holding it writes it (the other rank's x is untouched)."""
    st, _ = _states("gibbs", C=4)
    f = Fault(step=0, kind="nan", target="x")
    whole = inject_state_fault(st, f, np.random.default_rng(5))
    c = int(torch.nonzero(whole.x == BAD)[0, 0])
    for chain0 in (0, 4):                       # rank A chains 0-3, B 4-7
        part = inject_state_fault(st, f, np.random.default_rng(5),
                                  chains=8, chain0=chain0)
        hit = bool((part.x == BAD).any())
        c_all = int(np.random.default_rng(5).integers(0, 8))
        assert hit == (chain0 <= c_all < chain0 + 4)
    assert c == int(np.random.default_rng(5).integers(0, 4))


def test_simulated_faults_are_runtime_errors():
    with pytest.raises(RuntimeError):
        raise SimulatedPreemption("boom")
    e = SimulatedDeviceLoss(2)
    assert isinstance(e, RuntimeError) and e.keep == 2
