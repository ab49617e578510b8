"""The port's supervised runtime (``repro_torch.runtime.supervisor``) on the
CPU, held to itself and to the JAX package's ``repro.runtime.supervisor``.

  * out-of-domain site codes: every op of the supervised path that indexes
    by a site value -- the marginal accumulation, the plain sweeps of
    ``kernels/ref.py``, the single-site steps of ``core/samplers.py``, the
    dist backend's global partials and recursion -- completes on a state
    holding a code outside [0, D) and ignores the code: two different such
    codes give the same result (the code itself aside), and the other
    chains are the clean run's;
  * crash-resume within the port: preempt, arrays-corrupt,
    manifest-corrupt and ``nan`` faults end bit-equal (marginals and x) to
    the clean supervised run, every ``nan`` fault a ``health`` incident and
    no ``restart`` (gibbs, mgpmh, min-gibbs, doublemin); the incident
    kinds equal the JAX ``SupervisedRun``'s on the same plans;
  * both packages' marginals within Monte Carlo error of the exact ones;
  * escalation (degrade, retune), a fresh process adopting the degraded
    engine, budget exhaustion, ``reshard_dp`` (equal to the JAX
    package's), heartbeat and the incident stream;
  * the launcher's ``--supervise --fault-plan --ckpt-dir`` and a plain
    ``--ckpt-dir`` rerun on ``--device cpu``.
The gloo (dist) scenarios are in ``test_torch_dist.py``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import engine as jengine  # noqa: E402
from repro.runtime import supervisor as jsup  # noqa: E402
from repro.runtime.faultinject import Fault as JFault  # noqa: E402
from repro.runtime.faultinject import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import samplers as S  # noqa: E402
from repro_torch.core.chains import (accumulate_marginals,  # noqa: E402
                                     run_marginal_experiment)
from repro_torch.kernels import parity_inputs as P  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import gibbs as tlaunch  # noqa: E402
from repro_torch.runtime import dist_gibbs as DG  # noqa: E402
from repro_torch.runtime.faultinject import Fault, FaultPlan  # noqa: E402
from repro_torch.runtime.supervisor import (SupervisedRun,  # noqa: E402
                                            SupervisorConfig, reshard_dp)

WORKLOAD = "hetero-pairs-24"
GRAPH = engine.make_workload(WORKLOAD, device="cpu").graph
JGRAPH = jengine.make_workload(WORKLOAD).graph
BAD = int(np.iinfo(np.int32).min // 2)     # the supervisor's nan-x code
ENGINES = ("gibbs", "mgpmh", "min-gibbs", "doublemin")


@pytest.fixture(autouse=True)
def _null_recorder():
    obs.set_recorder(obs.NullRecorder())
    yield
    obs.set_recorder(obs.NullRecorder())


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- out-of-domain codes: the op completes and ignores the code ---------------

def _corrupt(x, code, sites):
    """A copy of x with chain c's site ``sites[c]`` set to ``code`` for
    the first ``len(sites)`` chains."""
    x = x.clone()
    for c, i in enumerate(sites):
        x[c, i] = code
    return x


def _same_but_codes(a, b, x_a, x_b):
    """a and b equal wherever the inputs held no out-of-domain code; where
    they did, each output holds its input's code or the same new value."""
    keep = (x_a == x_b)
    assert torch.equal(a[keep], b[keep])
    moved_a, moved_b = a[~keep] != x_a[~keep], b[~keep] != x_b[~keep]
    assert torch.equal(moved_a, moved_b)
    assert torch.equal(a[~keep][moved_a], b[~keep][moved_b])


def test_accumulate_marginals_ignores_out_of_domain_codes():
    x = torch.tensor([[0, 2, BAD, 1], [3, -1, 2, 5]], dtype=torch.int32)
    marg = torch.zeros((2, 4, 3))
    accumulate_marginals(marg, x, torch.empty((2, 4)))
    want = torch.zeros((2, 4, 3))
    for c in range(2):
        for j in range(4):
            if 0 <= int(x[c, j]) < 3:
                want[c, j, int(x[c, j])] = 1.0
    assert torch.equal(marg, want)


def test_runner_completes_on_an_out_of_domain_state():
    """``run_marginal_experiment`` accumulates around a corrupt site: the
    site's rows sum to the calls in which it held a valid value."""
    eng = engine.make("gibbs", GRAPH, sweep=1, device="cpu")
    st = eng.init(0, 4)
    st = st._replace(x=_corrupt(st.x, BAD, [5, 5, 5, 5]))
    tr = run_marginal_experiment(eng, st, n_iters=6, n_snapshots=2)
    rows = tr.marg.sum(-1)                      # (C, n)
    assert torch.all(rows[:, [j for j in range(GRAPH.n) if j != 5]] == 6)
    assert (rows[:, 5] < 6).any() and torch.all(rows[:, 5] <= 6)


def _sweep_pair(run, x, sites, D):
    """``run(x)`` on x with two different out-of-domain codes at ``sites``
    (chain c, site sites[c]) and on the clean x: results agree but for the
    codes, the untouched chains equal the clean run's."""
    x_a = _corrupt(x, BAD, sites)
    x_b = _corrupt(x, D + 3, sites)
    out_a, out_b, out_c = run(x_a), run(x_b), run(x)
    _same_but_codes(out_a[0], out_b[0], x_a, x_b)
    for a, b in zip(out_a[1:], out_b[1:]):
        assert torch.equal(a, b)
    k = len(sites)
    assert torch.equal(out_a[0][k:], out_c[0][k:])
    return out_a, x_a


def test_mgpmh_sweep_ref_ignores_out_of_domain_codes():
    C, S_, K, D, n = 4, 5, 17, 3, 11
    x, W, rp, ra, i, B, u1, u2, g, lu = _t(*P.mgpmh_inputs(C, S_, K, D, n))
    sites = [int(i[0, 0]), int(i[1, 0])]        # updated at sub-step 0
    _sweep_pair(lambda xx: ref.mgpmh_sweep_ref(
        xx, W, rp, ra, i, B, u1, u2, g, lu, D, 0.5), x, sites, D)


def test_min_gibbs_sweep_ref_ignores_out_of_domain_codes():
    C, S_, K, D, n = 4, 5, 17, 3, 11
    a = _t(*P.min_gibbs_inputs(C, S_, K, D, n))
    x, i = a[0], a[5]
    sites = [int(i[0, 0]), int(i[1, 0])]
    _sweep_pair(lambda xx: ref.min_gibbs_sweep_ref(xx, *a[1:], D, 0.7),
                x, sites, D)


def test_double_min_sweep_ref_ignores_out_of_domain_codes():
    C, S_, K1, K2, D, n = 4, 5, 17, 9, 3, 11
    a = _t(*P.double_min_inputs(C, S_, K1, K2, D, n))
    x, i = a[0], a[5]
    sites = [int(i[0, 0]), int(i[1, 0])]
    _sweep_pair(lambda xx: ref.double_min_sweep_ref(xx, *a[1:], D, 0.5,
                                                    0.7), x, sites, D)


@pytest.mark.parametrize("name", ["mgpmh", "min-gibbs", "doublemin"])
def test_single_site_steps_ignore_out_of_domain_codes(name):
    """The single-site reference steps (``make_*_step``) on a state with a
    corrupt value at every site of chain 0: they complete, and the other
    chains move as on the clean state."""
    g = GRAPH
    lam, cap = 8.0, 40
    make = {"mgpmh": lambda: S.make_mgpmh_step(g, lam, cap),
            "min-gibbs": lambda: S.make_min_gibbs_step(g, lam, cap),
            "doublemin": lambda: S.make_double_min_step(g, lam, cap, lam,
                                                        cap)}[name]
    step = make()

    def run(x):
        gen = torch.Generator().manual_seed(4)
        st = S.init_state(gen, g, 3)._replace(x=x)
        for _ in range(6):
            st = step(st)
        return st.x
    x = torch.zeros((3, g.n), dtype=torch.int32)
    bad = x.clone()
    bad[0] = BAD
    out, clean = run(bad), run(x)
    assert torch.equal(out[1:], clean[1:])
    assert ((out[0] == BAD) | ((out[0] >= 0) & (out[0] < g.D))).all()


def test_min_gibbs_select_and_at_code_skip_out_of_domain_codes():
    eps = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    xi = torch.tensor([BAD, 1], dtype=torch.int32)
    assert torch.equal(S.at_code(eps, xi), torch.tensor([0.0, 5.0]))
    v, cache = S.min_gibbs_select(eps, torch.tensor([9.0, 9.0]), xi,
                                  torch.zeros((2, 3)), torch.arange(2))
    assert v.tolist() == [2, 1] and cache.tolist() == [3.0, 9.0]


def _shard_setup(algo, seed=0, C=4, S_=5, U=1):
    g = engine.make_workload("potts-20x20", device="cpu").graph
    gs = DG.ShardedMatchGraph.from_graph(g, 1, 0)
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randint(0, g.D, (C, g.n), generator=gen, dtype=torch.int32)
    i = torch.randint(0, g.n, (C, S_), generator=gen, dtype=torch.int32)
    return g, gs, gen, x0, i


def test_dist_global_partials_ignore_out_of_domain_codes():
    """``_global_partials`` with a corrupt free endpoint: the op completes,
    the code counts in no n1 value slot (two codes give the same counts)
    and the draws that reach it lose their n1 count."""
    g, gs, gen, x0, i = _shard_setup("min-gibbs")
    C, S_ = i.shape
    draws = DG._global_draws(gs, gen, C, S_, g.D, 4000.0, 4100)
    # the strongest neighbour of chain 0's first sweep site (outside its
    # sweep): the free endpoint of some of the 4000 draws
    w = g.W[int(i[0, 0])].clone()
    w[i[0].long()] = 0.0
    site = int(w.argmax())
    outs = [DG._global_partials(gs, _corrupt(x0, code, [site]), i, draws)
            for code in (BAD, g.D + 3)]
    clean = DG._global_partials(gs, x0, i, draws)
    for p, q in zip(*outs):
        assert torch.equal(p, q)
    assert outs[0][1].sum() < clean[1].sum()
    assert torch.equal(outs[0][1][1:], clean[1][1:])   # other chains


@pytest.mark.parametrize("algo", ["mgpmh", "min-gibbs", "doublemin"])
def test_dist_recursion_ignores_out_of_domain_codes(algo):
    """The replicated recursion with a corrupt value at chain 0's first
    sweep site: completes; two codes give the same chain; the other chains
    are the clean run's."""
    g, gs, gen, x0, i = _shard_setup(algo)
    C, S_ = i.shape
    lam = 40.0
    kw = dict(lam=lam, capacity=80, lam2=400.0, capacity2=500)
    if algo == "min-gibbs":
        kw = dict(lam2=400.0, capacity2=500)
    parts = DG._local_partials(gs, algo, x0, i, gen, 0, **kw)
    gum = S.gumbel((C, S_, g.D), gen, "cpu")
    logu = torch.rand((C, S_), generator=gen).log_()
    cache = torch.rand((C,), generator=gen)
    lscale = S.min_gibbs_lscale(g.psi, 400.0)

    def run(x):
        # the partials are the clean state's: only the recursion is under
        # test here (the partials' own handling is the test above)
        out = DG._recursion(algo, parts, x, i, cache, gum, logu, g.D,
                            lscale)
        return out
    _sweep_pair(run, x0, [int(i[0, 0])], g.D)


# -- the supervised runtime, single device -------------------------------------

def _factory(sweep=4, **fixed):
    def make_engine(name, ranks, **params):
        return engine.make(name, GRAPH, sweep=sweep, device="cpu",
                           **{**fixed, **params})
    return make_engine


def _jfactory(sweep=4):
    def make_engine(name, devices, **params):
        return jengine.make(name, JGRAPH, sweep=sweep, backend="jnp",
                            **params)
    return make_engine


def _cfg(tmp_path, sub, **kw):
    base = dict(outer_steps=6, sweeps_per_outer=4, chains=8, seed=0,
                ckpt_dir=str(tmp_path / sub), backoff_base=0.0)
    base.update(kw)
    return SupervisorConfig(**base)


def _supervised(tmp_path, sub, plan=None, engine_name="mgpmh", factory=None,
                **kw):
    run = SupervisedRun(engine_name, factory or _factory(),
                        _cfg(tmp_path, sub, **kw), plan,
                        sleep_fn=lambda s: None)
    return run.run()


PLANS = {
    "preempt": [dict(step=3, kind="preempt")],
    "corrupt": [dict(step=3, kind="corrupt", target="arrays"),
                dict(step=3, kind="preempt")],
    "manifest": [dict(step=2, kind="corrupt", target="manifest"),
                 dict(step=2, kind="preempt")],
    "nan": [dict(step=2, kind="nan", target="x")],
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's SupervisedRun under each plan (incident kinds)."""
    out = {}
    for key, faults in PLANS.items():
        tmp = tmp_path_factory.mktemp(f"jax-{key}")
        cfg = jsup.SupervisorConfig(outer_steps=6, sweeps_per_outer=4,
                                    chains=8, seed=0, ckpt_dir=str(tmp),
                                    backoff_base=0.0)
        res = jsup.SupervisedRun(
            "mgpmh", _jfactory(), cfg,
            JFaultPlan([JFault(**f) for f in faults]),
            sleep_fn=lambda s: None).run()
        out[key] = [i["kind"] for i in res.incidents]
    return out


@pytest.fixture(scope="module")
def clean_runs(tmp_path_factory):
    return {name: _supervised(tmp_path_factory.mktemp(f"clean-{name}"),
                              "ck", engine_name=name)
            for name in ENGINES}


@pytest.mark.parametrize("key", sorted(PLANS))
def test_faulted_runs_bit_equal_and_kinds_equal_jax(tmp_path, key, jax_runs,
                                                    clean_runs):
    plan = FaultPlan([Fault(**f) for f in PLANS[key]])
    res = _supervised(tmp_path, key, plan)
    clean = clean_runs["mgpmh"]
    assert res.outer_steps == clean.outer_steps == 6
    assert np.array_equal(res.marginals, clean.marginals)
    assert torch.equal(res.state.x, clean.state.x)
    assert torch.equal(res.state.accepts, clean.state.accepts)
    assert not plan.pending()
    kinds = [i["kind"] for i in res.incidents]
    assert kinds == jax_runs[key], (kinds, jax_runs[key])
    if key == "corrupt":
        assert [d for d in os.listdir(tmp_path / key)
                if d.endswith(".corrupt")]
        assert any(i["kind"] == "restore" and i["source"] == "step_2"
                   for i in res.incidents)


@pytest.mark.parametrize("name", ENGINES)
def test_nan_x_rolls_back_as_health_never_restart(tmp_path, name,
                                                  clean_runs):
    plan = FaultPlan([Fault(step=2, kind="nan", target="x")])
    res = _supervised(tmp_path, "nan", plan, engine_name=name)
    kinds = [i["kind"] for i in res.incidents]
    assert "restart" not in kinds and res.restarts == 0
    assert res.rollbacks >= 1
    assert any(i["kind"] == "health" and i["guard"] == "bad_state"
               for i in res.incidents)
    clean = clean_runs[name]
    assert np.array_equal(res.marginals, clean.marginals)
    assert torch.equal(res.state.x, clean.state.x)


def test_nan_cache_rolls_back_bit_exact(tmp_path, clean_runs):
    plan = FaultPlan([Fault(step=2, kind="nan", target="cache", mode="inf")])
    res = _supervised(tmp_path, "cache", plan, engine_name="min-gibbs")
    assert any(i["kind"] == "health" for i in res.incidents)
    assert np.array_equal(res.marginals, clean_runs["min-gibbs"].marginals)


def test_guard_sees_a_code_the_first_sweep_overwrites(tmp_path, clean_runs):
    """A code injected into a site that the chunk's first sweep updates is
    gone from the state the sweep returns; the latch before the chunk
    still reports it."""
    eng = engine.make("gibbs", GRAPH, sweep=GRAPH.n * 4, device="cpu")

    def fresh():
        st = eng.init(0, 2)
        return st._replace(x=_corrupt(st.x, BAD, [0]))
    st = fresh()
    new, _ = eng.sweep(st, eng.init_telemetry(st))
    assert int(new.x[0, 0]) != BAD             # the first sweep overwrote it
    cfg = SupervisorConfig(outer_steps=1, sweeps_per_outer=1, chains=2)
    run = SupervisedRun("gibbs", lambda n, r, **p: eng, cfg)
    st = fresh()
    bundle = run._init_bundle()._replace(st=st)
    out, tel3 = run._outer_step(bundle, eng.init_telemetry(st))
    assert torch.equal(out.st.x, new.x)
    assert run._healthy(out, tel3, 0)[0] is False


def test_restart_budget_exhaustion_reraises(tmp_path):
    plan = FaultPlan([Fault(step=1, kind="preempt", once=False)])
    with pytest.raises(RuntimeError):
        _supervised(tmp_path, "doom", plan, max_restarts=2,
                    refresh_after=None)


def test_acceptance_floor_degrades_to_exact_gibbs(tmp_path):
    res = _supervised(tmp_path, "degrade", acceptance_floor=2.0,
                      floor_after=0, max_strikes=1, retune=False)
    assert res.engine.name == "gibbs" and res.outer_steps == 6
    assert any(i["kind"] == "degrade" for i in res.incidents)
    assert any(i["kind"] == "health" and i["guard"] == "acceptance_floor"
               for i in res.incidents)
    assert res.rollbacks >= 2
    assert res.marginals.shape == (GRAPH.n, GRAPH.D)
    np.testing.assert_allclose(res.marginals.sum(-1), 1.0, atol=1e-5)
    # a fresh run over the same directory adopts the degraded engine
    res2 = SupervisedRun("mgpmh", _factory(),
                         _cfg(tmp_path, "degrade", outer_steps=8),
                         sleep_fn=lambda s: None).run()
    assert res2.engine.name == "gibbs" and res2.outer_steps == 8


def test_a_failed_engine_swap_keeps_the_engine_and_its_name(tmp_path):
    """A swap whose build raises leaves the run on the engine it had, under
    that engine's name: the restart that follows resumes as it was."""
    def make_engine(name, ranks, **params):
        if name == "gibbs":
            raise RuntimeError("gibbs cannot be built here")
        return _factory()(name, ranks, **params)
    sup = SupervisedRun("mgpmh", make_engine, _cfg(tmp_path, "swap"),
                        sleep_fn=lambda s: None)
    with pytest.raises(RuntimeError):
        sup._swap_engine("gibbs", note="degrade")
    assert sup.engine_name == sup.engine.name == "mgpmh"


def test_collapsed_acceptance_retunes_lambda(tmp_path):
    """mgpmh on potts-20x20 at lambda 0.1 (the default is 4 L^2 = 104):
    the windowed acceptance (0.18) falls under the floor, the supervisor
    re-tunes lambda through autotune_lambda and the run ends on the tuned
    engine, its acceptance at least 0.5."""
    g = engine.make_workload("potts-20x20", device="cpu").graph

    def factory(name, ranks, **params):
        return engine.make(name, g, sweep=8, device="cpu",
                           **{"lam": 0.1, **params})
    res = _supervised(tmp_path, "retune", factory=factory,
                      acceptance_floor=0.5, floor_after=0, max_strikes=1)
    retunes = [i for i in res.incidents if i["kind"] == "retune"]
    assert retunes and res.engine.name == "mgpmh"
    assert res.engine.params["lam"] == retunes[-1]["lam"] > 0.1
    assert res.outer_steps == 6
    acc = res.state.accepts.double().mean() / (res.outer_steps * 4 * 8)
    assert float(acc) >= 0.5


def test_marginals_within_monte_carlo_error_of_exact(tmp_path):
    """Both packages' supervised mgpmh on hetero-pairs-24 (C=32, S=8, 20
    outer steps x 8): the second half's per-chain marginals, averaged,
    within 4.5 standard errors (between chains) of the exact 1/2."""
    def half(store, outer):
        def on_step(step, b, tel, eng):
            m = np.array(b.marg.cpu() if hasattr(b.marg, "cpu") else b.marg,
                         np.float64)
            if step == outer // 2:
                store["h"] = (m, float(b.count))
            if step == outer:
                store["m"] = ((m - store["h"][0])
                              / (float(b.count) - store["h"][1]))
        return on_step
    got = {}
    for pkg in ("torch", "jax"):
        store = {}
        if pkg == "torch":
            cfg = SupervisorConfig(outer_steps=20, sweeps_per_outer=8,
                                   chains=32, backoff_base=0.0)
            SupervisedRun("mgpmh", _factory(sweep=8), cfg,
                          sleep_fn=lambda s: None,
                          on_step=half(store, 20)).run()
        else:
            cfg = jsup.SupervisorConfig(outer_steps=20, sweeps_per_outer=8,
                                        chains=32, backoff_base=0.0)
            jsup.SupervisedRun("mgpmh", _jfactory(sweep=8), cfg,
                               sleep_fn=lambda s: None,
                               on_step=half(store, 20)).run()
        m = store["m"][..., 1]                      # (C, n)
        se = m.std(0, ddof=1) / np.sqrt(m.shape[0])
        got[pkg] = np.abs(m.mean(0) - 0.5) / np.maximum(se, 1e-3)
    assert got["torch"].max() < 4.5 and got["jax"].max() < 4.5, got


def test_reshard_dp_shrink_and_grow_equal_jax():
    import jax.numpy as jnp
    keys = np.arange(16, dtype=np.uint32).reshape(8, 2)
    counts = np.ones((8, 3), np.float32)
    cases = [(keys, np.zeros((4, 2), np.uint32)),
             (counts, np.zeros((4, 3), np.float32)),
             (keys[:2], np.zeros((5, 2), np.uint32)),
             (counts, np.zeros((3, 3), np.float32))]
    for a, like in cases:
        got = reshard_dp(a, like)
        want = np.asarray(jsup.reshard_dp(jnp.asarray(a), jnp.asarray(like)))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # tensors follow the same rules
        t = reshard_dp(torch.from_numpy(a.astype(np.int64) if a.dtype ==
                                        np.uint32 else a),
                       torch.from_numpy(like.astype(np.int64) if like.dtype
                                        == np.uint32 else like))
        assert np.array_equal(t.numpy(), want.astype(t.numpy().dtype))
    assert reshard_dp(keys, np.zeros((8, 2), np.uint32)) is keys
    with pytest.raises(ValueError):
        reshard_dp(np.zeros((8, 3)), np.zeros((4, 2)))


def test_heartbeat_and_incident_events_recorded(tmp_path):
    hb = str(tmp_path / "hb.json")
    plan = FaultPlan([Fault(step=1, kind="preempt")])
    rec = obs.Recorder(metrics_dir=str(tmp_path / "metrics"))
    with obs.using(rec):
        res = _supervised(tmp_path, "live", plan, heartbeat=hb)
    assert json.load(open(hb))["step"] == 6
    kinds = [i["kind"] for i in res.incidents]
    assert "fault" in kinds and "restart" in kinds and "restore" in kinds
    ev = (tmp_path / "metrics" / "events.jsonl").read_text().splitlines()
    assert [json.loads(line)["kind"] for line in ev] == kinds
    assert res.watchdog["steps"] >= 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ENGINES)
def test_crash_resume_on_the_card_bit_exact(cuda, tmp_path, name):
    """On the card (the kernels), every chunk under
    ``set_sync_debug_mode("error")``: the JAX dist test's plan ends
    bit-equal to the clean run."""
    g = GRAPH.to(cuda)

    class Guarded(SupervisedRun):
        def _outer_step(self, bundle, tel):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return super()._outer_step(bundle, tel)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def run(sub, plan=None):
        return Guarded(name, lambda n, r, **p: engine.make(
            n, g, sweep=4, device=cuda, **p), _cfg(tmp_path, sub), plan,
            sleep_fn=lambda s: None).run()
    clean = run("clean")
    res = run("fault", FaultPlan([Fault(step=2, kind="corrupt",
                                        target="arrays"),
                                  Fault(step=2, kind="preempt"),
                                  Fault(step=4, kind="nan", target="x")]))
    assert res.restarts == 1 and res.rollbacks == 1
    assert torch.equal(res.state.x, clean.state.x)
    assert np.array_equal(res.marginals, clean.marginals)


# -- the launcher ---------------------------------------------------------------

def test_launcher_supervised_fault_plan_on_cpu(tmp_path, capsys):
    plan = json.dumps({"faults": [
        {"step": 2, "kind": "corrupt", "target": "arrays"},
        {"step": 2, "kind": "preempt"},
        {"step": 4, "kind": "nan", "target": "x"}]})
    args = ["--config", WORKLOAD, "--engine", "mgpmh", "--steps", "24",
            "--chains", "8", "--sweep", "4", "--supervise-chunk", "4",
            "--device", "cpu"]
    tlaunch.main(args + ["--supervise", "--ckpt-dir", str(tmp_path / "a"),
                         "--fault-plan", plan])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines()
            if line.startswith("[gibbs] supervised done:")]
    assert len(done) == 1
    assert "outer_steps=6 restarts=1 rollbacks=1 engine=mgpmh" in done[0]
    # the same run with no faults ends on the same marginals
    tlaunch.main(args + ["--supervise", "--ckpt-dir", str(tmp_path / "b")])
    clean = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[gibbs] supervised done:")]
    assert clean[0].split("marg_err=")[1] == done[0].split("marg_err=")[1]
    with pytest.raises(SystemExit):
        tlaunch.main(args + ["--fault-plan", plan])   # needs --supervise


def test_launcher_ckpt_dir_rerun_resumes(tmp_path, capsys):
    args = ["--config", WORKLOAD, "--engine", "mgpmh", "--chains", "8",
            "--sweep", "4", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck")]
    tlaunch.main(args + ["--steps", "10"])
    first = capsys.readouterr().out
    assert "resumed" not in first
    tlaunch.main(args + ["--steps", "20"])
    second = capsys.readouterr().out
    assert "[gibbs] resumed at step 10" in second
    # resuming is bit-exact: 10 + 10 calls end where 20 straight calls do
    tlaunch.main(["--config", WORKLOAD, "--engine", "mgpmh", "--chains",
                  "8", "--sweep", "4", "--device", "cpu", "--steps", "20"])
    straight = capsys.readouterr().out
    err = lambda s: s.strip().splitlines()[-1].split("marg_err=")[1].split()[0]
    assert err(second) == err(straight)
