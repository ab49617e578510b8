"""The port's streaming telemetry (``repro_torch.diagnostics``) against the
JAX package on the CPU.

  * ``telemetry_update``: the same numpy-seeded x trajectories, accept
    deltas, per-site counters and caches (one with a NaN entry) go through
    the JAX carry and the port's; every field agrees at rtol 1e-6 /
    atol 1e-6 (float32 Welford arithmetic, another summation order);
  * the summaries (split-R-hat, ESS, acceptance, ``summarize``,
    ``health_report``, ``empirical_spectral_gap``) read one carry, moved
    across by ``telemetry_from_numpy``, and agree at rtol 1e-6;
  * the converters round-trip, ring order included;
  * ``freshness_report`` on the telemetry of ``tests/test_serving.py``'s
    freshness run (the JAX jnp engine, converted): same verdict, reason,
    R-hat and ESS;
  * every engine threads telemetry without changing its chain, and the
    runner's ``telemetry=True`` replays to the same bits.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.diagnostics import exact as jexact  # noqa: E402
from repro.diagnostics import freshness as jfresh  # noqa: E402
from repro.diagnostics import telemetry as jtel  # noqa: E402
from repro_torch.core import chains, engine  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.diagnostics import exact as texact  # noqa: E402
from repro_torch.diagnostics import freshness as tfresh  # noqa: E402
from repro_torch.diagnostics import telemetry as ttel  # noqa: E402
from repro_torch.kernels import parity_inputs as pin  # noqa: E402
from repro_torch.kernels import telemetry_update as ktel  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SUMMARY_TOL = dict(rtol=1e-6, atol=0.0)
T, C, N, D = 24, 3, 7, 4          # snapshots, chains, sites, values
NAN_AT = 13                        # the step whose cache holds a NaN


def _trajectory(seed, T=T, C=C, n=N, D=D, stay=0.7):
    """A sticky (T, C, n) int32 x trajectory (each value kept with
    probability ``stay``, so the lags correlate), per-step accept deltas,
    per-site counters and caches, all drawn with numpy."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, D, size=(C, n))]
    for _ in range(T - 1):
        fresh = rng.integers(0, D, size=(C, n))
        xs.append(np.where(rng.random((C, n)) < stay, xs[-1], fresh))
    prop = rng.integers(0, 6, size=(T, n)).astype(np.float32)
    return dict(
        xs=np.stack(xs).astype(np.int32),
        acc=rng.integers(0, 4, size=(T, C)).astype(np.int32),
        prop=prop,
        site_acc=np.minimum(prop, rng.integers(0, 6, size=(T, n))).astype(
            np.float32),
        cache=rng.normal(size=(T, C)).astype(np.float32))


def _feed(traj, lags, half_at, *, optional=True, n_values=D):
    """Thread ``traj`` through a JAX carry and a port carry (CPU)."""
    xs = traj["xs"]
    jt = jtel.telemetry_init(jnp.asarray(xs[0]), half_at=half_at, lags=lags)
    tt = ttel.telemetry_init(torch.from_numpy(xs[0]), half_at=half_at,
                             lags=lags)
    old = xs[0]
    for s, x in enumerate(xs):
        kw_j, kw_t = {}, {}
        if optional:
            cache = traj["cache"][s].copy()
            if s == NAN_AT:
                cache[1] = np.nan
            parts = (traj["acc"][s], traj["prop"][s], traj["site_acc"][s],
                     cache)
            a, p, sa, c = (jnp.asarray(v) for v in parts)
            kw_j = dict(accept_delta=a, stats=jtel.SweepStats(p, sa),
                        cache=c, n_values=n_values)
            a, p, sa, c = (torch.from_numpy(v) for v in parts)
            kw_t = dict(accept_delta=a, stats=ttel.SweepStats(p, sa),
                        cache=c, n_values=n_values)
        jt = jtel.telemetry_update(jt, jnp.asarray(old), jnp.asarray(x), 3,
                                   **kw_j)
        tt = ttel.telemetry_update(tt, torch.from_numpy(old),
                                   torch.from_numpy(x), 3, **kw_t)
        old = x
    return jt, tt


def _assert_fields_equal(jt, tt, tol=TOL):
    got = ttel.telemetry_to_numpy(tt)
    assert tuple(got) == ttel.TELEMETRY_FIELDS == jtel.Telemetry._fields
    for f in ttel.TELEMETRY_FIELDS:
        want = np.asarray(getattr(jt, f))
        assert got[f].shape == want.shape, f
        np.testing.assert_allclose(got[f], want, err_msg=f, **tol)


# ---------------------------------------------------------------------------
# the streaming update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lags", [1, 8])
@pytest.mark.parametrize("half_at", [None, 11])
def test_telemetry_update_equals_jax(lags, half_at):
    jt, tt = _feed(_trajectory(0), lags, half_at)
    _assert_fields_equal(jt, tt)
    assert float(tt.bad_state) == 1.0          # the NaN cache latched it
    assert tt.count == T and float(tt.samples) == T
    assert tt.split == (math.inf if half_at is None else half_at)


@pytest.mark.parametrize("case", ["no optional inputs", "out of domain"])
def test_telemetry_update_other_inputs_equal_jax(case):
    traj = _trajectory(1)
    if case == "no optional inputs":
        jt, tt = _feed(traj, 8, 12, optional=False)
        assert float(tt.bad_state) == 0.0
    else:                   # one value at D: the n_values guard latches
        traj["xs"][5, 2, 3] = D
        traj["cache"][NAN_AT] = 0.0
        jt, tt = _feed(traj, 8, 12, n_values=D)
        assert float(tt.bad_state) == 1.0
    _assert_fields_equal(jt, tt)


def test_bad_state_stays_clear_until_the_nan():
    traj = _trajectory(2)
    traj["xs"] = traj["xs"][:NAN_AT]
    jt, tt = _feed(traj, 8, None)
    assert float(tt.bad_state) == 0.0
    _assert_fields_equal(jt, tt)
    cleared = ttel.clear_health(_feed(_trajectory(2), 8, None)[1])
    assert float(cleared.bad_state) == 0.0
    assert ttel.health_report(cleared) == {"bad_state": False,
                                           "win_acceptance": 1.0}


# ---------------------------------------------------------------------------
# the fused kernel's host side and its dispatch
# ---------------------------------------------------------------------------

def _steps(tel, traj, s, device="cpu", drop=(), stats="counts"):
    """The update arguments of step s of a ``parity_inputs`` trajectory,
    without the optional inputs named in ``drop``; ``stats`` "counts" (a
    SweepStats), "hits" or "moves" (a SiteDraws of the step's sites)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kw = dict(accept_delta=t(traj["acc"][s]),
              stats=(ttel.SweepStats(t(traj["prop"][s]),
                                     t(traj["site_acc"][s]))
                     if stats == "counts" else
                     ttel.SiteDraws(t(traj["sites"][s]),
                                    moves=stats == "moves")),
              cache=t(traj["cache"][s]), n_values=D)
    for name in drop:
        kw[name] = None
    return (tel, t(traj["xs"][s]), t(traj["xs"][s + 1]), 64), kw


@pytest.mark.parametrize("lags, half_at", [(8, 9), (1, 4), (8, None)])
def test_update_plan_matches_the_plain_update(lags, half_at):
    """Over 2K + 6 steps (crossing the split, wrapping the ring), the
    kernel wrapper's host-side arguments are the plain update's decisions:
    the new sample count, whether and how far the second half grows, the
    ring slots written and the lags whose pair counts grow."""
    T = 2 * lags + 6
    traj = pin.telemetry_inputs(T, C, N, D, seed=4, S=64)
    tel = ttel.telemetry_init(torch.from_numpy(traj["xs"][0]),
                              half_at=half_at, lags=lags)
    seconds, slots = 0, []
    for s in range(T):
        plan = ktel.update_plan(tel.head, tel.count, tel.split, lags)
        before = {f: getattr(tel, f).clone()
                  for f in ("samples_h", "cross_n", "mean_h")}
        args, kw = _steps(tel, traj, s)
        tel = ttel.telemetry_update_plain(*args, **kw)
        assert (tel.count, tel.head) == (plan.count_new, plan.new_head)
        assert float(tel.samples) == plan.count_new
        grew = float(tel.samples_h) != float(before["samples_h"])
        assert grew == plan.second
        if plan.second:
            seconds += 1
            assert float(tel.samples_h) == plan.count_h_new
        else:
            assert torch.equal(tel.mean_h, before["mean_h"])
        slots.append(plan.new_head)
        step = tel.cross_n - before["cross_n"]
        assert step.tolist() == [1.0] * plan.live + [0.0] * (
            lags - plan.live)
        x = torch.from_numpy(traj["xs"][s + 1]).float()
        assert torch.equal(tel.prev[plan.new_head], x)
        assert torch.equal(tel.prev[plan.new_head + lags], x)
    assert seconds == (0 if half_at is None else T - half_at)
    # the ring wrapped twice: every slot written, in descending order
    assert slots == [(-1 - s) % lags for s in range(T)]
    assert plan.live == lags


def test_cpu_carry_routes_to_the_plain_version(monkeypatch):
    """A CPU carry never reaches the kernel wrapper, and gives the plain
    version's bits."""
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called for a CPU carry")

    monkeypatch.setattr(ttel, "telemetry_update_cuda", refuse)
    traj = pin.telemetry_inputs(5, C, N, D, seed=5)
    carries = []
    for update in (ttel.telemetry_update, ttel.telemetry_update_plain):
        tel = ttel.telemetry_init(torch.from_numpy(traj["xs"][0]), 2, 3)
        for s in range(5):
            args, kw = _steps(tel, traj, s)
            tel = update(*args, **kw)
        carries.append(ttel.telemetry_to_numpy(tel))
    for f in ttel.TELEMETRY_FIELDS:
        np.testing.assert_array_equal(carries[0][f], carries[1][f],
                                      err_msg=f)


@pytest.mark.parametrize("moves", [False, True])
def test_site_draws_count_as_the_sweep_stats(moves):
    """A SiteDraws counts to the per-site hits (numpy's bincount) and, with
    ``moves``, the per-site value changes; the plain update reads it as
    that SweepStats."""
    traj = pin.telemetry_inputs(3, C, N, D, seed=8, S=5)
    old, new = (torch.from_numpy(traj["xs"][k]) for k in (0, 1))
    draws = ttel.SiteDraws(torch.from_numpy(traj["sites"][0]), moves=moves)
    got = draws.counters(old, new, N)
    hits = np.bincount(traj["sites"][0].ravel(), minlength=N)
    np.testing.assert_array_equal(got.site_prop.numpy(), hits)
    want = ((traj["xs"][0] != traj["xs"][1]).sum(0) if moves else hits)
    np.testing.assert_array_equal(got.site_acc.numpy(), want)
    carries = []
    for stats in (draws, got):
        tel = ttel.telemetry_init(old)
        carries.append(ttel.telemetry_to_numpy(ttel.telemetry_update_plain(
            tel, old, new, 5, stats=stats)))
    for f in ttel.TELEMETRY_FIELDS:
        np.testing.assert_array_equal(carries[0][f], carries[1][f],
                                      err_msg=f)


def test_kernel_wrapper_refuses_a_cpu_carry():
    traj = pin.telemetry_inputs(1, C, N, D, seed=6)
    tel = ttel.telemetry_init(torch.from_numpy(traj["xs"][0]))
    args, kw = _steps(tel, traj, 0)
    launches = ktel.telemetry_update_cuda.launches
    with pytest.raises(ValueError, match="carry on the card"):
        ktel.telemetry_update_cuda(*args, **kw, decay=ttel.HEALTH_DECAY)
    assert ktel.telemetry_update_cuda.launches == launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


# (C, n, K, half_at, inputs left out, a bad state, stats form): the kernel
# against the plain version on the card over 2K + 2 steps or more
KERNEL_CASES = {
    "every input": (64, 300, 8, 9, (), None, "counts"),
    "site draws, hits": (64, 300, 8, 9, (), None, "hits"),
    "site draws, moves": (64, 300, 8, 9, (), None, "moves"),
    "C=96": (96, 257, 8, 9, (), None, "moves"),
    "no accept_delta": (16, 40, 8, 9, ("accept_delta",), None, "counts"),
    "no stats": (16, 40, 8, 9, ("stats",), None, "counts"),
    "no cache": (16, 40, 8, 9, ("cache",), None, "counts"),
    "K=1": (32, 70, 1, 2, (), None, "hits"),
    "out of domain": (16, 40, 4, 5, (), "x", "counts"),
    "NaN cache": (16, 40, 4, 5, (), "cache", "counts"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_telemetry_kernel_equals_plain_bit_for_bit(cuda, case):
    """Every carry field of the fused kernel equals the plain version's
    bits on the card, after every step."""
    Cc, n, K, half_at, drop, bad, form = KERNEL_CASES[case]
    T = 2 * K + 4
    traj = pin.telemetry_inputs(T, Cc, n, D, seed=7, S=64)
    if bad == "x":
        traj["xs"][K + 1, 1, 2] = D
    elif bad == "cache":
        traj["cache"][K + 1, 1] = np.nan
    x0 = torch.from_numpy(traj["xs"][0]).to(cuda)
    kern = ttel.telemetry_init(x0, half_at=half_at, lags=K)
    plain = ttel.telemetry_init(x0, half_at=half_at, lags=K)
    launches = ktel.telemetry_update_cuda.launches
    for s in range(T):
        args, kw = _steps(kern, traj, s, cuda, drop, form)
        kern = ttel.telemetry_update(*args, **kw)
        args, kw = _steps(plain, traj, s, cuda, drop, form)
        plain = ttel.telemetry_update_plain(*args, **kw)
        a, b = ttel.telemetry_to_numpy(kern), ttel.telemetry_to_numpy(plain)
        for f in ttel.TELEMETRY_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {s}")
    assert ktel.telemetry_update_cuda.launches == launches + T
    assert float(kern.bad_state) == (0.0 if bad is None else 1.0)


def test_converters_round_trip():
    jt, tt = _feed(_trajectory(3), 8, 10)
    # the JAX carry, across and back: the same numbers
    back = ttel.telemetry_to_numpy(ttel.telemetry_from_numpy(jt,
                                                             device="cpu"))
    for f in ttel.TELEMETRY_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jt, f)))
    # the port's carry (ring head anywhere), across and back
    arrays = ttel.telemetry_to_numpy(tt)
    again = ttel.telemetry_from_numpy(arrays, device="cpu")
    assert (again.count, again.split) == (tt.count, tt.split)
    for f, a in ttel.telemetry_to_numpy(again).items():
        np.testing.assert_array_equal(a, arrays[f])
    # both carries take the next snapshot to the same numbers
    traj = _trajectory(4)
    old, new = traj["xs"][-1], traj["xs"][0]
    args = (torch.from_numpy(old), torch.from_numpy(new), 3)
    a = ttel.telemetry_to_numpy(ttel.telemetry_update(tt, *args))
    b = ttel.telemetry_to_numpy(ttel.telemetry_update(again, *args))
    for f in ttel.TELEMETRY_FIELDS:
        np.testing.assert_array_equal(a[f], b[f])


# ---------------------------------------------------------------------------
# summaries on one carry
# ---------------------------------------------------------------------------

def _summary(which, mod, tel):
    if which == "empirical_spectral_gap":
        return (jexact if mod is jtel else texact).empirical_spectral_gap(tel)
    if which == "summarize":
        return mod.summarize(tel, elapsed_sec=2.5)
    return getattr(mod, which)(tel)


@pytest.mark.parametrize("lags,half_at", [(1, None), (8, 12)])
@pytest.mark.parametrize("which", ["split_rhat", "ess_per_site",
                                   "acceptance_rate", "summarize",
                                   "health_report",
                                   "empirical_spectral_gap"])
def test_summaries_equal_jax_on_one_carry(which, lags, half_at):
    jt, _ = _feed(_trajectory(5, T=40), lags, half_at)
    tt = ttel.telemetry_from_numpy(jt, device="cpu")
    want, got = _summary(which, jtel, jt), _summary(which, ttel, tt)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **SUMMARY_TOL)
    else:
        np.testing.assert_allclose(got, want, **SUMMARY_TOL)
        assert np.all(np.isfinite(got))


# ---------------------------------------------------------------------------
# freshness on the reference test's own run
# ---------------------------------------------------------------------------

POLICY = dict(max_rhat=1.2, min_ess_per_site=16.0, min_samples=8)


@pytest.fixture(scope="module")
def reference_run():
    """The telemetry of ``tests/test_serving.py``'s freshness test: the JAX
    gibbs jnp engine on hetero-pairs-24, 16 chains, site 0 clamped to 1,
    60 calls of 24 updates."""
    g = jengine.make_workload("hetero-pairs-24").graph
    eng = jengine.make("gibbs", g, sweep=24, backend="jnp")
    mask = np.zeros(g.n, np.float32)
    vals = np.zeros(g.n, np.int32)
    mask[0], vals[0] = 1.0, 1
    ev = (jnp.asarray(mask), jnp.asarray(vals))
    st = eng.clamp(jax.random.PRNGKey(1),
                   eng.init(jax.random.PRNGKey(0), 16), ev)
    tel = eng.init_telemetry(st)
    for _ in range(60):
        st, tel = eng.sweep(st, tel, evidence=ev)
    return tel, mask == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_freshness_report_equals_jax_on_the_reference_run(reference_run,
                                                          masked):
    jt, unobserved = reference_run
    tt = ttel.telemetry_from_numpy(jt, device="cpu")
    kw = dict(site_mask=unobserved) if masked else {}
    want = jfresh.freshness_report(jt, jfresh.FreshnessPolicy(**POLICY), **kw)
    got = tfresh.freshness_report(tt, tfresh.FreshnessPolicy(**POLICY), **kw)
    assert got["fresh"] == want["fresh"]
    assert got["reason"] == want["reason"]
    assert got["samples"] == want["samples"] == 60
    np.testing.assert_allclose(got["max_rhat"], want["max_rhat"],
                               **SUMMARY_TOL)
    np.testing.assert_allclose(got["min_ess"], want["min_ess"],
                               **SUMMARY_TOL)
    assert tfresh.fresh(tt, tfresh.FreshnessPolicy(**POLICY), **kw) == \
        want["fresh"]


def test_freshness_policy_and_health_gate():
    with pytest.raises(ValueError, match="max_rhat"):
        tfresh.FreshnessPolicy(max_rhat=0.9)
    with pytest.raises(ValueError, match="non-negative"):
        tfresh.FreshnessPolicy(min_samples=-1)
    _, tt = _feed(_trajectory(6), 8, 12)           # bad_state latched
    rep = tfresh.freshness_report(tt, tfresh.FreshnessPolicy(),
                                  include_health=True)
    assert not rep["fresh"] and rep["bad_state"]
    assert rep["reason"].startswith("bad_state latched")
    with pytest.raises(ValueError, match="site_mask shape"):
        tfresh.freshness_report(tt, tfresh.FreshnessPolicy(min_samples=1),
                                site_mask=np.ones(N + 1, bool))


# ---------------------------------------------------------------------------
# engines and the runner
# ---------------------------------------------------------------------------

ENGINES = [("gibbs", {}), ("mgpmh", {}), ("min-gibbs", dict(capacity=12)),
           ("doublemin", dict(capacity1=10, capacity2=12)),
           ("local-gibbs", {}), ("chromatic", {})]


def _engine(name, params, S=6):
    if name == "chromatic":
        g = tfg.make_lattice_ising(4, device="cpu")
        return engine.make("gibbs", g, device="cpu", schedule=engine.
                           ChromaticBlocks(tfg.lattice_colors(4)))
    g = tfg.make_potts_graph(grid=3, beta=0.8, D=3, device="cpu")
    return engine.make(name, g, sweep=S, device="cpu", **params)


@pytest.mark.parametrize("name,params", ENGINES)
def test_every_engine_threads_telemetry(name, params):
    """The instrumented sweep draws what the plain one draws: with or
    without the carry the chains end in the same bits; the counters count
    what the calls did."""
    eng = _engine(name, params)
    Cc, calls, upd = 5, 4, eng.updates_per_call
    plain = eng.init(7, Cc)
    st = eng.init(7, Cc)
    tel = eng.init_telemetry(st)
    flips = torch.zeros(eng.graph.n)
    for _ in range(calls):
        plain = eng.sweep(plain)
        old = st.x
        st, tel = eng.sweep(st, tel)
        flips += (old != st.x).sum(0)
    assert torch.equal(st.x, plain.x) and torch.equal(st.accepts,
                                                      plain.accepts)
    assert float(tel.samples) == calls and float(tel.updates) == calls * upd
    assert torch.equal(tel.site_flips, flips)
    assert torch.equal(tel.accepts, st.accepts.float())
    if name == "local-gibbs":              # no instrumented sweep
        assert eng.sweep_stats_fn is None
        assert float(tel.site_prop.sum()) == 0.0
    else:
        assert float(tel.site_prop.sum()) == Cc * upd * calls
        assert bool((tel.site_acc <= tel.site_prop).all())
    if eng.exact_accept and name != "local-gibbs":
        assert torch.equal(tel.site_acc, tel.site_prop)
    assert float(tel.bad_state) == 0.0
    s = ttel.summarize(tel, eng.exact_accept)
    assert s["samples"] == calls and s["updates"] == calls * upd


def test_run_marginal_experiment_telemetry_replays():
    g = tfg.make_potts_graph(grid=3, beta=0.8, D=3, device="cpu")
    eng = engine.make("mgpmh", g, sweep=4, device="cpu")
    runs = [chains.run_marginal_experiment(
        eng, eng.init(3, 6), n_iters=4 * 5 * 6, n_snapshots=6,
        telemetry=True) for _ in range(2)]
    a, b = runs
    assert torch.equal(a.final.x, b.final.x) and torch.equal(a.error,
                                                              b.error)
    ta, tb = (ttel.telemetry_to_numpy(r.telemetry) for r in runs)
    for f in ttel.TELEMETRY_FIELDS:
        np.testing.assert_array_equal(ta[f], tb[f], err_msg=f)
    tel = a.telemetry
    assert float(tel.samples) == 30 and float(tel.half_at) == 15
    assert float(tel.samples_h) == 15
    assert ttel.summarize(tel)["updates"] == 120
    plain = chains.run_marginal_experiment(eng, eng.init(3, 6),
                                           n_iters=4 * 5 * 6, n_snapshots=6)
    assert plain.telemetry is None and torch.equal(plain.final.x, a.final.x)
