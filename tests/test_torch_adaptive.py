"""The port's AdaptiveScan schedule and lambda auto-tuner
(``repro_torch.diagnostics.adaptive``) on the CPU, against the JAX package
where the two compute the same numbers and against exact marginals where
they draw different (equally valid) streams.

  * ``refresh_cdf`` and the masked table equal the JAX expressions on the
    same counters (rtol 1e-6);
  * every adaptive engine (gibbs, mgpmh, min-gibbs, doublemin) reaches the
    exact marginals of an enumerable 2x2 Potts graph (D = 3) within 0.03,
    as the JAX package's ``test_adaptive_scan_is_a_correct_chain`` does;
  * adaptive gibbs reaches the worst-site TV target on hetero-pairs-24 in
    at most 0.7x the updates of uniform gibbs (the reference criterion);
  * ``autotune_lambda`` lands MGPMH's acceptance in its band;
  * an adaptive run replays to the same bits; the registry and the
    launcher take the schedule where the JAX package does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import make_potts_graph as j_make_potts_graph  # noqa: E402
from repro.diagnostics import adaptive as jadaptive  # noqa: E402
from repro_torch.core import chains, engine  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.diagnostics import adaptive as tadaptive  # noqa: E402
from repro_torch.diagnostics import telemetry as ttel  # noqa: E402
from repro_torch.launch import gibbs as launcher  # noqa: E402

from _helpers import exact_marginals  # noqa: E402

ADAPTIVE = ("gibbs", "mgpmh", "min-gibbs", "doublemin")
# capacities with an overflow probability below 1e-9 at the small graph's
# default lambdas (tests/test_torch_minibatch.py)
PARAMS = {"gibbs": {}, "mgpmh": {}, "min-gibbs": dict(capacity=12),
          "doublemin": dict(capacity1=10, capacity2=12)}


def _counters(seed, n=50):
    rng = np.random.default_rng(seed)
    props = rng.integers(0, 40, size=n).astype(np.float32)
    flips = np.minimum(props, rng.integers(0, 40, size=n)).astype(np.float32)
    return flips, props


@pytest.mark.parametrize("mix,smoothing", [(0.25, 0.05), (0.15, 0.05),
                                           (1.0, 0.5)])
def test_refresh_cdf_equals_jax(mix, smoothing):
    flips, props = _counters(0)
    want = jadaptive.refresh_cdf(jnp.asarray(flips), jnp.asarray(props),
                                 flips.size, mix, smoothing)
    got = tadaptive.refresh_cdf(torch.from_numpy(flips),
                                torch.from_numpy(props), flips.size, mix,
                                smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert abs(float(got[-1]) - 1.0) < 1e-5


@pytest.mark.parametrize("observed", [[], [0], [49], [3, 4, 5, 30],
                                      list(range(1, 50))])
def test_masked_cdf_equals_the_jax_expression(observed):
    """``masked_cdf`` against the JAX adaptive sweep's masked table
    (``diff``, mask, ``cumsum``, normalize); observed sites tie exactly."""
    flips, props = _counters(1)
    cdf = tadaptive.refresh_cdf(torch.from_numpy(flips),
                                torch.from_numpy(props), 50, 0.25, 0.05)
    mask = np.zeros(50, np.float32)
    mask[observed] = 1.0
    p = jnp.diff(jnp.asarray(cdf.numpy()), prepend=0.0) * (1.0 - mask)
    c = jnp.cumsum(p)
    want = np.asarray(c / jnp.maximum(c[-1], 1e-30))
    got = tadaptive.masked_cdf(cdf, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    prev = np.concatenate([[0.0], got[:-1]])
    assert np.all(got[mask > 0] == prev[mask > 0])
    assert got[-1] == 1.0


def test_registry_round_trip_and_refusals():
    g = tfg.make_pair_ising(2, 4, device="cpu")
    sched = engine.AdaptiveScan(sweep_len=8, refresh_every=4)
    for name in ADAPTIVE:
        eng = engine.make(name, g, schedule=sched, device="cpu",
                          **PARAMS[name])
        assert eng.updates_per_call == 8 and eng.supports_evidence
        assert eng.sweep_stats_fn is None
        assert "adaptive-scan" in eng.describe()["schedule"]
        st = eng.init(0, 4)
        assert isinstance(st, tadaptive.AdaptiveState) and st.calls == 0
        for _ in range(5):
            st = eng.sweep(st)
        assert st.calls == 5 and st.x.shape == (4, g.n)
        assert float(st.tel.samples) == 5         # the control telemetry
        np.testing.assert_allclose(float(st.cdf[-1]), 1.0, rtol=1e-5)
        # refreshed at call 4: no longer the uniform table
        assert not torch.allclose(st.cdf, torch.arange(1, g.n + 1) / g.n)
    with pytest.raises(ValueError, match="only the UniformSites"):
        engine.make("local-gibbs", g, schedule=sched, device="cpu")
    with pytest.raises(ValueError, match="uniform_mix"):
        engine.AdaptiveScan(uniform_mix=0.0)
    with pytest.raises(ValueError, match="refresh_every"):
        engine.AdaptiveScan(refresh_every=0)


@pytest.mark.parametrize("name", ADAPTIVE)
def test_adaptive_scan_is_a_correct_chain(name):
    """Non-uniform site selection keeps the stationary distribution: exact
    marginals on an enumerable asymmetric graph."""
    g = tfg.make_potts_graph(grid=2, beta=0.6, D=3, device="cpu")
    eng = engine.make(
        name, g, device="cpu",
        schedule=engine.AdaptiveScan(sweep_len=8, refresh_every=4,
                                     uniform_mix=0.3), **PARAMS[name])
    st = eng.init(1, 128, start="random")
    tr = chains.run_marginal_experiment(eng, st, n_iters=400 * 8,
                                        n_snapshots=1)
    emp = (tr.marg.sum(0) / (400 * 128)).numpy()
    ref = exact_marginals(j_make_potts_graph(grid=2, beta=0.6, D=3))
    assert np.abs(emp - ref).max() < 0.03
    # the table moved off uniform and still sums to one
    assert tr.final.calls == 400
    np.testing.assert_allclose(float(tr.final.cdf[-1]), 1.0, rtol=1e-5)


def _updates_to_target(eng, n_chains, n_iters, n_snapshots, ref, target):
    tr = chains.run_marginal_experiment(
        eng, eng.init(0, n_chains), n_iters=n_iters,
        n_snapshots=n_snapshots, ref_marginals=ref, site_reduce="max")
    err, iters = tr.error.numpy(), tr.iters.numpy()
    hit = err < target
    return int(iters[np.argmax(hit)]) if hit.any() else None


def test_adaptive_scan_beats_uniform_on_hetero_pairs():
    """The reference criterion (tests/test_diagnostics.py): worst-site TV
    0.12 in <= 0.7x the updates of uniform gibbs, at its settings."""
    g = engine.make_workload("hetero-pairs-24", device="cpu").graph
    ref = np.full((g.n, g.D), 0.5)     # exact by value-relabeling symmetry
    S, C, target = 16, 16, 0.12
    n_iters, n_snapshots = 8 * 16 * 120, 120
    uni = engine.make("gibbs", g, sweep=S, device="cpu")
    ada = engine.make("gibbs", g, device="cpu", schedule=engine.AdaptiveScan(
        sweep_len=S, refresh_every=4, uniform_mix=0.15))
    fu = _updates_to_target(uni, C, n_iters, n_snapshots, ref, target)
    fa = _updates_to_target(ada, C, n_iters, n_snapshots, ref, target)
    assert fu is not None and fa is not None, (fu, fa)
    assert fa <= 0.7 * fu, f"adaptive {fa} vs uniform {fu}"


def test_adaptive_run_replays_to_the_same_bits():
    g = tfg.make_potts_graph(grid=3, beta=0.8, D=3, device="cpu")
    eng = engine.make("mgpmh", g, device="cpu",
                      schedule=engine.AdaptiveScan(sweep_len=4,
                                                   refresh_every=2))
    runs = []
    for _ in range(2):
        st = eng.init(5, 6)
        tel = eng.init_telemetry(st)
        st, tel = tadaptive.run_with_telemetry(eng, st, tel, 9)
        runs.append((st, tel))
    (a, ta), (b, tb) = runs
    assert torch.equal(a.x, b.x) and torch.equal(a.accepts, b.accepts)
    assert torch.equal(a.cdf, b.cdf) and a.calls == b.calls == 9
    for x, y in ((ta, tb), (a.tel, b.tel)):
        for f, v in ttel.telemetry_to_numpy(x).items():
            np.testing.assert_array_equal(v, ttel.telemetry_to_numpy(y)[f])


def test_autotune_lambda_lands_in_band():
    # strongly coupled graph (L ~ 5): acceptance is lambda-limited, so the
    # tuner must climb from the deliberately starved lam0
    g = tfg.make_potts_graph(grid=4, beta=4.6, D=4, device="cpu")
    eng, hist = tadaptive.autotune_lambda(
        "mgpmh", g, target=(0.90, 0.96), lam0=2.0, sweep=8, n_chains=16,
        pilot_calls=32, max_rounds=12, device="cpu")
    assert len(hist) > 1                      # lam0=2 starts below the band
    assert 0.90 <= hist[-1]["acceptance"] <= 0.96, hist
    assert eng.params["lam"] == hist[-1]["lam"] > hist[0]["lam"]
    with pytest.raises(ValueError, match="no acceptance to tune"):
        tadaptive.autotune_lambda("gibbs", g, device="cpu")
    with pytest.raises(ValueError, match="target"):
        tadaptive.autotune_lambda("mgpmh", g, target=(0.9, 0.5),
                                  device="cpu")


def test_launcher_runs_adaptive_with_telemetry(capsys):
    launcher.main(["--config", "hetero-pairs-24", "--engine", "gibbs",
                   "--adaptive", "--telemetry", "--steps", "12",
                   "--chains", "4", "--sweep", "8", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("[gibbs] step      12 ")
    assert "rhat=" in out[-1] and "ess/s=" in out[-1]
    with pytest.raises(SystemExit):
        launcher.main(["--engine", "local-gibbs", "--adaptive",
                       "--device", "cpu"])
    with pytest.raises(SystemExit):
        launcher.main(["--engine", "gibbs", "--adaptive", "--chromatic",
                       "--config", "hetero-pairs-24", "--device", "cpu"])
