"""Evidence clamping in the port (``Engine.clamp``, ``Engine.sweep(...,
evidence=...)``, ``samplers.evidence_cdf``) on the CPU, and on a machine
with a CUDA card, the site draws of the card.

  * ``evidence_cdf`` equals the JAX package's table (rtol 1e-6; observed
    sites tie exactly with their predecessor, the last entry is 1.0);
  * draws through it, and through the masked adaptive table, never land on
    an observed site;
  * after ``clamp`` no observed site of any chain moves under
    ``evidence=`` (uniform gibbs, mgpmh, min-gibbs, doublemin, chromatic
    gibbs with its per-class re-clamp, and the adaptive engines), and the
    min-gibbs / doublemin caches are re-drawn at the clamped state;
  * clamped gibbs reaches ``exact_conditional_marginals``;
  * local-gibbs refuses evidence and AdaptiveScan, as in the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import samplers as jsamplers  # noqa: E402
from repro.diagnostics import exact as jexact  # noqa: E402
from repro_torch.core import chains, engine, samplers  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.diagnostics import adaptive as tadaptive  # noqa: E402
from repro_torch.diagnostics import exact as texact  # noqa: E402

MASKS = {"none": [], "first": [0], "last": [39], "block": [3, 4, 5, 6],
         "all but one": list(range(39))}


def _mask(observed, n=40):
    m = np.zeros(n, np.float32)
    m[observed] = 1.0
    return m


def _evidence(n, observed, values, device="cpu"):
    mask = torch.zeros(n, device=device)
    vals = torch.zeros(n, dtype=torch.int32, device=device)
    mask[observed] = 1.0
    vals[observed] = torch.as_tensor(values, dtype=torch.int32,
                                     device=device)
    return mask, vals


@pytest.mark.parametrize("which", list(MASKS))
def test_evidence_cdf_equals_jax(which):
    m = _mask(MASKS[which])
    want = np.asarray(jsamplers.evidence_cdf(jnp.asarray(m)))
    got = samplers.evidence_cdf(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == 1.0
    prev = np.concatenate([[0.0], got[:-1]])
    assert np.all(got[m > 0] == prev[m > 0])


def _landings(cdf, observed, n_draws, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n_draws, generator=gen, device=device)
    i = samplers.inverse_cdf_sites(cdf, u)
    return int(observed[i.long()].sum()), i


@pytest.mark.parametrize("table", ["evidence", "adaptive"])
def test_draws_never_land_on_observed_sites(table):
    n = 500
    rng = np.random.default_rng(0)
    obs = np.zeros(n, bool)
    obs[rng.choice(n, 50, replace=False)] = True
    obs[[0, n - 1]] = True                   # both ends observed
    mask = torch.from_numpy(obs.astype(np.float32))
    if table == "evidence":
        cdf = samplers.evidence_cdf(mask)
    else:
        w = torch.from_numpy(0.5 + rng.random(n).astype(np.float32))
        cdf = tadaptive.masked_cdf(torch.cumsum(w / w.sum(), 0), mask)
    hits, i = _landings(cdf, torch.from_numpy(obs), 200_000, "cpu")
    assert hits == 0
    assert int(i.min()) >= 0 and int(i.max()) < n
    # every unobserved site is reachable
    assert torch.unique(i).numel() == n - int(obs.sum())


ENGINES = [("gibbs", {}), ("mgpmh", {}), ("min-gibbs", dict(capacity=12)),
           ("doublemin", dict(capacity1=10, capacity2=12))]


def _clamped_engine(kind, name, params):
    g = tfg.make_pair_ising(2, 4, device="cpu")            # n = 12, D = 2
    if kind == "chromatic":
        sched = engine.ChromaticBlocks(tfg.pair_colors(6))
    elif kind == "adaptive":
        sched = engine.AdaptiveScan(sweep_len=8, refresh_every=2)
    else:
        sched = engine.UniformSites(8)
    return engine.make(name, g, schedule=sched, device="cpu", **params)


@pytest.mark.parametrize("kind,name,params", [
    *(("uniform", n, p) for n, p in ENGINES),
    ("chromatic", "gibbs", {}),
    *(("adaptive", n, p) for n, p in ENGINES)])
def test_observed_sites_never_move(kind, name, params):
    eng = _clamped_engine(kind, name, params)
    assert eng.supports_evidence
    observed, values = [0, 3, 7], [1, 0, 1]
    ev = _evidence(eng.graph.n, observed, values)
    st = eng.clamp(eng.init(0, 6, start="random"), ev)
    x0 = st.x.clone()
    want = torch.tensor(values, dtype=torch.int32).expand(6, 3)
    assert torch.equal(st.x[:, observed], want)
    free = [i for i in range(eng.graph.n) if i not in observed]
    assert torch.equal(st.x[:, free],
                       eng.init(0, 6, start="random").x[:, free])
    tel = eng.init_telemetry(st)
    for _ in range(20):
        st, tel = eng.sweep(st, tel, evidence=ev)
        assert torch.equal(st.x[:, observed], want)
    assert bool((st.x[:, free] != x0[:, free]).any())   # the rest mixes
    if kind == "uniform":                 # sites drawn: never an observed one
        assert float(tel.site_prop[observed].sum()) == 0.0


@pytest.mark.parametrize("name,params", ENGINES[2:])
def test_clamp_redraws_the_cache_at_the_clamped_state(name, params):
    eng = _clamped_engine("uniform", name, params)
    st = eng.init(0, 6, start="random")
    ev = _evidence(eng.graph.n, [0, 1, 2, 3], [1, 1, 0, 0])
    before = torch.Generator().set_state(st.gen.get_state())
    clamped = eng.clamp(st, ev)
    assert eng.refresh_cache_fn is eng.cache_init is not None
    # the cache is one fresh estimator draw at the clamped x, from the
    # state's generator
    replay = eng.cache_init(st._replace(x=clamped.x, gen=before))
    assert torch.equal(clamped.cache, replay.cache)
    assert not torch.equal(clamped.cache, st.cache)
    assert torch.isfinite(clamped.cache).all()


def test_local_gibbs_refuses_evidence_and_adaptive():
    g = tfg.make_pair_ising(2, 4, device="cpu")
    eng = engine.make("local-gibbs", g, sweep=4, device="cpu")
    assert not eng.supports_evidence and eng.sweep_stats_fn is None
    st = eng.init(0, 2)
    with pytest.raises(ValueError, match="does not support evidence"):
        eng.sweep(st, evidence=_evidence(g.n, [0], [1]))
    with pytest.raises(ValueError, match="only the UniformSites"):
        engine.make("local-gibbs", g, device="cpu",
                    schedule=engine.AdaptiveScan(4))


@pytest.mark.parametrize("kind", ["uniform", "chromatic"])
def test_clamped_gibbs_marginals_match_exact_conditionals(kind):
    """Clamped gibbs on hetero-pairs-24 (site 0 observed at 1; its strong
    partner, site 1, follows it with p = e^3.5 / (e^3.5 + 1)) against the
    port's exact conditional marginals, which equal the JAX package's.  On
    the chromatic schedule site 1 is in the class after site 0's: a clamp
    restored only at the end of the call would let it follow a resampled
    site 0."""
    wl = engine.make_workload("hetero-pairs-24", device="cpu")
    g = wl.graph
    exact = texact.exact_conditional_marginals(g, [0, 5], [1, 0])
    np.testing.assert_allclose(
        exact, jexact.exact_conditional_marginals(
            jengine.make_workload("hetero-pairs-24").graph, [0, 5], [1, 0]),
        atol=1e-12)
    sched = (engine.ChromaticBlocks(wl.colors) if kind == "chromatic"
             else engine.UniformSites(24))
    eng = engine.make("gibbs", g, schedule=sched, device="cpu")
    ev = _evidence(g.n, [0, 5], [1, 0])
    st = eng.clamp(eng.init(0, 64), ev)
    calls = 600
    marg = torch.zeros(g.n, g.D)
    for _ in range(calls):
        st = eng.sweep(st, evidence=ev)
        marg += torch.nn.functional.one_hot(st.x.long(), g.D).sum(0)
    m = (marg / (calls * 64)).numpy()
    assert m[0].tolist() == [0.0, 1.0] and m[5].tolist() == [1.0, 0.0]
    assert abs(m[1, 1] - exact[1, 1]) < 0.05, (m[1], exact[1])
    tv = 0.5 * np.abs(m - exact).sum(-1)
    assert tv.mean() < 0.06 and tv.max() < 0.25, tv


def test_evidence_runs_through_the_runner():
    g = tfg.make_pair_ising(2, 4, device="cpu")
    eng = engine.make("mgpmh", g, sweep=4, device="cpu")
    ev = _evidence(g.n, [2], [1])
    st = eng.clamp(eng.init(0, 4), ev)
    for _ in range(3):
        st = eng.sweep(st, evidence=ev)
    tr = chains.run_marginal_experiment(eng, st, n_iters=4 * 4,
                                        n_snapshots=2)
    assert tr.marg.shape == (4, g.n, g.D)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_draws_land_on_no_observed_site(cuda):
    """10^7 draws at n = 4096 through the card's cumsum, searchsorted and
    cummax: none lands on one of the 10% observed sites."""
    n = 4096
    rng = np.random.default_rng(1)
    obs = np.zeros(n, bool)
    obs[rng.choice(n, n // 10, replace=False)] = True
    observed = torch.from_numpy(obs).to(cuda)
    mask = observed.float()
    w = torch.from_numpy(0.5 + rng.random(n).astype(np.float32)).to(cuda)
    for cdf in (samplers.evidence_cdf(mask),
                tadaptive.masked_cdf(torch.cumsum(w / w.sum(), 0), mask)):
        hits, i = _landings(cdf, observed, 10_000_000, cuda)
        assert hits == 0
        assert int(i.max()) < n
