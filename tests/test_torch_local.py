"""The port's Local Minibatch Gibbs (Algorithm 3), its bucket-energy kernel,
the single-site reference steps and the exact-theory modules, on the CPU
against the JAX package — and, on a machine with a CUDA card, the kernel
against its plain version.

  * ``ops.bucket_energy`` (CPU route: the plain version) equals the JAX
    ``bucket_energy_ref`` at the ``tests/test_kernels.py`` shapes and the
    JAX Pallas kernel in interpret mode; the masking convention and f16
    inputs;
  * Local Minibatch Gibbs: its subset draw (no j == i, every j != i
    reachable, uniform over subsets), exact marginals at B = n - 1, and
    agreement with the JAX ``local-gibbs`` engine at B in {1, 2};
  * the five single-site steps reach the exact marginals at the graphs and
    tolerances of ``tests/test_samplers.py``;
  * ``TabularPairwiseGraph``, ``spectral`` and ``diagnostics.exact`` equal
    the JAX modules on the same inputs;
  * (gpu) the kernel equals its plain version on the card, and local-gibbs
    there reaches the exact marginals at B = n - 1 through one fused
    local-sweep launch per call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores (these small
# tensors gain nothing from more)
torch.set_num_threads(1)

from repro_torch.core import chains, engine, samplers  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.core import spectral as tsp  # noqa: E402
from repro_torch.diagnostics import exact as texact  # noqa: E402
from repro_torch.kernels import (local_sweep, minibatch_energy,  # noqa: E402
                                 ops)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import gibbs as launcher  # noqa: E402

try:    # the JAX reference; a machine with the card may have no JAX, and
    # runs only the gpu tests below, which do not read it
    import jax
    import jax.numpy as jnp
    from repro.core import chains as jchains
    from repro.core import engine as jengine
    from repro.core import spectral as jsp
    from repro.core.factor_graph import TabularPairwiseGraph as JTabular
    from repro.core.factor_graph import (make_ising_graph as j_ising,
                                         make_pair_ising as j_pairs,
                                         make_potts_graph as j_potts)
    from repro.diagnostics import exact as jexact
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jax = None

BUCKET_SHAPES = [          # (C, K, D), as tests/test_kernels.py:30-33
    (1, 1, 2), (4, 100, 10), (8, 256, 2), (32, 1024, 10),
    (5, 513, 257), (16, 50, 129), (3, 2000, 4), (7, 131, 128),
]


def _bucket_inputs(C, K, D, weights, seed=None):
    rng = np.random.default_rng(C * 1000 + K + D if seed is None else seed)
    if weights == "integer":          # every summation order is exact
        w = rng.integers(-8, 9, (C, K)).astype(np.float32)
    else:
        w = rng.normal(size=(C, K)).astype(np.float32)
    v = rng.integers(0, D, (C, K)).astype(np.int32)
    return w, v


# ---------------------------------------------------------------------------
# bucket energy: the plain route against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["normal", "integer"])
@pytest.mark.parametrize("C,K,D", BUCKET_SHAPES)
def test_bucket_energy_equals_jax_ref(C, K, D, weights):
    w, v = _bucket_inputs(C, K, D, weights)
    want = np.asarray(jref.bucket_energy_ref(jnp.asarray(w), jnp.asarray(v),
                                             D))
    got = ops.bucket_energy(torch.from_numpy(w), torch.from_numpy(v), D)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, D)
    if weights == "integer":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("C,K,D", [(4, 100, 10), (5, 513, 257)])
def test_bucket_energy_equals_jax_pallas_kernel_in_interpret_mode(C, K, D):
    w, v = _bucket_inputs(C, K, D, "normal")
    want = np.asarray(jops.bucket_energy(jnp.asarray(w), jnp.asarray(v), D,
                                         impl="pallas"))
    got = ops.bucket_energy(torch.from_numpy(w), torch.from_numpy(v), D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_bucket_energy_masking_and_float16():
    """Out-of-range values (the JAX padding convention) land in no bucket;
    f16 weights and int64 values are cast up, as the JAX wrapper does."""
    w = torch.ones((1, 4))
    v = torch.tensor([[0, 1, 5, 9]], dtype=torch.int32)   # 5, 9 >= D = 3
    got = ops.bucket_energy(w, v, 3)
    assert got.tolist() == [[1.0, 1.0, 0.0]]
    want = np.asarray(jops.bucket_energy(jnp.asarray(w.numpy()),
                                         jnp.asarray(v.numpy()), 3,
                                         impl="pallas"))
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    w16 = rng.normal(size=(4, 64)).astype(np.float16)
    v64 = rng.integers(0, 8, (4, 64))
    got = ops.bucket_energy(torch.from_numpy(w16), torch.from_numpy(v64), 8)
    want = jref.bucket_energy_ref(jnp.asarray(w16).astype(jnp.float32),
                                  jnp.asarray(v64.astype(np.int32)), 8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_bucket_energy_refuses_other_devices_and_bad_inputs():
    w = torch.ones((2, 3), device="meta")
    v = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        ops.bucket_energy(w, v, 4)
    minibatch_energy.bucket_energy_cuda.launches = 0
    w, v = torch.ones((2, 3)), torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        minibatch_energy.bucket_energy_cuda(w, v, 4)
    with pytest.raises(ValueError, match="v must be torch.int32"):
        minibatch_energy.bucket_energy_cuda(w, v.long(), 4)
    with pytest.raises(ValueError, match="v must have shape"):
        minibatch_energy.bucket_energy_cuda(w, v[:, :2].contiguous(), 4)
    with pytest.raises(ValueError, match="D must lie in"):
        minibatch_energy.bucket_energy_cuda(w, v, 0)
    assert minibatch_energy.bucket_energy_cuda.launches == 0


# ---------------------------------------------------------------------------
# Local Minibatch Gibbs
# ---------------------------------------------------------------------------

def test_local_subsets_skip_the_site_and_reach_every_other_one():
    """j + (j >= i) never returns i, every j != i is drawn, the B indices
    of a draw are distinct, and the 15 subsets of the 6 other sites come
    up equally often."""
    n, B, C = 7, 2, 6000
    gen = torch.Generator().manual_seed(3)
    i, j, g = samplers.local_gibbs_draws(gen, C, n, B, 4, "cpu")
    assert i.shape == (C,) and j.shape == (C, B) and g.shape == (C, 4)
    assert not bool((j == i[:, None]).any())
    assert bool((j[:, 0] != j[:, 1]).all())
    assert bool(((j >= 0) & (j < n)).all())
    for site in range(n):
        seen = set(j[i == site].flatten().tolist())
        assert seen == set(range(n)) - {site}, (site, seen)
    # subsets of the other sites, relabelled to {0..n-2}
    j0 = j - (j > i[:, None]).long()
    lo, hi = j0.min(1).values, j0.max(1).values
    counts = torch.bincount(lo * (n - 1) + hi, minlength=(n - 1) ** 2)
    counts = counts[counts > 0].double()
    assert counts.numel() == 15
    expect = C / 15
    assert float((counts - expect).abs().max()) < 5 * np.sqrt(expect)


def _run_engine(eng, n_chains, calls, start="random", seed=0):
    st = eng.init(seed, n_chains, start=start)
    return chains.run_marginal_experiment(
        eng, st, n_iters=calls * eng.updates_per_call, n_snapshots=1)


def _exact(g):
    return texact.exact_marginals(g)


def test_local_gibbs_fullbatch_equals_gibbs():
    """Algorithm 3 with B = |A[i]| = n - 1 is exactly vanilla Gibbs
    (port of tests/test_samplers.py:72-77, same tolerance)."""
    g = tfg.make_potts_graph(grid=2, beta=0.5, D=3, device="cpu")
    eng = engine.make("local-gibbs", g, sweep=8, device="cpu",
                      batch_size=g.n - 1)
    tr = _run_engine(eng, 1024, 40)
    emp = (tr.marg.sum(0) / (40 * 1024)).numpy()
    assert np.abs(emp - _exact(g)).max() < 0.02


def _chain_marginals(marg, calls):
    """Per-chain time-averaged marginals (C, n, D) as float64 numpy."""
    return np.asarray(marg, np.float64) / calls


def _within_4_sigma(port, ref):
    """Per-entry means of (C, ...) per-chain samples agree within 4 Monte
    Carlo sigmas (independent chains)."""
    diff = port.mean(0) - ref.mean(0)
    sigma = np.sqrt((port.var(0) + ref.var(0)) / port.shape[0])
    assert np.all(np.abs(diff) <= 4 * sigma + 1e-9), (diff, sigma)


@pytest.mark.parametrize("B", [1, 2])
def test_local_gibbs_agrees_with_the_jax_engine(B):
    """Biased for B < n - 1, so held to the JAX engine rather than to the
    exact marginals, on three Ising pairs (w = 3.5, 3.5, 0.25; n = 6).
    Every site marginal is uniform by symmetry, so besides the per-chain
    running marginals the test compares each pair's agreement rate at the
    end of the run, which the bias moves: a minibatch of B of the 5 other
    sites holds the partner with probability B/5 (Gibbs: 0.9707 on a
    strong pair)."""
    C, S, calls = 4096, 6, 12
    g = tfg.make_pair_ising(2, 1, 3.5, 0.25, device="cpu")
    eng = engine.make("local-gibbs", g, sweep=S, device="cpu", batch_size=B)
    tr = _run_engine(eng, C, calls)
    jeng = jengine.make("local-gibbs", j_pairs(2, 1, 3.5, 0.25), sweep=S,
                        backend="jnp", batch_size=B)
    jtr = jchains.run_marginal_experiment(
        jeng, jeng.init(jax.random.PRNGKey(1), C, start="random"),
        n_iters=calls * S, n_snapshots=1)
    _within_4_sigma(_chain_marginals(tr.marg, calls),
                    _chain_marginals(jtr.marg, calls))
    agree = lambda x: (np.asarray(x)[:, 0::2] == np.asarray(x)[:, 1::2]
                       ).astype(np.float64)               # (C, pairs)
    port = agree(tr.final.x.numpy())
    _within_4_sigma(port, agree(jtr.final.x))
    assert port.mean(0)[:2].max() < 0.8          # visibly not Gibbs


def test_local_gibbs_engine_defaults_and_replay():
    g = tfg.make_potts_graph(grid=3, beta=1.0, D=3, device="cpu")
    eng = engine.make("local-gibbs", g, sweep=4, device="cpu")
    assert eng.params == {"batch_size": 8} and eng.exact_accept
    assert engine.backends("local-gibbs") == ("torch", "cuda")
    big = engine.make_workload("potts-20x20", device="cpu").graph
    assert engine.make("local-gibbs", big, device="cpu").params == \
        {"batch_size": 32}
    a = eng.sweep(eng.sweep(eng.init(5, 16)))
    b = eng.sweep(eng.sweep(eng.init(5, 16)))
    assert torch.equal(a.x, b.x) and bool((a.x != 0).any())
    with pytest.raises(ValueError, match="only the UniformSites"):
        engine.make("local-gibbs", g, device="cpu",
                    schedule=engine.ChromaticBlocks(np.arange(g.n) % 2))
    with pytest.raises(TypeError, match="unknown params"):
        engine.make("local-gibbs", g, device="cpu", lam=3.0)
    with pytest.raises(ValueError, match="batch_size must lie"):
        engine.make("local-gibbs", g, device="cpu", batch_size=g.n)


def test_launcher_runs_local_gibbs(capsys):
    launcher.main(["--config", "potts-20x20", "--engine", "local-gibbs",
                   "--steps", "2", "--chains", "3", "--sweep", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("[gibbs] step       2 ")
    assert "acc=1.000" in out[-1]


# ---------------------------------------------------------------------------
# single-site reference steps (graphs and tolerances of test_samplers.py)
# ---------------------------------------------------------------------------

def _tiny_graph(D, beta):
    return (tfg.make_ising_graph(grid=2, beta=beta, device="cpu") if D == 2
            else tfg.make_potts_graph(grid=2, beta=beta, D=D, device="cpu"))


def _cap(lam):
    return int(lam + 6 * lam ** 0.5 + 16)


def _step_case(kind, g):
    """(step, cache init or None) at the test_samplers.py parameters."""
    if kind == "gibbs":
        return samplers.make_gibbs_step(g), None
    if kind == "local-gibbs":
        return samplers.make_local_gibbs_step(g, g.n - 1), None
    if kind == "mgpmh":
        lam = float(4 * g.L ** 2)
        return samplers.make_mgpmh_step(g, lam, _cap(lam)), None
    if kind == "min-gibbs":
        lam = float(2 * g.psi ** 2)
        return (samplers.make_min_gibbs_step(g, lam, _cap(lam)),
                lambda st: samplers.init_min_gibbs_cache(st.gen, g, st, lam,
                                                         _cap(lam)))
    lam1, lam2 = float(4 * g.L ** 2), float(2 * g.psi ** 2)
    return (samplers.make_double_min_step(g, lam1, _cap(lam1), lam2,
                                          _cap(lam2)),
            lambda st: samplers.init_double_min_cache(st.gen, g, st, lam2,
                                                      _cap(lam2)))


@pytest.mark.parametrize("kind,D,beta,tol", [
    ("gibbs", 2, 0.6, 0.02), ("gibbs", 3, 0.6, 0.02),
    ("local-gibbs", 3, 0.5, 0.02), ("mgpmh", 3, 0.5, 0.03),
    ("min-gibbs", 2, 0.4, 0.03), ("doublemin", 2, 0.35, 0.04),
])
def test_single_site_steps_reach_exact_marginals(kind, D, beta, tol):
    g = _tiny_graph(D, beta)
    step, init = _step_case(kind, g)
    C, iters = 1024, 240
    gen = torch.Generator().manual_seed(7)
    st = samplers.init_state(gen, g, C, start="random")
    if init is not None:
        st = init(st)
    marg = torch.zeros((C, g.n, D))
    ones = torch.ones((C, g.n, 1))
    for _ in range(iters):
        st = step(st)
        marg.scatter_add_(2, st.x.long().unsqueeze(-1), ones)
    emp = (marg.sum(0) / (iters * C)).numpy()
    assert np.abs(emp - _exact(g)).max() < tol
    assert st.x.dtype == torch.int32 and tuple(st.x.shape) == (C, g.n)
    if kind in ("mgpmh", "doublemin"):
        assert 0 < int(st.accepts.sum()) <= C * iters
    if kind in ("min-gibbs", "doublemin"):
        assert bool(torch.isfinite(st.cache).all())


def test_build_step_sweep_applies_the_step_s_times():
    g = _tiny_graph(3, 0.5)
    calls = []
    step = samplers.make_gibbs_step(g)
    sweep = samplers._build_step_sweep(lambda st: calls.append(1) or step(st),
                                       5)
    st0 = samplers.init_state(torch.Generator().manual_seed(2), g, 4)
    st = sweep(st0)
    assert len(calls) == 5
    st1 = samplers.init_state(torch.Generator().manual_seed(2), g, 4)
    for _ in range(5):
        st1 = step(st1)
    assert torch.equal(st.x, st1.x)


def test_draw_local_minibatch_batches_over_chains():
    """The batched draw of the MGPMH steps draws, for each chain's site,
    only neighbours of that site, with totals clamped to the capacity."""
    g = tfg.make_potts_graph(grid=4, D=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    i = torch.tensor([0, 5, 15])
    from repro_torch.core.estimators import draw_local_minibatch
    j, B = draw_local_minibatch(gen, g, i, lam=30.0, capacity=60)
    assert j.shape == (3, 60) and B.shape == (3,) and j.dtype == torch.int32
    assert bool((g.W[i[:, None], j.long()] > 0).all())
    assert bool(((B >= 0) & (B <= 60)).all())


# ---------------------------------------------------------------------------
# exact theory: TabularPairwiseGraph, spectral, diagnostics.exact
# ---------------------------------------------------------------------------

def _assert_tabular_equal(t, j):
    np.testing.assert_array_equal(t.pairs, np.asarray(j.pairs))
    np.testing.assert_array_equal(t.tables, np.asarray(j.tables))
    assert (t.n, t.D) == (j.n, j.D)
    assert t.psi == pytest.approx(j.psi, abs=1e-12)
    assert t.L == pytest.approx(j.L, abs=1e-12)
    assert t.delta == j.delta
    np.testing.assert_allclose(t.pi(), j.pi(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,D,conn", [(3, 2, "chain"), (4, 3, "full")])
def test_tabular_random_equals_jax(n, D, conn):
    _assert_tabular_equal(tfg.TabularPairwiseGraph.random(n, D, 0.6, 1, conn),
                          JTabular.random(n, D, 0.6, 1, conn))


def test_tabular_from_match_graph_equals_jax():
    t = tfg.TabularPairwiseGraph.from_match_graph(
        tfg.make_potts_graph(grid=2, beta=0.5, D=3, device="cpu"))
    _assert_tabular_equal(t, JTabular.from_match_graph(
        j_potts(grid=2, beta=0.5, D=3)))


@pytest.fixture(scope="module")
def tiny_pair():
    args = dict(n=3, D=2, max_energy=0.6, seed=1, connectivity="chain")
    return tfg.TabularPairwiseGraph.random(**args), JTabular.random(**args)


def _assert_close(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for p, q in zip(a, b):
            _assert_close(p, q)
    elif isinstance(a, (float, int, np.floating, np.integer)):
        assert a == pytest.approx(b, abs=1e-12)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("fn,args", [
    ("gibbs_transition_matrix", ()),
    ("mgpmh_transition_matrix", (4.0, 10)),
    ("enumerate_global_estimator", (8.0, 8)),
    ("min_gibbs_augmented_chain", (8.0, 8)),
    ("double_min_augmented_chain", (4.0, 9, 8.0, 8)),
])
def test_spectral_validators_equal_jax(tiny_pair, fn, args):
    t, j = tiny_pair
    got = getattr(tsp, fn)(t, *args)
    want = getattr(jsp, fn)(j, *args)
    _assert_close(got, want)
    if fn != "enumerate_global_estimator":
        T, pi = got[0], got[1]
        assert tsp.spectral_gap(T, pi) == pytest.approx(
            jsp.spectral_gap(want[0], want[1]), abs=1e-12)
        assert tsp.reversibility_error(T, pi) == pytest.approx(
            jsp.reversibility_error(want[0], want[1]), abs=1e-12)


def test_truncated_poisson_pmf_equals_jax():
    for mu, cap in ((0.5, 8), (4.0, 14), (30.0, 60)):
        np.testing.assert_allclose(tsp.truncated_poisson_pmf(mu, cap),
                                   jsp.truncated_poisson_pmf(mu, cap),
                                   rtol=0, atol=1e-12)


def test_exact_marginals_and_gap_equal_jax():
    for beta in (0.5, 1.3):
        t = tfg.make_potts_graph(grid=2, beta=beta, D=3, device="cpu")
        j = j_potts(grid=2, beta=beta, D=3)
        np.testing.assert_allclose(texact.exact_marginals(t),
                                   jexact.exact_marginals(j), rtol=0,
                                   atol=1e-12)
        assert texact.exact_gibbs_gap(t) == pytest.approx(
            jexact.exact_gibbs_gap(j), abs=1e-12)
    est = np.full((4, 3), 1 / 3) + np.array([0.1, -0.1, 0.0])
    np.testing.assert_array_equal(texact.tv_to_exact(est, np.full((4, 3),
                                                                  1 / 3)),
                                  jexact.tv_to_exact(est, np.full((4, 3),
                                                                  1 / 3)))
    with pytest.raises(ValueError, match="exceeds"):
        texact.exact_marginals(tfg.make_ising_graph(grid=5, device="cpu"))


def test_exact_conditional_marginals_equal_jax():
    t = engine.make_workload("hetero-pairs-24", device="cpu").graph
    j = jengine.make_workload("hetero-pairs-24").graph
    for sites, vals in (([], []), ([0, 5, 7], [1, 0, 1])):
        np.testing.assert_allclose(
            texact.exact_conditional_marginals(t, sites, vals),
            jexact.exact_conditional_marginals(j, sites, vals), rtol=0,
            atol=1e-12)
    g3 = tfg.make_ising_graph(grid=2, beta=0.7, device="cpu")
    np.testing.assert_allclose(
        texact.exact_conditional_marginals(g3, [1], [0]),
        jexact.exact_conditional_marginals(j_ising(grid=2, beta=0.7), [1],
                                           [0]), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="duplicate evidence"):
        texact.exact_conditional_marginals(t, [0, 0], [1, 1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_bucket_energy_kernel_equals_plain_version(cuda):
    for C, K, D in BUCKET_SHAPES + [(256, 8, 10), (256, 32, 10),
                                    (256, 128, 10), (64, 8192, 2)]:
        for weights in ("integer", "normal"):
            w, v = (torch.from_numpy(a).to(cuda)
                    for a in _bucket_inputs(C, K, D, weights))
            before = minibatch_energy.bucket_energy_cuda.launches
            got = ops.bucket_energy(w, v, D)
            want = tref.bucket_energy_ref(w, v, D)
            again = ops.bucket_energy(w, v, D)
            torch.cuda.synchronize()
            assert minibatch_energy.bucket_energy_cuda.launches == before + 2
            assert torch.equal(got, again)           # fixed summation order
            if weights == "integer":
                assert torch.equal(got, want), (C, K, D)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    w = torch.ones((1, 4), device=cuda, dtype=torch.float16)
    v = torch.tensor([[0, 1, 5, 9]], device=cuda)
    assert ops.bucket_energy(w, v, 3).tolist() == [[1.0, 1.0, 0.0]]


@pytest.mark.gpu
def test_local_gibbs_on_the_card_reaches_exact_marginals(cuda):
    """One fused local-sweep launch per sweep call, and no bucket-energy
    launch: the engine no longer runs the single-site step."""
    g = tfg.make_potts_graph(grid=2, beta=0.5, D=3, device=cuda)
    eng = engine.make("local-gibbs", g, sweep=8, batch_size=g.n - 1)
    assert eng.backend == "cuda"
    before = minibatch_energy.bucket_energy_cuda.launches
    fused = local_sweep.local_gibbs_sweep_cuda.launches
    tr = _run_engine(eng, 1024, 40)
    assert local_sweep.local_gibbs_sweep_cuda.launches - fused == 40
    assert minibatch_energy.bucket_energy_cuda.launches - before == 0
    emp = (tr.marg.sum(0) / (40 * 1024)).cpu().numpy()
    assert np.abs(emp - _exact(g)).max() < 0.02
