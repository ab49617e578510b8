"""The port's MIN-Gibbs and DoubleMIN samplers (global minibatches) and the
in-kernel-RNG sweeps, on the CPU against the JAX package — and, on a machine
with a CUDA card, the five new kernels against their plain versions.

  * plain-version parity: ``min_gibbs_sweep_ref`` / ``double_min_sweep_ref``
    make the same decisions as the JAX oracles (``repro.kernels.ref``) fed
    the same numpy-drawn inputs, at the shapes of ``tests/test_sweep.py``;
  * the node alias table, the eq.-(2) estimator and the MIN-Gibbs select
    against the JAX package;
  * distributional: the min-gibbs and doublemin engines, and loops of the
    three ``*_rng_ref`` plain versions with fresh seeds, reach the exact
    marginals of an enumerable Potts graph;
  * engine, registry, launcher and wrapper checks; the packed alias
    tables the MIN-Gibbs and DoubleMIN kernels read hold the two tables'
    bits;
  * (gpu) the kernels equal their plain versions on the card, also at
    shapes whose lane rows take a block several passes and are not a
    multiple of 4, and the ``*_rng`` wrappers allocate no stream buffers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores (these small
# tensors gain nothing from more)
torch.set_num_threads(1)

from repro_torch.core import chains, engine, estimators, samplers  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.kernels import fused_sweep, ops  # noqa: E402
from repro_torch.kernels import parity_inputs as pin  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import gibbs as launcher  # noqa: E402

try:    # the JAX reference; a machine with the card may have no JAX, and
    # runs only the gpu tests below, which do not read it
    import jax
    import jax.numpy as jnp
    from repro.core import chains as jchains
    from repro.core import engine as jengine
    from repro.core import estimators as jest
    from repro.core import make_potts_graph as j_make_potts_graph
    from repro.core import samplers as jsamplers
    from repro.core.engine import make_workload as j_make_workload
    from repro.kernels import ref as jref
    from _helpers import exact_marginals
except ImportError:
    jax = None

MIN_GIBBS_SHAPES = [(4, 5, 17, 3, 11), (3, 1, 1, 2, 5), (5, 7, 33, 4, 20)]
DOUBLE_MIN_SHAPES = [(4, 5, 17, 9, 3, 11), (3, 1, 1, 1, 2, 5),
                     (5, 7, 33, 21, 4, 20)]        # (C, S, K1, K2, D, n)
SEEDS = [0, 1, 2 ** 31 - 1]
# D*K = 5155 and K2 = 4099 lanes (neither a multiple of 4): quads of four
# lanes cross candidate boundaries, each row ends inside a quad, and a
# block's 512 threads (2048 lanes a pass) take three passes over each row
SPLIT_MIN = (3, 4, 1031, 5, 300)                    # (C, S, K, D, n)
SPLIT_DMIN = (3, 4, 33, 4099, 4, 300)               # (C, S, K1, K2, D, n)
# the MGPMH kernels' edge shapes (C, S, K, D, n): tests/test_torch_sweep.py
MGPMH_EDGE_SHAPES = [(3, 6, 17, 10, 1001), (2, 3, 9, 33, 7),
                     (3, 4, 600, 5, 301), (2, 3, 17, 10, 23301),
                     (2, 2, 9, 33, 23301)]


def _torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.asarray(a)).to(device) for a in arrays)


# ---------------------------------------------------------------------------
# plain versions vs the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S,K,D,n", MIN_GIBBS_SHAPES)
def test_min_gibbs_sweep_ref_equals_jax_oracle(C, S, K, D, n):
    arrays = pin.min_gibbs_inputs(C, S, K, D, n)
    oracle = jax.jit(jref.min_gibbs_sweep_ref, static_argnums=(13, 14))
    xj, cj = oracle(*map(jnp.asarray, arrays), D, 0.37)
    args = _torch(arrays)
    xt, ct = tref.min_gibbs_sweep_ref(*args, D, 0.37)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert xt.dtype == torch.int32 and ct.dtype == torch.float32
    np.testing.assert_array_equal(args[0].numpy(), arrays[0])   # untouched
    x1, c1 = ops.min_gibbs_sweep(*pin.packed_args(args), D=D,   # CPU route
                                 lscale=0.37)
    assert torch.equal(x1, xt) and torch.equal(c1, ct)


@pytest.mark.parametrize("C,S,K1,K2,D,n", DOUBLE_MIN_SHAPES)
def test_double_min_sweep_ref_equals_jax_oracle(C, S, K1, K2, D, n):
    arrays = pin.double_min_inputs(C, S, K1, K2, D, n)
    oracle = jax.jit(jref.double_min_sweep_ref, static_argnums=(17, 18, 19))
    xj, cj, aj = oracle(*map(jnp.asarray, arrays), D, 0.7, 0.31)
    args = _torch(arrays)
    xt, ct, at = tref.double_min_sweep_ref(*args, D, 0.7, 0.31)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    out = ops.double_min_sweep(*pin.packed_args(args), D=D, scale1=0.7,
                               lscale2=0.31)
    assert all(torch.equal(a, b) for a, b in zip(out, (xt, ct, at)))


@pytest.mark.parametrize("name", ["potts-20x20", "hetero-pairs-24"])
def test_node_alias_table_equals_jax(name):
    jprob, jalias = jsamplers._node_alias_table(j_make_workload(name).graph)
    g = engine.make_workload(name, device="cpu").graph
    prob, alias = samplers._node_alias_table(g)
    np.testing.assert_array_equal(prob.numpy(), np.asarray(jprob))
    np.testing.assert_array_equal(alias.numpy(), np.asarray(jalias))


def test_min_gibbs_estimate_equals_jax():
    """Same factor ids and totals give the same match counts.  The JAX
    estimator evaluates log1p(Psi/lam) in float32 (XLA), the port in
    float64 rounded once, as both packages' sweeps do; the two scales may
    differ by one float32 ulp, so the values are held to 1.2e-7 relative
    and the counts exactly."""
    jg = j_make_workload("potts-20x20").graph
    g = engine.make_workload("potts-20x20", device="cpu").graph
    rng = np.random.default_rng(3)
    C, K, lam = 6, 300, 250.0
    x = rng.integers(0, g.D, (C, g.n)).astype(np.int32)
    x[0] = 0                                         # every draw matches
    idx = rng.integers(0, g.num_factors, (C, K)).astype(np.int32)
    B = rng.integers(0, K + 1, (C,)).astype(np.int32)
    ej = np.array([jest.min_gibbs_estimate(jg, jnp.asarray(x[c]),
                                           jnp.asarray(idx[c]),
                                           jnp.asarray(B[c]), lam)
                   for c in range(C)])
    et = estimators.min_gibbs_estimate(g, *_torch((x, idx, B)), lam).numpy()
    lscale_t = np.float32(estimators.min_gibbs_lscale(g.psi, lam))
    lscale_j = np.asarray(jnp.log1p(jg.psi / lam))
    np.testing.assert_array_equal(np.round(et / lscale_t),
                                  np.round(ej / lscale_j))
    assert float(et[0]) == lscale_t * np.float32(B[0])
    np.testing.assert_allclose(et, ej, rtol=1.2e-7, atol=0)


def test_min_gibbs_select_equals_jax():
    rng = np.random.default_rng(11)
    C, D = 9, 5
    eps = rng.normal(size=(C, D)).astype(np.float32)
    cache = rng.normal(size=(C,)).astype(np.float32) * 3
    xi = rng.integers(0, D, (C,)).astype(np.int32)
    g = rng.gumbel(size=(C, D)).astype(np.float32)
    vj, cj = jsamplers.min_gibbs_select(*map(jnp.asarray, (eps, cache, xi, g)),
                                        jnp.arange(C))
    e_t = torch.from_numpy(eps)
    vt, ct = samplers.min_gibbs_select(e_t, *_torch((cache, xi, g)),
                                       torch.arange(C))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert torch.equal(e_t, torch.from_numpy(eps))     # input untouched


def test_draw_global_minibatch_shapes_and_clamp():
    g = tfg.make_potts_graph(grid=3, beta=1.0, D=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    idx, B = estimators.draw_global_minibatch(gen, g, 50.0, 20, (64,))
    assert idx.shape == (64, 20) and B.shape == (64,)
    assert idx.dtype == torch.int32 and B.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < g.num_factors
    assert int(B.max()) == 20                # Poisson(50) > 20: clamped
    # the flat draw follows p_phi = M_phi / Psi
    idx, _ = estimators.draw_global_minibatch(gen, g, 5.0, 4000, (8,))
    freq = torch.bincount(idx.flatten().long(), minlength=g.num_factors)
    iu, ju = np.triu_indices(g.n, k=1)
    p = g.W.numpy()[iu, ju] / g.psi
    np.testing.assert_allclose(freq.numpy() / 32000, p, atol=0.006)


# ---------------------------------------------------------------------------
# engines and the in-kernel-RNG plain versions: exact marginals
# ---------------------------------------------------------------------------

def _potts():
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    ref = exact_marginals(j_make_potts_graph(grid=2, beta=0.8, D=3))
    return g, ref


def _enumerated_marginals(g):
    """Exact (n, D) marginals of pi(x) ~ exp(zeta(x)) by enumerating the
    D^n states with the port's own energy (no JAX needed)."""
    states = torch.cartesian_prod(*[torch.arange(g.D)] * g.n)
    e = g.energy(states.to(g.device, torch.int32)).double().cpu()
    pi = torch.softmax(e, 0)
    onehot = torch.nn.functional.one_hot(states, g.D).double()
    return torch.einsum("s,snd->nd", pi, onehot).numpy()


def test_enumerated_marginals_equal_jax():
    g, ref = _potts()
    np.testing.assert_allclose(_enumerated_marginals(g), ref, atol=1e-6)


@pytest.mark.parametrize("name,params", [
    ("min-gibbs", dict(capacity=12)),               # P(Poisson(1.26) > 12)
    ("doublemin", dict(capacity1=10, capacity2=12)),  # is below 1e-9
])
def test_engine_marginals(name, params):
    g, ref = _potts()
    eng = engine.make(name, g, sweep=8, device="cpu", **params)
    assert eng.backend == "torch" and eng.cache_init is not None
    st = eng.init(0, 128, start="random")
    tr = chains.run_marginal_experiment(eng, st, n_iters=400 * 8,
                                        n_snapshots=1)
    emp = (tr.marg.sum(0) / (400 * 128)).numpy()
    assert np.abs(emp - ref).max() < 0.03
    assert torch.isfinite(tr.final.cache).all()
    if name == "doublemin":
        acc = tr.final.accepts.sum().item() / (128 * 400 * 8)
        assert 0.0 < acc <= 1.0


def _rng_marginals(step, g, x, n_calls):
    """Run ``step(x, seed) -> x`` with seeds 0..n_calls-1; return the
    chain-averaged marginals."""
    marg = torch.zeros((g.n, g.D))
    for k in range(n_calls):
        x = step(x, torch.tensor([k], dtype=torch.int32))
        marg += torch.nn.functional.one_hot(x.long(), g.D).sum(0)
    return (marg / (n_calls * x.shape[0])).numpy()


@pytest.mark.parametrize("kind", ["mgpmh", "min-gibbs", "doublemin"])
def test_rng_plain_versions_reach_exact_marginals(kind):
    """The in-kernel-RNG plain versions, fed fresh seeds each call (a
    stream-layout fault, e.g. two lanes sharing a word, biases these)."""
    g, ref = _potts()
    C, S, n, D = 128, 8, g.n, g.D
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randint(0, D, (C, n), generator=gen, dtype=torch.int32)
    npb, nab = samplers._node_alias_table(g)
    lam1, K1 = float(4 * g.L ** 2), 10
    lam2, K2 = float(2 * g.psi ** 2), 12
    lscale2 = estimators.min_gibbs_lscale(g.psi, lam2)
    cache = [samplers.init_min_gibbs_cache(
        gen, g, samplers.init_state(gen, g, C)._replace(x=x0), lam2,
        K2).cache]
    acc = [0]

    def sites_and_local_B():
        i = torch.randint(0, n, (C, S), generator=gen, dtype=torch.int32)
        lam_i = (lam1 / g.L) * g.row_sum[i.long()]
        B = torch.poisson(lam_i, generator=gen).clamp_(max=K1)
        return i, B.to(torch.int32)

    def global_B(shape):
        B = torch.poisson(torch.full(shape, lam2), generator=gen)
        return B.clamp_(max=K2).to(torch.int32)

    def mgpmh(x, seed):
        i, B = sites_and_local_B()
        x, a = tref.mgpmh_sweep_rng_ref(x, g.W, g.row_prob, g.row_alias, i,
                                        B, seed, D, g.L / lam1, K1)
        acc[0] += int(a.sum())
        return x

    def min_gibbs(x, seed):
        i = torch.randint(0, n, (C, S), generator=gen, dtype=torch.int32)
        x, cache[0] = tref.min_gibbs_sweep_rng_ref(
            x, npb, nab, g.row_prob, g.row_alias, i, global_B((C, S, D)),
            cache[0], seed, D, lscale2, K2)
        return x

    def double_min(x, seed):
        i, B1 = sites_and_local_B()
        x, cache[0], a = tref.double_min_sweep_rng_ref(
            x, g.row_prob, g.row_alias, npb, nab, i, B1, global_B((C, S)),
            cache[0], seed, D, g.L / lam1, lscale2, K1, K2)
        acc[0] += int(a.sum())
        return x

    step = {"mgpmh": mgpmh, "min-gibbs": min_gibbs,
            "doublemin": double_min}[kind]
    emp = _rng_marginals(step, g, x0, 200)
    assert np.abs(emp - ref).max() < 0.05
    if kind != "min-gibbs":
        assert 0 < acc[0] <= 200 * C * S


def _rng_case(kind):
    """(plain version, its per-chain inputs, the rest, per-chain
    positions) of one in-kernel-RNG sweep at a parity shape."""
    if kind == "mgpmh":
        a = _torch(pin.mgpmh_inputs(5, 4, 17, 3, 11))[:6]
        return (lambda args, seed, **kw: tref.mgpmh_sweep_rng_ref(
            *args, seed, 3, 0.7, 17, **kw)), a, (0, 4, 5)
    if kind == "min-gibbs":
        a = _torch(pin.min_gibbs_inputs(5, 4, 17, 3, 11))
        return (lambda args, seed, **kw: tref.min_gibbs_sweep_rng_ref(
            *args, seed, 3, 0.37, 17, **kw)), a[:7] + a[-1:], (0, 5, 6, 7)
    a = _torch(pin.double_min_inputs(5, 4, 17, 9, 3, 11))
    return (lambda args, seed, **kw: tref.double_min_sweep_rng_ref(
        *args, seed, 3, 0.7, 0.31, 17, 9, **kw)), \
        a[:7] + (a[10], a[-1]), (0, 5, 6, 7, 8)


@pytest.mark.parametrize("kind", ["mgpmh", "min-gibbs", "doublemin"])
def test_rng_plain_versions_on_chain_slices_equal_the_whole_call(kind):
    """With ``chain0``, a plain in-kernel-RNG version run on a slice of the
    chains gives those chains' outputs of the whole call, so a call too
    large for the plain version's streams can be checked slice by slice."""
    plain, args, per_chain = _rng_case(kind)
    seed = torch.tensor([2 ** 31 - 1], dtype=torch.int32)
    whole = plain(args, seed)
    for lo, hi in ((0, 2), (2, 5), (4, 5)):
        part = plain(tuple(a[lo:hi] if j in per_chain else a
                           for j, a in enumerate(args)), seed, chain0=lo)
        for p, w in zip(part, whole):
            assert torch.equal(p, w[lo:hi]), (kind, lo)
    # without the offset the slice draws chain 0's streams: different
    part = plain(tuple(a[2:5] if j in per_chain else a
                       for j, a in enumerate(args)), seed)
    assert not all(torch.equal(p, w[2:5]) for p, w in zip(part, whole))


@pytest.mark.parametrize("name,C,calls", [("min-gibbs", 8, 4),
                                           ("doublemin", 8, 20)])
def test_capped_lambda_chains_are_as_sticky_as_the_jax_reference(name, C,
                                                                  calls):
    """At the default lambda = min(2 Psi^2, 16384) on potts-20x20 (Psi =
    957, so the cap binds 112-fold) both packages' chains rarely move from
    the constant start: a cached estimate is kept when it wins (MIN-Gibbs)
    or is accepted (DoubleMIN).  The port's counts of changed values and
    accepts equal the JAX engines' within 4 Poisson sigmas.  Run with
    ``-s`` to print the witness."""
    S = 8
    jg = j_make_workload("potts-20x20").graph
    je = jengine.make(name, jg, sweep=S, backend="jnp")
    jst = je.init(jax.random.PRNGKey(0), C)
    jtr = jchains.run_marginal_experiment(je, jst, n_iters=calls * S,
                                          n_snapshots=1)
    g = engine.make_workload("potts-20x20", device="cpu").graph
    eng = engine.make(name, g, sweep=S, device="cpu")
    assert eng.params == je.params
    st = eng.init(0, C)
    tr = chains.run_marginal_experiment(eng, st, n_iters=calls * S,
                                        n_snapshots=1)
    updates = C * S * calls
    counts = {
        "jax": (int((np.asarray(jtr.final.x) != np.asarray(jst.x)).sum()),
                int(np.asarray(jtr.final.accepts).sum())),
        "port": (int((tr.final.x != st.x).sum()),
                 int(tr.final.accepts.sum()))}
    print(f"\n{name} potts-20x20 params {eng.params}, {C} chains x {calls} "
          f"sweeps of {S} = {updates} updates from the constant start: "
          + "; ".join(f"{k} {m} values changed, {a} accepted"
                      for k, (m, a) in counts.items()))
    for j in range(2 if name == "doublemin" else 1):
        a, b = counts["jax"][j], counts["port"][j]
        assert abs(a - b) <= 4 * np.sqrt(a + b) + 4
    assert counts["port"][0] > 0


# ---------------------------------------------------------------------------
# engine, registry, launcher, wrappers
# ---------------------------------------------------------------------------

def test_engine_init_seeds_a_cache_and_defaults_follow_the_jax_package():
    g = engine.make_workload("potts-20x20", device="cpu").graph
    eng = engine.make("min-gibbs", g, sweep=2, device="cpu")
    assert eng.params["lam"] == 16384.0 and eng.exact_accept
    assert eng.params["capacity"] == estimators.recommended_capacity(16384.0)
    st = eng.init(0, 5, start="random")
    assert st.cache.shape == (5,) and st.cache.dtype == torch.float32
    assert torch.isfinite(st.cache).all() and len(set(st.cache.tolist())) > 1
    st0 = eng.init(0, 5, start="random")
    assert torch.equal(st.cache, st0.cache)            # seeded, replayable
    st = eng.sweep(st)
    assert torch.isfinite(st.cache).all()
    d = engine.make("doublemin", g, sweep=2, device="cpu")
    assert d.params["lam1"] == pytest.approx(4 * g.L ** 2)
    assert d.params["lam2"] == min(2 * g.psi ** 2, 16384.0)
    assert not d.exact_accept
    assert torch.isfinite(d.init(1, 3).cache).all()
    small = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    assert engine.make("min-gibbs", small, device="cpu").params["lam"] == \
        pytest.approx(2 * small.psi ** 2)


def test_registry_lists_four_engines_and_refuses_local_gibbs():
    """Written when local-gibbs was not ported; now the registry holds all
    five engines of the JAX package, and local-gibbs is refused only what
    the JAX engine refuses (schedules other than UniformSites, unknown
    params)."""
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    assert engine.names() == ("doublemin", "gibbs", "local-gibbs", "mgpmh",
                              "min-gibbs")
    assert not hasattr(engine, "NOT_PORTED")
    eng = engine.make("local-gibbs", g, device="cpu")
    assert engine.backends("local-gibbs") == ("torch", "cuda")
    assert eng.params == {"batch_size": g.n - 1} and eng.exact_accept
    assert eng.updates_per_call == 1 and eng.cache_init is None
    colors = engine.ChromaticBlocks(np.arange(g.n) % 2)
    for name in ("min-gibbs", "doublemin", "local-gibbs"):
        with pytest.raises(ValueError, match="only the UniformSites"):
            engine.make(name, g, schedule=colors, device="cpu")
    with pytest.raises(TypeError, match="unknown params"):
        engine.make("doublemin", g, lam=3.0, device="cpu")
    with pytest.raises(TypeError, match="unknown params"):
        engine.make("local-gibbs", g, lam=3.0, device="cpu")


def test_engines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    for name in ("min-gibbs", "doublemin"):
        with pytest.raises(RuntimeError, match="is_available"):
            engine.make(name, g, sweep=2)


def test_launcher_runs_min_gibbs_and_doublemin(capsys):
    launcher.main(["--config", "hetero-pairs-24", "--engine", "min-gibbs",
                   "--steps", "3", "--chains", "3", "--sweep", "2",
                   "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("[gibbs] step       3 ")
    assert "acc=1.000" in out[-1]
    launcher.main(["--config", "hetero-pairs-24", "--engine", "doublemin",
                   "--steps", "2", "--chains", "3", "--device", "cpu"])
    assert "k updates/s" in capsys.readouterr().out


def test_new_cuda_wrappers_refuse_cpu_tensors_and_bad_inputs():
    fused_sweep.reset_launch_counts()
    plain = _torch(pin.min_gibbs_inputs(4, 5, 17, 3, 11))
    a = pin.packed_args(plain)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.min_gibbs_sweep_cuda(*a, D=3, lscale=0.37)
    with pytest.raises(ValueError, match="B must have shape"):
        bad = list(a)
        bad[4] = bad[4][..., :2].contiguous()
        fused_sweep.min_gibbs_sweep_cuda(*bad, D=3, lscale=0.37)
    seed = torch.zeros((1,), dtype=torch.int32)
    x, node, row, i, B = a[:5]
    rp, ra = plain[3:5]
    cache = a[-1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.min_gibbs_sweep_rng_cuda(x, node, row, i, B, cache, seed,
                                             D=3, lscale=0.37, K=17)
    with pytest.raises(ValueError, match="seed must have shape"):
        fused_sweep.min_gibbs_sweep_rng_cuda(x, node, row, i, B, cache,
                                             seed[:0], D=3, lscale=0.37, K=17)
    d = pin.packed_args(_torch(pin.double_min_inputs(4, 5, 17, 9, 3, 11)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.double_min_sweep_cuda(*d, D=3, scale1=0.7, lscale2=0.31)
    with pytest.raises(ValueError, match="cache must be torch.float32"):
        fused_sweep.double_min_sweep_rng_cuda(
            *d[:5], d[8], d[-1].double(), seed, D=3, scale1=0.7,
            lscale2=0.31, K1=17, K2=9)
    W = torch.zeros((11, 11))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.mgpmh_sweep_rng_cuda(x, W, tfg.pack_alias(rp, ra), i,
                                         B[..., 0].contiguous(), seed, D=3,
                                         scale=0.7, K=17)
    assert all(fn.launches == 0 for fn in fused_sweep.WRAPPERS)


def test_packed_alias_tables_hold_both_tables_bits():
    """A packed record holds prob's float32 bits and the alias exactly, for
    the row tables of potts-20x20 (built once per graph, and moved with
    it), a parity ``alias_rows`` table and a node table."""
    g = engine.make_workload("potts-20x20", device="cpu").graph
    rp, ra = pin.alias_rows(np.random.default_rng(5), 37)[1:]
    npb, nab = samplers._node_alias_table(g)
    for prob, alias, pack in (
            (g.row_prob, g.row_alias, g.row_pack),
            (*_torch((rp, ra)), tfg.pack_alias(*_torch((rp, ra)))),
            (npb, nab, tfg.pack_alias(npb, nab))):
        assert pack.dtype == torch.int32 and pack.is_contiguous()
        assert pack.shape == (*prob.shape, 2)
        assert torch.equal(pack[..., 0], prob.view(torch.int32))
        assert torch.equal(pack[..., 0].view(torch.float32), prob)
        assert torch.equal(pack[..., 1], alias)
    assert g.row_pack is g.row_pack                    # built once
    assert torch.equal(g.to("cpu").row_pack, g.row_pack)
    fresh = engine.make_workload("potts-20x20", device="cpu").graph
    pack = fresh.row_pack          # packed first: no separate tables kept
    assert "row_prob" not in fresh._tables
    assert torch.equal(pack, g.row_pack)
    with pytest.raises(ValueError, match="float32 prob and int32 alias"):
        tfg.pack_alias(npb.double(), nab)
    with pytest.raises(ValueError, match="differ in shape"):
        tfg.pack_alias(npb[:-1], nab)


@pytest.mark.parametrize("kind", ["min-gibbs", "double-min"])
def test_cuda_wrappers_refuse_bad_packed_tables(kind):
    """The packed tables are checked by shape and dtype, before the device:
    the separate tables, a transposed record layout or int64 records are
    refused by name."""
    if kind == "min-gibbs":
        plain = _torch(pin.min_gibbs_inputs(4, 5, 17, 3, 11))
        call = lambda a: fused_sweep.min_gibbs_sweep_cuda(*a, D=3,
                                                          lscale=0.37)
        node_at, row_at = 1, 2
    else:
        plain = _torch(pin.double_min_inputs(4, 5, 17, 9, 3, 11))
        call = lambda a: fused_sweep.double_min_sweep_cuda(
            *a, D=3, scale1=0.7, lscale2=0.31)
        node_at, row_at = 2, 1
    good = pin.packed_args(plain)
    cases = [(row_at, good[row_at].permute(2, 0, 1).contiguous(),
              r"row_pack must have shape \(11, 11, 2\)"),
             (row_at, good[row_at].long(), "row_pack must be torch.int32"),
             (row_at, plain[3 if kind == "min-gibbs" else 1],
              "row_pack must be torch.int32"),
             (node_at, good[node_at][:, :1].contiguous(),
              r"node_pack must have shape \(11, 2\)"),
             (node_at, good[node_at].float(), "node_pack must be torch.int32"),
             (row_at, good[row_at][:, :, :2].transpose(0, 1),
              "row_pack must be contiguous")]
    for at, table, msg in cases:
        bad = list(good)
        bad[at] = table
        with pytest.raises(ValueError, match=msg):
            call(bad)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(good)


def test_ops_send_packed_sweeps_on_the_cpu_to_the_plain_versions():
    """On CPU tensors ``ops`` takes the packed tables, as the kernels do,
    calls the plain versions on the two tables read back from them, and
    never the kernels."""
    fused_sweep.reset_launch_counts()
    a = _torch(pin.min_gibbs_inputs(4, 5, 17, 3, 11))
    want = tref.min_gibbs_sweep_ref(*a, 3, 0.37)
    got = ops.min_gibbs_sweep(*pin.packed_args(a), D=3, lscale=0.37)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    d = _torch(pin.double_min_inputs(4, 5, 17, 9, 3, 11))
    want = tref.double_min_sweep_ref(*d, 3, 0.7, 0.31)
    got = ops.double_min_sweep(*pin.packed_args(d), D=3, scale1=0.7,
                               lscale2=0.31)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert all(fn.launches == 0 for fn in fused_sweep.WRAPPERS)


# ---------------------------------------------------------------------------
# on the card: kernels vs their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,K,D,n", MIN_GIBBS_SHAPES)
def test_min_gibbs_kernels_equal_plain_versions(cuda, C, S, K, D, n):
    args = _torch(pin.min_gibbs_inputs(C, S, K, D, n), cuda)
    out = fused_sweep.min_gibbs_sweep_cuda(*pin.packed_args(args), D=D,
                                           lscale=0.37)
    want = tref.min_gibbs_sweep_ref(*args, D, 0.37)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    x, npb, nab, rp, ra, i, B = args[:7]
    for seed in SEEDS:
        s = torch.tensor([seed], dtype=torch.int32, device=cuda)
        out = fused_sweep.min_gibbs_sweep_rng_cuda(
            *pin.packed_args(args[:7]), args[-1], s, D=D, lscale=0.37, K=K)
        want = tref.min_gibbs_sweep_rng_ref(x, npb, nab, rp, ra, i, B,
                                            args[-1], s, D, 0.37, K)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), seed


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,K1,K2,D,n", DOUBLE_MIN_SHAPES)
def test_double_min_kernels_equal_plain_versions(cuda, C, S, K1, K2, D, n):
    args = _torch(pin.double_min_inputs(C, S, K1, K2, D, n), cuda)
    out = fused_sweep.double_min_sweep_cuda(*pin.packed_args(args), D=D,
                                            scale1=0.7, lscale2=0.31)
    want = tref.double_min_sweep_ref(*args, D, 0.7, 0.31)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    head, B2, cache = args[:7], args[10], args[-1]
    for seed in SEEDS:
        s = torch.tensor([seed], dtype=torch.int32, device=cuda)
        out = fused_sweep.double_min_sweep_rng_cuda(
            *pin.packed_args(head), B2, cache, s, D=D, scale1=0.7,
            lscale2=0.31, K1=K1, K2=K2)
        want = tref.double_min_sweep_rng_ref(*head, B2, cache, s, D, 0.7,
                                             0.31, K1, K2)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), seed


def _same_twice(launch, want):
    """``launch()`` twice equals ``want`` bit for bit both times."""
    first, again = launch(), launch()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) and torch.equal(b, w)
               for a, b, w in zip(first, again, want))


@pytest.mark.gpu
def test_min_gibbs_kernels_at_long_lane_rows_equal_plain_versions(cuda):
    """MIN-Gibbs at a shape whose D*K lanes (not a multiple of 4) take a
    block three passes, with quads across candidate boundaries and rows of
    B at 0 and at K: the host-stream and Philox forms equal their plain
    versions bit for bit, and a second launch gives the same bits."""
    C, S, K, D, n = SPLIT_MIN
    arrays = list(pin.min_gibbs_inputs(*SPLIT_MIN))
    arrays[6] = pin.edge_totals(arrays[6], K)
    args = _torch(arrays, cuda)
    kargs = pin.packed_args(args)
    assert _same_twice(
        lambda: fused_sweep.min_gibbs_sweep_cuda(*kargs, D=D, lscale=0.37),
        tref.min_gibbs_sweep_ref(*args, D, 0.37))
    head = args[:7] + (args[-1],)
    for seed in SEEDS:
        s = torch.tensor([seed], dtype=torch.int32, device=cuda)
        assert _same_twice(
            lambda: fused_sweep.min_gibbs_sweep_rng_cuda(
                *kargs[:5], args[-1], s, D=D, lscale=0.37, K=K),
            tref.min_gibbs_sweep_rng_ref(*head, s, D, 0.37, K)), seed


@pytest.mark.gpu
def test_double_min_kernels_at_long_lane_rows_equal_plain_versions(cuda):
    """DoubleMIN with K2 = 4099 pair-draw lanes, three passes of the block
    ending inside a quad, rows of B1 and B2 at 0 and at capacity: both
    forms equal their plain versions bit for bit, twice."""
    C, S, K1, K2, D, n = SPLIT_DMIN
    arrays = list(pin.double_min_inputs(*SPLIT_DMIN))
    arrays[6] = pin.edge_totals(arrays[6], K1)
    arrays[10] = pin.edge_totals(arrays[10], K2)
    args = _torch(arrays, cuda)
    kargs = pin.packed_args(args)
    assert _same_twice(
        lambda: fused_sweep.double_min_sweep_cuda(
            *kargs, D=D, scale1=0.7, lscale2=0.31),
        tref.double_min_sweep_ref(*args, D, 0.7, 0.31))
    head = args[:7] + (args[10], args[-1])
    for seed in SEEDS:
        s = torch.tensor([seed], dtype=torch.int32, device=cuda)
        assert _same_twice(
            lambda: fused_sweep.double_min_sweep_rng_cuda(
                *kargs[:5], args[10], args[-1], s, D=D, scale1=0.7,
                lscale2=0.31, K1=K1, K2=K2),
            tref.double_min_sweep_rng_ref(*head, s, D, 0.7, 0.31, K1,
                                          K2)), seed


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,K,D,n", [(4, 5, 17, 3, 11), (8, 8, 128, 10, 40),
                                       (2, 3, 9, 129, 7)] + MGPMH_EDGE_SHAPES)
def test_mgpmh_rng_kernel_equals_plain_version(cuda, C, S, K, D, n):
    """The Philox form, reading the packed row records, equals its plain
    version for three seeds, also at the edge shapes of the host form's
    test (``parity_inputs.mgpmh_edge_inputs``)."""
    if (C, S, K, D, n) in MGPMH_EDGE_SHAPES:
        args = pin.mgpmh_edge_inputs(C, S, K, D, n, cuda)[:6]
    else:
        rng = np.random.default_rng(C + S + K + D + n)
        _, rp, ra = pin.alias_rows(rng, n)
        W = rng.uniform(size=(n, n)).astype(np.float32)
        x = rng.integers(0, D, (C, n)).astype(np.int32)
        i = rng.integers(0, n, (C, S)).astype(np.int32)
        B = rng.integers(0, K + 1, (C, S)).astype(np.int32)
        args = _torch((x, W, rp, ra, i, B), cuda)
    kargs = pin.packed_mgpmh_args(args)
    for seed in SEEDS:
        s = torch.tensor([seed], dtype=torch.int32, device=cuda)
        out = fused_sweep.mgpmh_sweep_rng_cuda(*kargs, s, D=D, scale=0.7, K=K)
        want = tref.mgpmh_sweep_rng_ref(*args, s, D, 0.7, K)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), seed


@pytest.mark.gpu
def test_engines_on_the_card_reach_exact_marginals(cuda):
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device=cuda)
    ref = _enumerated_marginals(g)
    for name, params in (("min-gibbs", dict(capacity=12)),
                         ("doublemin", dict(capacity1=10, capacity2=12))):
        eng = engine.make(name, g, sweep=8, **params)
        assert eng.backend == "cuda"
        st = eng.init(0, 256, start="random")
        tr = chains.run_marginal_experiment(eng, st, n_iters=1000 * 8,
                                            n_snapshots=1)
        emp = (tr.marg.sum(0) / (1000 * 256)).cpu().numpy()
        assert np.abs(emp - ref).max() < 0.03, name


@pytest.mark.gpu
def test_rng_wrappers_allocate_no_stream_buffers(cuda):
    C, S, K, D, n = 64, 16, 4096, 10, 256
    tables = _torch(pin.min_gibbs_inputs(8, 1, 1, D, n)[:5], cuda)
    node, row = pin.packed_args(tables)[1:3]
    x = torch.zeros((C, n), dtype=torch.int32, device=cuda)
    i = torch.randint(0, n, (C, S), dtype=torch.int32, device=cuda)
    B = torch.full((C, S, D), K, dtype=torch.int32, device=cuda)
    cache = torch.zeros((C,), device=cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    out = fused_sweep.min_gibbs_sweep_rng_cuda(x, node, row, i, B, cache,
                                               seed, D=D, lscale=0.3, K=K)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - before
    outputs = sum(t.numel() * t.element_size() for t in out)
    assert grown <= outputs + (1 << 20)        # streams: 4*C*S*D*K*4 = 671 MB
