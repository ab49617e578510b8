"""The port's dist backend (``repro_torch.runtime.dist_gibbs``,
``repro_torch.launch.mesh``, ``engine.make(..., mesh=)``) against the JAX
package and the exact marginals, on the CPU under gloo.

  * the sharded tables (``ShardedMatchGraph.from_graph``) equal the JAX
    package's, shard by shard, for potts 4x4 D=3 at 1, 2 and 4 shards;
  * ``psum_footprint`` equals the JAX function for every algorithm and for
    chromatic; ``_exact_partials`` and ``_global_matches`` equal JAX's on
    the same inputs (rtol 1e-6); the slot-table ``_global_partials``
    equals a direct port of the JAX mask form on the same draws;
  * the shards' partials summed and the replicated recursion give the
    same bits as S sequential single-site updates recomputed from the full
    W on the same draws, for every algorithm at 1, 2 and 4 shards;
  * spawned gloo ranks (``torch_dist_workers``): the four engines reach the
    exact marginals within the JAX test's 0.05, and the exact edge
    agreements (which depend on W), on a world of one rank and on a 2x2
    mesh, with one all-reduce per call; chromatic gibbs on 2 ranks
    is bit-equal to the dense reference on lattice-ising-64x64, one
    all-reduce per color class; AdaptiveScan on 2x2 as
    ``tests/test_distributed.py:213-247``; telemetry at dp = 1 within the
    bounds of ``tests/test_distributed.py:250-289``; replays bit-equal;
  * the dist backend's refusals carry the JAX package's message;
  * the supervised runtime over gloo ranks: on a 2x2 mesh the launcher's
    ``run_supervised`` under the JAX dist test's plan (arrays corrupt +
    preempt at outer step 2, ``nan`` x at 4) ends bit-equal (marginals
    and every rank's x) to the clean run, with a restart and a ``health``
    rollback; a device loss keeping 2 of the 4 ranks rebuilds the engine
    on a 1x2 mesh (an ``elastic`` incident, ranks 2 and 3 leave) and the
    run reaches the exact marginals and edge agreements of potts 2x2; a
    loss keeping 1 rank of a 1x2 mesh raises a ``ValueError`` on both
    ranks; the launcher's factory lets rank 1 of a 2x1 mesh leave; the
    launcher's ``--ckpt-dir`` rerun on a 1x2 mesh resumes bit-exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.factor_graph import make_potts_graph as jpotts  # noqa: E402
from repro.runtime import dist_gibbs as JDG  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.estimators import min_gibbs_lscale  # noqa: E402
from repro_torch.core.factor_graph import (MatchGraph,  # noqa: E402
                                           make_potts_graph)
from repro_torch.runtime import dist_gibbs as DG  # noqa: E402

import torch_dist_workers as W  # noqa: E402

ARRAYS = ("W_cols", "row_prob", "row_alias", "row_sum", "pair_a", "pair_b",
          "pair_prob", "pair_alias")


def _graphs(grid=4, beta=4.6, D=3):
    return (make_potts_graph(grid, beta, D, device="cpu"),
            jpotts(grid, beta, D))


# -- sharded tables and pure functions against the JAX package --------------

@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_tables_equal_jax(n_shards, tables):
    g, jg = _graphs()
    ref = JDG.ShardedMatchGraph.from_graph(jg, n_shards, row_tables=tables,
                                           pair_tables=tables)
    shards = [DG.ShardedMatchGraph.from_graph(g, n_shards, s,
                                              row_tables=tables,
                                              pair_tables=tables)
              for s in range(n_shards)]
    for name in ARRAYS:
        got = np.stack([getattr(sh, name).numpy() for sh in shards])
        want = np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        # bit-equal (the alias tables: the same Vose steps)
        np.testing.assert_array_equal(got.view(np.int32)
                                      if got.dtype == np.float32 else got,
                                      want.view(np.int32)
                                      if want.dtype == np.float32 else want,
                                      err_msg=name)
    psi = np.asarray(ref.psi_loc)
    assert [np.float32(sh.psi_loc) for sh in shards] == list(psi)
    for sh in shards:
        assert sh.row_sum_max == float(np.asarray(ref.row_sum).max())
        assert sh.psi_loc_max == float(psi.max())
        assert (sh.n, sh.D, sh.n_loc, sh.psi, sh.L) == (
            ref.n, ref.D, ref.n_loc, ref.psi, ref.L)


@pytest.mark.parametrize("algo", ["gibbs", "mgpmh", "min-gibbs",
                                  "doublemin", "chromatic"])
def test_psum_footprint_equals_jax(algo):
    for C, D, S, n, k in ((256, 10, 64, 4096, 2), (32, 2, 8, 24, 2),
                          (7, 3, 5, 16, 3)):
        kw = dict(C=C, D=D, S=S, n=n, n_colors=k)
        assert DG.psum_footprint(algo, **kw) == JDG.psum_footprint(algo,
                                                                   **kw)


def _shard_inputs(n_shards, shard, C=5, S=6, seed=0):
    g, jg = _graphs()
    rng = np.random.default_rng(seed)
    x = rng.integers(0, g.D, (C, g.n)).astype(np.int32)
    i = rng.integers(0, g.n, (C, S)).astype(np.int32)
    i[:, 3] = i[:, 1]                        # duplicate sites in a sweep
    gs = DG.ShardedMatchGraph.from_graph(g, n_shards, shard)
    jgs = JDG.ShardedMatchGraph.from_graph(jg, n_shards)
    sh = {k: getattr(jgs, k)[shard] for k in ARRAYS}
    n_loc = g.n // n_shards
    oh = (x[:, shard * n_loc:(shard + 1) * n_loc, None]
          == np.arange(g.D)).astype(np.float32)
    return g, gs, jgs, sh, x, i, oh


@pytest.mark.parametrize("n_shards,shard", [(1, 0), (2, 1), (4, 2)])
def test_exact_partials_equal_jax(n_shards, shard):
    _, gs, jgs, sh, _, i, oh = _shard_inputs(n_shards, shard)
    e0, wp, (owned, loc) = DG._exact_partials(gs, torch.from_numpy(oh),
                                              torch.from_numpy(i), shard)
    je0, jwp, _ = JDG._exact_partials(jgs, sh, jnp.asarray(oh),
                                      jnp.asarray(i), shard)
    np.testing.assert_allclose(e0.numpy(), np.asarray(je0), rtol=1e-6)
    np.testing.assert_allclose(wp.numpy(), np.asarray(jwp), rtol=1e-6)
    assert owned.any() or n_shards > 1


@pytest.mark.parametrize("U", [1, 3])
def test_global_matches_equal_jax(U):
    rng = np.random.default_rng(U)
    C, S, D = 4, 6, 3
    m0 = rng.integers(0, 9, (C, U)).astype(np.float32)
    n1 = rng.integers(0, 5, (C, U, S, D)).astype(np.float32)
    n2 = rng.integers(0, 5, (C, U, S, S)).astype(np.float32)
    vals = rng.integers(0, D, (C, U, S)).astype(np.int32)
    got = DG._global_matches(*map(torch.from_numpy, (m0, n1, n2, vals)))
    want = JDG._global_matches(*map(jnp.asarray, (m0, n1, n2, vals)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _global_partials_masks(gs, x0, i, draws):
    """A direct port of the JAX package's mask form
    (``src/repro/runtime/dist_gibbs.py:387-415``) on given draws, with the
    alias draw the right way round (the JAX line 391 swaps idx and its
    alias)."""
    B, idx, u = draws
    C, S, U, K = idx.shape
    f = torch.where(u < gs.pair_prob[idx], idx, gs.pair_alias[idx]).long()
    a, b = gs.pair_a[f].long(), gs.pair_b[f].long()
    w = (torch.arange(K) < B[..., None].long()).float()
    am = a[..., None] == i.long()[:, None, None, None, :]   # (C,S,U,K,S)
    bm = b[..., None] == i.long()[:, None, None, None, :]
    a_in, ta = am.any(-1), am.float().argmax(-1)
    b_in, tb = bm.any(-1), bm.float().argmax(-1)
    rows = torch.arange(C)[:, None, None, None]
    x0a, x0b = x0.long()[rows, a], x0.long()[rows, b]
    m0 = (w * (~a_in & ~b_in & (x0a == x0b))).sum(-1)
    ci = torch.arange(C)[:, None, None, None].expand_as(a)
    si = torch.arange(S)[None, :, None, None].expand_as(a)
    ui = torch.arange(U)[None, None, :, None].expand_as(a)
    n1 = torch.zeros((C, S, U, S, gs.D))
    n1.index_put_((ci, si, ui, ta, x0b), w * (a_in & ~b_in), accumulate=True)
    n1.index_put_((ci, si, ui, tb, x0a), w * (b_in & ~a_in), accumulate=True)
    n2 = torch.zeros((C, S, U, S, S))
    n2.index_put_((ci, si, ui, ta, tb), w * (a_in & b_in), accumulate=True)
    return m0, n1, n2


@pytest.mark.parametrize("n_shards,shard,U", [(1, 0, 3), (2, 1, 1),
                                              (4, 3, 3)])
def test_global_partials_slot_table_equals_mask_form(n_shards, shard, U):
    _, gs, _, _, x, i, _ = _shard_inputs(n_shards, shard, C=6, S=7, seed=U)
    gen = torch.Generator()
    gen.manual_seed(11)
    draws = DG._global_draws(gs, gen, 6, 7, U, lam2=40.0, capacity2=64)
    assert (draws[0] > 0).any() and (draws[0] == 64).sum() < draws[0].numel()
    got = DG._global_partials(gs, torch.from_numpy(x), torch.from_numpy(i),
                              draws)
    want = _global_partials_masks(gs, torch.from_numpy(x),
                                  torch.from_numpy(i), draws)
    for name, a, b in zip(("m0", "n1", "n2"), got, want):
        assert torch.equal(a, b), name
    assert got[1].sum() > 0 and got[2].sum() > 0   # both kinds of hit occur


def test_first_slots_is_the_first_occurrence():
    i = torch.tensor([[3, 1, 3, 0], [2, 2, 2, 2]], dtype=torch.int32)
    slot = DG._first_slots(i, 5)
    assert slot.tolist() == [[3, 1, -1, 0, -1], [-1, -1, 0, -1, -1]]


# -- the recursion against sequential exact updates on the same draws --------

def _dyadic_graph(n=8, D=3, seed=5):
    """A dense graph whose weights are multiples of 1/8: every energy is an
    exact float32 sum in any order, so the delta-corrected recursion and a
    recomputation from the full W agree to the bit."""
    rng = np.random.default_rng(seed)
    A = np.triu(rng.integers(1, 9, (n, n)) / 8.0, 1)
    return MatchGraph.from_interactions(A + A.T, match_weight_scale=1.0, D=D,
                                        device="cpu")


def _shard_draws(algo, gs, gen, i, U, lam, cap, lam2, cap2):
    """The draws ``_local_partials`` takes from ``gen`` (proposal, then
    global), in global coordinates: per (c, s) proposal column counts
    (C, S, n), and per (c, s, u, k) global endpoints a, b and live mask."""
    C, S = i.shape
    out = {}
    if algo in ("mgpmh", "doublemin"):
        B, idx, u = DG._proposal_draws(gs, gen, i, lam, cap)
        rows = i.long()[..., None].expand_as(idx)
        j = torch.where(u < gs.row_prob[rows, idx.long()], idx,
                        gs.row_alias[rows, idx.long()]).long()
        live = (torch.arange(cap) < B[..., None]).to(torch.int32)
        cnt = torch.zeros((C, S, gs.n), dtype=torch.int32)
        out["cnt"] = cnt.scatter_add_(2, j + gs.shard * gs.n_loc, live)
    if algo in ("min-gibbs", "doublemin"):
        B, idx, u = DG._global_draws(gs, gen, C, S, U, lam2, cap2)
        f = torch.where(u < gs.pair_prob[idx.long()], idx,
                        gs.pair_alias[idx.long()]).long()
        out["ends"] = (gs.pair_a[f].long(), gs.pair_b[f].long(),
                       torch.arange(cap2) < B[..., None])
    return out


def _sequential(algo, g, draws, x0, i, cache, gum, logu, lam, lscale):
    """S single-site updates of ``algo`` one after another, every energy
    recomputed from the full W and the current state, on the given draws
    (``draws``: one :func:`_shard_draws` per shard)."""
    from repro_torch.core.samplers import (gibbs_select, mh_accept,
                                           min_gibbs_select)
    C, S = i.shape
    W, D, rows = g.W.double(), g.D, torch.arange(C)
    x, cache = x0.clone(), cache.clone()
    acc = torch.zeros(C, dtype=torch.int32)
    oh = lambda x: (x[..., None] == torch.arange(D)).double()

    def exact(x, site):                                   # (C, D)
        return torch.einsum("cj,cjd->cd", W[site], oh(x)).float()

    def proposal(x, s):                                   # (C, D)
        cnt = sum(d["cnt"][:, s] for d in draws).double()
        return (g.L / lam * torch.einsum("cj,cjd->cd", cnt, oh(x))).float()

    def matches(y, s, u):                                 # (C,) float32
        m = 0
        for d in draws:
            a, b, live = (t[:, s, u] for t in d["ends"])
            m = m + (live & (y.gather(1, a) == y.gather(1, b))).sum(-1)
        return lscale * m.to(torch.float32)

    def put(x, site, v):
        y = x.clone()
        y[rows, site] = v
        return y

    for s in range(S):
        site, accept = i[:, s].long(), None
        xi = x[rows, site]
        if algo == "gibbs":
            new = gibbs_select(exact(x, site), gum[:, s])
        elif algo == "mgpmh":
            E, eps = exact(x, site), proposal(x, s)
            v = gibbs_select(eps, gum[:, s])
            accept = mh_accept(logu[:, s], E[rows, v] - E[rows, xi],
                               eps[rows, xi], eps[rows, v])
            new = torch.where(accept, v, xi)
        elif algo == "min-gibbs":
            eps = torch.stack([matches(put(x, site, u), s, u)
                               for u in range(D)], -1)
            new, cache = min_gibbs_select(eps, cache, xi, gum[:, s], rows)
        else:
            eps = proposal(x, s)
            v = gibbs_select(eps, gum[:, s])
            xi_y = matches(put(x, site, v), s, 0)
            accept = mh_accept(logu[:, s], xi_y - cache, eps[rows, xi],
                               eps[rows, v])
            new = torch.where(accept, v, xi)
            cache = torch.where(accept, xi_y, cache)
        x[rows, site] = new
        if accept is not None:
            acc += accept
    return x, cache, acc


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("algo", W.ENGINES)
def test_recursion_equals_sequential_exact_updates(algo, n_shards):
    """The shards' partials, summed as the all-reduce sums them, then the
    replicated recursion: the same x, cache and accept counts, to the bit,
    as S single-site updates that recompute every energy from the full W
    and the current state, on the same sites, Gumbels, MH uniforms and
    minibatch draws.  Duplicate sites in a sweep included."""
    g = _dyadic_graph()
    C, S, D = 6, 7, g.D
    rng = np.random.default_rng(n_shards)
    x0 = torch.from_numpy(rng.integers(0, D, (C, g.n)).astype(np.int32))
    i = torch.from_numpy(rng.integers(0, g.n, (C, S)).astype(np.int32))
    i[:, 4] = i[:, 1]
    i[:, 6] = i[:, 1]
    cache = torch.from_numpy(rng.normal(0, 2, C).astype(np.float32))
    lam, lam2 = 4.0 * g.L, 24.0           # L / lam = 1/4: exact scaling
    cap, cap2 = 96, 64
    U = {"min-gibbs": D}.get(algo, 1)
    lscale = min_gibbs_lscale(g.psi, lam2)
    kw = (dict(lam2=lam2, capacity2=cap2) if algo == "min-gibbs" else
          dict(lam=lam, capacity=cap, lam2=lam2, capacity2=cap2))
    parts, draws = None, []
    for k in range(n_shards):
        gs = DG.ShardedMatchGraph.from_graph(g, n_shards, k)
        gen = torch.Generator()
        gen.manual_seed(100 + k)
        state = gen.get_state()
        draws.append(_shard_draws(algo, gs, gen, i, U, lam, cap, lam2, cap2))
        gen.set_state(state)
        p = DG._local_partials(gs, algo, x0, i, gen, k, **kw)
        parts = p if parts is None else {n: parts[n] + p[n] for n in parts}
    gen = torch.Generator()
    gen.manual_seed(7)
    gum = DG.gumbel((C, S, D), gen, "cpu")
    logu = torch.rand((C, S), generator=gen).log_()
    got = DG._recursion(algo, parts, x0, i, cache,
                        gum, logu, D, lscale)
    want = _sequential(algo, g, draws, x0, i, cache, gum, logu, lam, lscale)
    for name, a, b in zip(("x", "cache", "accepts"), got, want):
        if algo in ("gibbs", "mgpmh") and name == "cache":
            continue
        assert torch.equal(a, b), (name, a, b)
    assert (got[0] != x0).any()
    if algo in ("mgpmh", "doublemin"):
        assert 0 < int(got[2].sum()) < C * S       # some accepts, not all


# -- engines on spawned gloo ranks --------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One 4-rank (2 x 2) run: the four engines to exact marginals, the
    AdaptiveScan run and the replays."""
    tmp = tmp_path_factory.mktemp("world4")
    marg = W.run_ranks(W.marginals_rank, 4, tmp, (2, 2))
    ada = W.run_ranks(W.adaptive_rank, 4, tmp, (2, 2))
    replay = W.run_ranks(W.replay_rank, 4, tmp, (2, 2))
    return dict(marg=marg, ada=ada, replay=replay)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One 2-rank (1 x 2) run: chromatic against the dense reference, and
    telemetry against the single-device engines."""
    tmp = tmp_path_factory.mktemp("world2")
    return dict(chrom=W.run_ranks(W.chromatic_rank, 2, tmp, (1, 2)),
                tel=W.run_ranks(W.telemetry_rank, 2, tmp, (1, 2)))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The four engines to exact marginals on a world of one rank."""
    return W.run_ranks(W.marginals_rank, 1, tmp_path_factory.mktemp("w1"),
                       (1, 1))[0]


# The marginals of potts 2x2 are 1/D by colour symmetry, whatever the
# sampler does with W; the edge agreements P(x_a == x_b) are 0.375 / 0.347
# there, 1/3 for a sampler that ignores the couplings.  AGREE_TOL fails such
# a sampler (error 0.042) and one that draws the global estimator's factors
# from the wrong side of the alias table (error 0.019-0.026 on 1 rank);
# sampling noise here stays under 0.007.
AGREE_TOL = 0.015


@pytest.mark.parametrize("name", W.ENGINES)
def test_dist_marginals_exact_world_of_one(world1, name):
    r = world1[name]
    assert r["err"] < 0.05, r
    assert r["agree_err"] < AGREE_TOL, r
    assert r["per_call"] == 1.0 and r["chains"] == 64


@pytest.mark.parametrize("name", W.ENGINES)
def test_dist_marginals_exact_2x2(world4, name):
    """2 data x 2 model shards, potts 2x2 D=3, C=64, S=4, 800 calls: every
    rank's gathered marginals within 0.05 of exact and the edge agreements
    within AGREE_TOL, one all-reduce per call, 32 chains per rank."""
    for r in world4["marg"]:
        assert r[name]["err"] < 0.05, r[name]
        assert r[name]["agree_err"] < AGREE_TOL, r[name]
        assert r[name]["per_call"] == 1.0 and r[name]["chains"] == 32
    assert len({r[name]["err"] for r in world4["marg"]}) == 1
    assert len({r[name]["agree_err"] for r in world4["marg"]}) == 1
    if name in ("mgpmh", "doublemin"):
        assert 0.3 < world4["marg"][0][name]["acc"] < 1.0


def test_dist_adaptive_scan_2x2(world4):
    for r in world4["ada"]:
        assert r["err"] < 0.06, r["err"]
        # each pair's agreement against e^w / (e^w + 1): 0.971 strong,
        # 0.562 weak; 0.5 for a sampler that ignores W
        assert r["agree_err"] < 0.04, r["agree_err"]
        assert r["per_call"] == 1.0
        assert abs(r["cdf"][-1] - 1.0) < 1e-4
        assert not np.allclose(r["cdf"], r["cdf0"])      # the table adapted
        p = np.diff(np.concatenate([[0.0], r["cdf"]]))
        # sticky strong-pair sites (the first 4) upweighted vs weak sites
        assert p[:4].mean() > 1.5 * p[4:].mean(), p
        np.testing.assert_array_equal(r["cdf"], world4["ada"][0]["cdf"])
    # both data shards fed the counters (ranks 0, 1: dp 0; 2, 3: dp 1)
    hits = [r["hits"] for r in world4["ada"]]
    assert hits[0] > 0 and hits[2] > 0 and hits[0] == hits[1]


@pytest.mark.parametrize("name", W.ENGINES)
def test_dist_replay_same_bits(world4, name):
    for r in world4["replay"]:
        assert r[f"{name}/UniformSites"] and r[f"{name}/AdaptiveScan"], r


def test_dist_chromatic_bit_equal_to_dense_reference(world2):
    for r in world2["chrom"]:
        assert r["equal"] == [True, True], r
        assert r["per_call"] == 2.0           # one all-reduce per class
        assert r["moved"] > 0


@pytest.mark.parametrize("name", W.ENGINES)
def test_dist_telemetry_matches_single_device(world2, name):
    (acc_t, r_t), (acc_d, r_d) = (world2["tel"][0][name]["torch"],
                                  world2["tel"][0][name]["dist"])
    assert abs(acc_t - acc_d) < 0.05, (acc_t, acc_d)
    assert np.isfinite(r_d).all()
    assert abs(r_t.mean() - r_d.mean()) < 0.2, (r_t.mean(), r_d.mean())
    assert max(r_t.max(), r_d.max()) < 2 * min(r_t.max(), r_d.max())
    # both model shards keep the same carry over the same chains
    np.testing.assert_array_equal(world2["tel"][1][name]["dist"][1], r_d)


# -- refusals --------------------------------------------------------------

class _FakeMesh:
    """Enough of a mesh for ``make`` to reach the refusal (it is refused
    before any process group is read)."""
    device_type = "cpu"


@pytest.mark.parametrize("name,colors", [("mgpmh", True), ("doublemin", True),
                                         ("local-gibbs", False)])
def test_dist_unsupported_message_equals_jax(name, colors):
    g = make_potts_graph(2, 0.8, 3, device="cpu")
    sched, jsched = ((engine.ChromaticBlocks((0, 1, 1, 0)),
                      jengine.ChromaticBlocks((0, 1, 1, 0))) if colors else
                     (engine.UniformSites(4), jengine.UniformSites(4)))
    with pytest.raises(ValueError) as got:
        engine.make(name, g, schedule=sched, mesh=_FakeMesh())
    assert str(got.value) == str(jengine._dist_unsupported(name, jsched))


def test_dist_backends_listed():
    for name in W.ENGINES:
        assert "dist" in engine.backends(name)
    assert "dist" not in engine.backends("local-gibbs")


# -- the supervised runtime over gloo ranks ------------------------------------

@pytest.fixture(scope="module")
def supervised4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sup4")
    return W.run_ranks(W.supervised_rank, 4, tmp, (2, 2), str(tmp))


@pytest.fixture(scope="module")
def supervised2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sup2")
    return W.run_ranks(W.supervised_pair_rank, 2, tmp, str(tmp))


def test_supervised_dist_crash_resume_bit_exact_2x2(supervised4):
    for r in supervised4:
        clean, fault = r["clean"], r["fault"]
        assert fault["restarts"] >= 1 and fault["rollbacks"] >= 1
        assert np.array_equal(clean["marginals"], fault["marginals"])
        assert np.array_equal(clean["x"], fault["x"])
        assert fault["outer_steps"] == clean["outer_steps"] == 6
        health = [i for i in fault["incidents"] if i["kind"] == "health"]
        assert health and health[0]["guard"] == "bad_state"
        # the nan fault is a rollback, the one restart is the preemption
        restarts = [i for i in fault["incidents"] if i["kind"] == "restart"]
        assert len(restarts) == 1 and "Preemption" in restarts[0]["error"]
    assert len({r["fault"]["marginals"].tobytes() for r in supervised4}) == 1


def test_supervised_dist_elastic_2x2_to_1x2(supervised4):
    stay, gone = supervised4[:2], supervised4[2:]
    for r in gone:
        assert r["elastic"]["left"] and r["elastic"]["x"] is None
    for r in stay:
        e = r["elastic"]
        assert not e["left"] and e["outer_steps"] == 100
        assert any(i["kind"] == "elastic" and i["ranks"] == 2
                   for i in e["incidents"])
        assert e["err"] < 0.05, e["err"]
        assert e["agree_err"] < 2 * AGREE_TOL, e["agree_err"]
        assert e["x"].shape == (64, 4)          # all 64 chains on dp = 1


def test_supervised_dist_degrade_after_a_shrink_completes(supervised4):
    """2x2, a loss keeping 2 ranks, then an acceptance-floor degrade on the
    1x2 mesh: the survivors rebuild their engine without the ranks that
    left and finish on gibbs."""
    for r in supervised4[2:]:
        assert r["shrink_degrade"]["left"]
    for r in supervised4[:2]:
        e = r["shrink_degrade"]
        assert not e["left"] and e["outer_steps"] == 6
        assert e["engine"] == "gibbs" and e["x"].shape == (8, 4)
        swaps = [(i["kind"], i["ranks"]) for i in e["incidents"]
                 if i["kind"] in ("elastic", "degrade")]
        assert swaps == [("elastic", 2), ("degrade", 2)], swaps
    assert np.array_equal(supervised4[0]["shrink_degrade"]["marginals"],
                          supervised4[1]["shrink_degrade"]["marginals"])


def test_supervised_dist_two_losses_in_a_row_complete(supervised4):
    """4x1, a loss keeping 2 ranks, then one keeping 1: rank 0 finishes
    alone with every chain, the others leave."""
    for r in supervised4[1:]:
        assert r["two_losses"]["left"]
    e = supervised4[0]["two_losses"]
    assert not e["left"] and e["outer_steps"] == 6
    assert [i["ranks"] for i in e["incidents"]
            if i["kind"] == "elastic"] == [2, 1]
    assert e["x"].shape == (8, 4) and np.isfinite(e["marginals"]).all()


def test_supervised_dist_refuses_a_loss_that_splits_the_model(supervised2):
    for r in supervised2:
        assert "multiple of the 2 model shards" in r["refusal"]


def test_launcher_dist_ckpt_dir_rerun_resumes_bit_exact(supervised2):
    """``--ckpt-dir`` on the dist backend: rank 0 writes the global arrays,
    the rerun resumes on every rank, and 6 + 6 calls log the same marginal
    error as 12 straight; only rank 0 logs."""
    first, second, straight = supervised2[0]["plain"]
    assert "resumed" not in first
    assert "[gibbs] resumed at step 6" in second
    last = lambda log: log.strip().splitlines()[-1].split("marg_err=")[1]
    assert last(second).split()[0] == last(straight).split()[0]
    assert supervised2[1]["plain"] == ["", "", ""]


def test_supervised_dist_launcher_rank_leaves(supervised2):
    lead, gone = supervised2[0]["launcher"], supervised2[1]["launcher"]
    assert gone["left"] and not lead["left"]
    assert lead["outer_steps"] == 4 and lead["engine"] == "gibbs"
    assert any(i["kind"] == "elastic" and i["ranks"] == 1
               for i in lead["incidents"])
    assert lead["x"].shape == (8, 24)
