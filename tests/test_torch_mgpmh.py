"""The port's MGPMH path after its tables went packed and its draws were
trimmed, on the CPU: the plain versions fed views of the packed row table
against the JAX package, and the draws, the single-site proposal and the
engine's chains against the parent's code, rebuilt here from the same
generator calls and the separate row tables.

The CUDA kernels' tests are the gpu tests of ``tests/test_torch_sweep.py``
and ``tests/test_torch_minibatch.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import engine, estimators, samplers  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.kernels import fused_sweep, ops  # noqa: E402
from repro_torch.kernels import parity_inputs as pin  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

MGPMH_SHAPES = [          # (C, S, K, D, n), as tests/test_sweep.py:53-59
    (4, 5, 17, 3, 11),
    (8, 8, 128, 10, 40),
    (3, 1, 1, 2, 5),
    (5, 12, 33, 6, 20),
    (2, 3, 9, 129, 7),
]
# the kernels' edge shapes that fit a CPU run (tests/test_torch_sweep.py):
# x outside [0, D) at sites never updated, totals at 0 and K, K > 256
EDGE_SHAPES = [(3, 6, 17, 10, 1001), (2, 3, 9, 33, 7), (3, 4, 600, 5, 301)]
TINY = torch.finfo(torch.float32).tiny


def _graph(name):
    return engine.make_workload(name, device="cpu").graph


def _separate_tables(graph):
    """The row tables as the parent kept them: two (n, n) tensors built
    from the host weights, independent of the packed records."""
    rp, ra = tfg.build_alias_tables(graph._weights64)
    return torch.from_numpy(rp), torch.from_numpy(ra)


def _parent_mgpmh_draws(gen, graph, C, S, lam, K):
    """The parent's ``samplers.mgpmh_draws``, verbatim."""
    dev = graph.device
    i = torch.randint(0, graph.n, (C, S), generator=gen, device=dev,
                      dtype=torch.int32)
    lam_i = (lam / graph.L) * graph.row_sum[i.long()]
    B = torch.poisson(lam_i, generator=gen).clamp_(max=K).to(torch.int32)
    u_idx = torch.rand((C, S, K), generator=gen, device=dev)
    u_alias = torch.rand((C, S, K), generator=gen, device=dev)
    u = torch.rand((C, S, graph.D), generator=gen, device=dev).clamp_min_(TINY)
    g = -torch.log(-torch.log(u))
    logu = torch.log(torch.rand((C, S), generator=gen, device=dev))
    return i, B, u_idx, u_alias, g, logu


def _parent_local_minibatch(rp, ra):
    """The parent's ``estimators.draw_local_minibatch`` over the separate
    row tables ``rp``, ``ra``."""
    def draw(gen, graph, i, lam, capacity):
        i = torch.as_tensor(i, device=graph.device).long()
        lam_i = (lam / graph.L) * graph.row_sum[i]
        B = torch.poisson(lam_i.reshape(-1), generator=gen).reshape(i.shape)
        shape = tuple(i.shape) + (capacity,)
        idx = torch.randint(0, graph.n, shape, generator=gen,
                            device=graph.device)
        u = torch.rand(shape, generator=gen, device=graph.device)
        rows = i[..., None]
        j = torch.where(u >= rp[rows, idx], ra[rows, idx].long(), idx)
        return j.to(torch.int32), B.clamp(max=capacity).to(torch.int32)
    return draw


# ---------------------------------------------------------------------------
# the plain versions on views of the packed table, against the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S,K,D,n", MGPMH_SHAPES)
def test_mgpmh_ref_on_packed_views_equals_jax_oracle(C, S, K, D, n):
    """``ops.mgpmh_sweep`` on CPU tensors takes the packed row table, as the
    kernel does, and runs the plain version on the two tables as views of
    its records: exactly the JAX oracle's decisions."""
    arrays = pin.mgpmh_inputs(C, S, K, D, n)
    xj, aj = jref.mgpmh_sweep_ref(*map(jnp.asarray, arrays), D, 0.7)
    args = pin.packed_mgpmh_args(tuple(map(torch.from_numpy, arrays)))
    assert args[2].shape == (n, n, 2) and args[2].dtype == torch.int32
    xt, at = ops.mgpmh_sweep(*args, D=D, scale=0.7)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("C,S,K,D,n", EDGE_SHAPES)
def test_mgpmh_ref_at_edge_inputs_equals_jax_oracle(C, S, K, D, n):
    """The kernels' edge inputs (``parity_inputs.mgpmh_edge_inputs``): x
    outside [0, D) at sites no sub-step updates, totals at 0 and at K,
    K = 600 draws: the plain version on the packed views equals the JAX
    oracle, and the out-of-range values come back unchanged."""
    args = pin.mgpmh_edge_inputs(C, S, K, D, n, "cpu")
    x = args[0]
    assert int(args[5][0, 0]) == 0 and int(args[5][1, 0]) == K
    assert int(args[4].min()) >= 3
    xj, aj = jref.mgpmh_sweep_ref(*(jnp.asarray(a.numpy()) for a in args),
                                  D, 0.7)
    xt, at = ops.mgpmh_sweep(*pin.packed_mgpmh_args(args), D=D, scale=0.7)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert torch.equal(xt[:, :3], x[:, :3])
    assert 0 < int(at.sum()) and bool((xt[:, 3:] != x[:, 3:]).any())


# ---------------------------------------------------------------------------
# the graph keeps one row table; the draws read it as the parent did
# ---------------------------------------------------------------------------

def test_match_graph_keeps_only_the_packed_row_table():
    """Reading ``row_prob`` / ``row_alias`` builds the packed table only,
    and they are views of its records (no second 8n^2 bytes), with the
    Vose tables' exact bits; ``graph_from_numpy`` keeps its row tables
    packed too."""
    g = _graph("potts-20x20")
    rp, ra = g.row_prob, g.row_alias
    assert sorted(g._tables) == ["row_pack"]
    pack = g.row_pack
    assert rp.data_ptr() == pack.data_ptr()
    assert ra.data_ptr() == pack.data_ptr() + 4
    want_p, want_a = _separate_tables(g)
    assert torch.equal(rp, want_p) and torch.equal(ra, want_a)
    assert rp.dtype == torch.float32 and ra.dtype == torch.int32
    arrays = {"W": g.W.numpy(), "row_sum": g.row_sum.numpy(),
              "row_prob": want_p.numpy(), "row_alias": want_a.numpy(),
              **{k: getattr(g, k).numpy() for k in
                 ("pair_a", "pair_b", "pair_prob", "pair_alias")}}
    h = tfg.graph_from_numpy(arrays, D=g.D, psi=g.psi, L=g.L,
                             delta=g.delta, device="cpu")
    assert "row_prob" not in h._tables and "row_alias" not in h._tables
    assert torch.equal(h.row_pack, pack)


@pytest.mark.parametrize("name", ["potts-20x20", "ising-20x20"])
def test_draw_local_minibatch_reads_row_pack_as_the_parent_did(name):
    """The local minibatch over A[i], read from the packed records, draws
    the parent's neighbours and totals from the same generator calls."""
    g = _graph(name)
    parent = _parent_local_minibatch(*_separate_tables(g))
    lam = float(4 * g.L ** 2)
    i = torch.randint(0, g.n, (64,), generator=torch.Generator()
                      .manual_seed(3))
    for seed in (0, 1):
        got = estimators.draw_local_minibatch(
            torch.Generator().manual_seed(seed), g, i, lam, 57)
        want = parent(torch.Generator().manual_seed(seed), g, i, lam, 57)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = estimators.draw_local_minibatch(torch.Generator().manual_seed(2),
                                          g, 5, lam, 9)
    want = parent(torch.Generator().manual_seed(2), g, 5, lam, 9)
    assert got[0].shape == (9,) and all(
        torch.equal(a, b) for a, b in zip(got, want))


def test_make_mgpmh_step_equals_parent_at_fixed_seed(monkeypatch):
    """Ten single-site MGPMH steps reading the packed table end where the
    parent's steps (the separate tables) end, accepts included."""
    g = _graph("potts-20x20")
    lam = float(4 * g.L ** 2)
    K = estimators.recommended_capacity(lam)

    def run():
        step = samplers.make_mgpmh_step(g, lam, K)
        st = samplers.init_state(torch.Generator().manual_seed(5), g, 16,
                                 start="random")
        for _ in range(10):
            st = step(st)
        return st

    got = run()
    monkeypatch.setattr(samplers, "draw_local_minibatch",
                        _parent_local_minibatch(*_separate_tables(g)))
    want = run()
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.accepts, want.accepts)
    assert int(got.accepts.sum()) > 0


# ---------------------------------------------------------------------------
# the trimmed host path draws the parent's numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["potts-20x20", "ising-20x20"])
@pytest.mark.parametrize("C,S", [(7, 5), (32, 16)])
def test_mgpmh_draws_equal_the_parent_sequence(name, C, S):
    """``mgpmh_draws`` after the trims (the per-site rate made once, an
    int32 site index, in-place Gumbels and log) returns the parent's six
    tensors bit for bit over two calls, and leaves the generator where
    the parent did."""
    g = _graph(name)
    lam = float(4 * g.L ** 2)
    K = estimators.recommended_capacity(lam)
    rate = samplers.mgpmh_rate(g, lam)
    gen_a, gen_b = (torch.Generator().manual_seed(11) for _ in range(2))
    for _ in range(2):
        got = samplers.mgpmh_draws(gen_a, g, C, S, rate, K)
        want = _parent_mgpmh_draws(gen_b, g, C, S, lam, K)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=gen_a),
                       torch.rand(4, generator=gen_b))


def test_gumbel_in_place_equals_the_parent_expression():
    """The in-place Gumbel is the parent's ``-log(-log u)`` bit for bit,
    the clamped zero included."""
    for shape in ((5,), (64, 3, 10)):
        got = samplers.gumbel(shape, torch.Generator().manual_seed(4), "cpu")
        u = torch.rand(shape, generator=torch.Generator().manual_seed(4))
        assert torch.equal(got, -torch.log(-torch.log(u.clamp_min(TINY))))
    u = torch.tensor([0.0, TINY, 0.5])
    assert torch.equal(u.clone().clamp_min_(TINY).log_().neg_().log_().neg_(),
                       -torch.log(-torch.log(u.clamp_min(TINY))))


def test_mgpmh_engine_sweep_equals_parent_at_fixed_seed():
    """Three engine sweep calls (the packed table, the trimmed draws) end in
    the parent's chains and accepts: the parent's draws and its plain
    version on the separate tables, from the same seed."""
    g = _graph("potts-20x20")
    eng = engine.make("mgpmh", g, sweep=12, device="cpu")
    lam, K = eng.params["lam"], eng.params["capacity"]
    rp, ra = _separate_tables(g)
    st = eng.init(9, 8, start="random")
    ref = eng.init(9, 8, start="random")
    x, acc = ref.x, ref.accepts
    for _ in range(3):
        st = eng.sweep(st)
        draws = _parent_mgpmh_draws(ref.gen, g, 8, 12, lam, K)
        x, a = tref.mgpmh_sweep_ref(x, g.W, rp, ra, *draws, g.D,
                                    float(g.L / lam))
        acc = acc + a
    assert torch.equal(st.x, x) and torch.equal(st.accepts, acc)
    assert int(acc.sum()) > 0.5 * 3 * 8 * 12     # most proposals taken


# ---------------------------------------------------------------------------
# the wrappers' new signature
# ---------------------------------------------------------------------------

def test_mgpmh_wrappers_refuse_separate_tables_and_bad_inputs():
    """Both wrappers take one packed row table: the separate tables, a
    float32 or wrongly shaped pack and CPU tensors are refused by name;
    nothing launches."""
    fused_sweep.reset_launch_counts()
    plain = tuple(map(torch.from_numpy, pin.mgpmh_inputs(4, 5, 17, 3, 11)))
    args = pin.packed_mgpmh_args(plain)
    with pytest.raises(TypeError):
        fused_sweep.mgpmh_sweep_cuda(*plain, D=3, scale=0.7)
    for bad_pack, msg in ((plain[2], r"row_pack must be torch.int32"),
                          (args[2].float(), "row_pack must be torch.int32"),
                          (args[2][..., :1].contiguous(),
                           r"row_pack must have shape \(11, 11, 2\)")):
        bad = list(args)
        bad[2] = bad_pack
        with pytest.raises(ValueError, match=msg):
            fused_sweep.mgpmh_sweep_cuda(*bad, D=3, scale=0.7)
        with pytest.raises(ValueError, match=msg):
            fused_sweep.mgpmh_sweep_rng_cuda(
                *bad[:5], torch.zeros(1, dtype=torch.int32), D=3, scale=0.7,
                K=17)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.mgpmh_sweep_cuda(*args, D=3, scale=0.7)
    with pytest.raises(ValueError, match="x must be torch.int32"):
        fused_sweep.mgpmh_sweep_cuda(args[0].long(), *args[1:], D=3,
                                     scale=0.7)
    with pytest.raises(ValueError, match="W must have shape"):
        fused_sweep.mgpmh_sweep_cuda(args[0][:, :5].contiguous(), *args[1:],
                                     D=3, scale=0.7)
    assert fused_sweep.mgpmh_sweep_cuda.launches == 0
    assert fused_sweep.mgpmh_sweep_rng_cuda.launches == 0
