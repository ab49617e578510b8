"""The port's fused sweeps, engines and runner, on the CPU, against the JAX
package — and, on a machine with a CUDA card, the kernels against their
plain versions.

  * plain-version parity: ``gibbs_sweep_ref`` / ``mgpmh_sweep_ref`` make
    the same decisions as the JAX oracles (``repro.kernels.ref``) when fed
    the same numpy-drawn inputs, at the shapes of ``tests/test_sweep.py``;
  * distributional: the port's engines reach the exact marginals of an
    enumerable Potts graph;
  * chromatic: one chromatic sweep equals a dense block-Gibbs update fed
    the same Gumbels;
  * registry, dispatch and launcher behaviour;
  * (gpu) the CUDA kernels equal their plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores (these small
# tensors gain nothing from more)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import make_potts_graph as j_make_potts_graph  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import chains, engine, samplers  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.kernels import _build, fused_sweep, ops  # noqa: E402
from repro_torch.kernels import parity_inputs as pin  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import gibbs as launcher  # noqa: E402

from _helpers import exact_marginals  # noqa: E402

MGPMH_SHAPES = [          # (C, S, K, D, n), as tests/test_sweep.py:53-59
    (4, 5, 17, 3, 11),
    (8, 8, 128, 10, 40),
    (3, 1, 1, 2, 5),
    (5, 12, 33, 6, 20),
    (2, 3, 9, 129, 7),
]
# the MGPMH kernel's edges (C, S, K, D, n), with x outside [0, D) at sites
# no sub-step updates and Poisson totals at 0 and at K
# (``parity_inputs.mgpmh_edge_inputs``): an odd n, D above the register
# width, K above the block (several rounds of draws per sub-step), and an
# odd n whose rows stream through the ring in chunks, at D = 10 and D = 33
MGPMH_EDGE_SHAPES = [(3, 6, 17, 10, 1001), (2, 3, 9, 33, 7),
                     (3, 4, 600, 5, 301), (2, 3, 17, 10, 23301),
                     (2, 2, 9, 33, 23301)]
GIBBS_SHAPES = [(4, 5, 3, 11), (8, 8, 10, 40), (3, 1, 2, 5)]   # (C, S, D, n)
# the Gibbs kernel's ring (C, S, D, n): D above the register width, a ragged
# n (not a multiple of the block, the chunk or 4: rows start anywhere), a
# second S = 1, and an odd n long enough for the chunked ring (its last row
# ends past W's last aligned word), with D = 10 and D = 129
GIBBS_RING_SHAPES = [(2, 3, 129, 7), (3, 6, 10, 1001), (4, 1, 10, 40),
                     (2, 3, 10, 23301), (2, 2, 129, 23301)]
CHUNKED_N = 20000       # above it, a row does not fit twice beside the state


def _torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


# ---------------------------------------------------------------------------
# plain versions vs the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S,K,D,n", MGPMH_SHAPES)
def test_mgpmh_sweep_ref_equals_jax_oracle(C, S, K, D, n):
    arrays = pin.mgpmh_inputs(C, S, K, D, n)
    xj, aj = jref.mgpmh_sweep_ref(*map(jnp.asarray, arrays), D, 0.7)
    xt, at = tref.mgpmh_sweep_ref(*_torch(arrays), D, 0.7)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert xt.dtype == torch.int32 and at.dtype == torch.int32


@pytest.mark.parametrize("C,S,D,n", GIBBS_SHAPES)
def test_gibbs_sweep_ref_equals_jax_oracle(C, S, D, n):
    x, W, i, g = pin.gibbs_inputs(C, S, D, n)
    xj = jref.gibbs_sweep_ref(jnp.asarray(x), jnp.asarray(W), jnp.asarray(i),
                              jnp.asarray(g), D)
    x_t = torch.from_numpy(x)
    xt = tref.gibbs_sweep_ref(x_t, torch.from_numpy(W), torch.from_numpy(i),
                              torch.from_numpy(g), D)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(x_t.numpy(), x)      # input untouched


def test_bucket_energy_ref_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.uniform(size=(6, 40)).astype(np.float32)
    v = rng.integers(0, 7, (6, 40)).astype(np.int32)   # 5, 6 land nowhere
    ej = np.asarray(jref.bucket_energy_ref(jnp.asarray(w), jnp.asarray(v), 5))
    et = tref.bucket_energy_ref(torch.from_numpy(w), torch.from_numpy(v), 5)
    np.testing.assert_allclose(et.numpy(), ej, rtol=1e-6)


def test_select_and_accept_primitives_equal_jax():
    from repro.core import samplers as jsamplers
    rng = np.random.default_rng(5)
    eps = rng.normal(size=(9, 4)).astype(np.float32)
    eps[0] = eps[0, 0]                                  # ties: first max wins
    g = np.zeros((9, 4), np.float32)
    g[1:] = rng.gumbel(size=(8, 4))
    vj = jsamplers.gibbs_select(jnp.asarray(eps), jnp.asarray(g))
    vt = samplers.gibbs_select(torch.from_numpy(eps), torch.from_numpy(g))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt[0]) == 0 and vt.dtype == torch.int32
    a = [rng.normal(size=50).astype(np.float32) for _ in range(4)]
    aj = jsamplers.mh_accept(*(jnp.asarray(v) for v in a))
    at = samplers.mh_accept(*(torch.from_numpy(v) for v in a))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


# ---------------------------------------------------------------------------
# dispatch by device and the CUDA wrappers' checks
# ---------------------------------------------------------------------------

def test_ops_send_cpu_tensors_to_the_plain_versions():
    args = _torch(pin.mgpmh_inputs(4, 5, 17, 3, 11))
    x0, a0 = ops.mgpmh_sweep(*pin.packed_mgpmh_args(args), D=3, scale=0.7)
    x1, a1 = tref.mgpmh_sweep_ref(*args, 3, 0.7)
    assert torch.equal(x0, x1) and torch.equal(a0, a1)
    x, W, i, g = _torch(pin.gibbs_inputs(4, 5, 3, 11))
    assert torch.equal(ops.gibbs_sweep(x, W, i, g, D=3),
                       tref.gibbs_sweep_ref(x, W, i, g, 3))


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_inputs():
    fused_sweep.reset_launch_counts()
    x, W, i, g = _torch(pin.gibbs_inputs(4, 5, 3, 11))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.gibbs_sweep_cuda(x, W, i, g, D=3)
    with pytest.raises(ValueError, match="gumbel must have shape"):
        fused_sweep.gibbs_sweep_cuda(x, W, i, g[:, :, :2], D=3)
    with pytest.raises(ValueError, match="x must be torch.int32"):
        fused_sweep.gibbs_sweep_cuda(x.long(), W, i, g, D=3)
    with pytest.raises(ValueError, match="i_sites must be contiguous"):
        it = i.t().contiguous().t()
        fused_sweep.gibbs_sweep_cuda(x, W, it, g, D=3)
    args = pin.packed_mgpmh_args(_torch(pin.mgpmh_inputs(4, 5, 17, 3, 11)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_sweep.mgpmh_sweep_cuda(*args, D=3, scale=0.7)
    with pytest.raises(ValueError, match="B must be torch.int32"):
        bad = list(args)
        bad[4] = bad[4].long()
        fused_sweep.mgpmh_sweep_cuda(*bad, D=3, scale=0.7)
    assert fused_sweep.gibbs_sweep_cuda.launches == 0
    assert fused_sweep.mgpmh_sweep_cuda.launches == 0


def test_kernel_build_command_targets_sm_90a():
    sources = _build._sources()
    assert [p.name for p in sources] == ["bucket_energy.cu",
                                         "chromatic_sweep.cu",
                                         "flash_attention.cu",
                                         "flash_attention_bwd.cu",
                                         "fused_sweep.cu", "local_sweep.cu",
                                         "selective_scan.cu",
                                         "telemetry_update.cu"]
    for src in sources:                  # one nvcc process per source
        cmd = _build.nvcc_command("nvcc", src, _build.BUILD_DIR / "k.o")
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
        assert "-fmad=false" in cmd and "-c" in cmd and cmd[-1] == str(src)
    link = _build.link_command("nvcc", ["a.o", "b.o"],
                               _build.BUILD_DIR / "lib.so")
    assert link[:4] == ["nvcc", "-shared", "-gencode",
                        "arch=compute_90a,code=sm_90a"]
    assert link[-2:] == ["a.o", "b.o"]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


# ---------------------------------------------------------------------------
# engines: distributional agreement with exact marginals
# ---------------------------------------------------------------------------

def _empirical_marginals(eng, n_calls, n_chains, seed=0):
    st = eng.init(seed, n_chains, start="random")
    tr = chains.run_marginal_experiment(eng, st, n_iters=n_calls *
                                        eng.updates_per_call, n_snapshots=1)
    return (tr.marg.sum(0) / (n_calls * n_chains)).cpu().numpy(), tr


def test_gibbs_engine_marginals():
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    eng = engine.make("gibbs", g, sweep=8, device="cpu")
    assert eng.backend == "torch" and eng.exact_accept
    emp, _ = _empirical_marginals(eng, 1000, 256)
    ref = exact_marginals(j_make_potts_graph(grid=2, beta=0.8, D=3))
    assert np.abs(emp - ref).max() < 0.03


def test_mgpmh_engine_marginals():
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    lam = float(4 * g.L ** 2)
    cap = int(lam + 6 * lam ** 0.5 + 16)
    eng = engine.make("mgpmh", g, sweep=8, device="cpu", lam=lam,
                      capacity=cap)
    emp, tr = _empirical_marginals(eng, 1000, 256)
    ref = exact_marginals(j_make_potts_graph(grid=2, beta=0.8, D=3))
    assert np.abs(emp - ref).max() < 0.03
    acc = tr.final.accepts.sum().item() / (256 * 1000 * 8)
    assert 0.0 < acc <= 1.0


def test_chromatic_sweep_equals_dense_block_update():
    """One chromatic sweep = per color class, argmax(W x_onehot + g) at the
    class sites, all read from the state the class started from."""
    g = tfg.make_lattice_ising(4, device="cpu")
    colors = tfg.lattice_colors(4)
    eng = engine.make("gibbs", g, schedule=engine.ChromaticBlocks(colors),
                      device="cpu")
    assert eng.updates_per_call == g.n
    st = eng.init(3, 6, start="random")
    x = st.x.clone()
    gen = torch.Generator().manual_seed(0)
    gen.set_state(st.gen.get_state())
    st = eng.sweep(eng.sweep(st))
    for _ in range(2):
        for c in range(2):
            sites = torch.from_numpy(np.flatnonzero(colors == c))
            noise = samplers.gumbel((6, sites.numel(), 2), gen, "cpu")
            onehot = (x[..., None] == torch.arange(2)).float()     # (C, n, D)
            eps = torch.einsum("ij,cjd->cid", g.W, onehot)[:, sites]
            x[:, sites] = torch.argmax(eps + noise, -1).to(torch.int32)
    assert torch.equal(st.x, x)


def test_chromatic_engine_marginals():
    g = tfg.make_pair_ising(1, 1, device="cpu")
    eng = engine.make("gibbs", g,
                      schedule=engine.ChromaticBlocks(tfg.pair_colors(2)),
                      device="cpu")
    emp, _ = _empirical_marginals(eng, 400, 256)
    np.testing.assert_allclose(emp, 0.5, atol=0.03)   # exactly uniform


def test_run_marginal_experiment_trace_and_tv():
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device="cpu")
    eng = engine.make("gibbs", g, sweep=4, device="cpu")
    st = eng.init(0, 8)
    tr = chains.run_marginal_experiment(eng, st, n_iters=4 * 40,
                                        n_snapshots=4)
    assert tr.iters.tolist() == [40, 80, 120, 160]
    assert tr.error.shape == (4,) and tr.marg.shape == (8, 4, 3)
    assert float(tr.marg.sum()) == 8 * 4 * 40
    ref = exact_marginals(j_make_potts_graph(grid=2, beta=0.8, D=3))
    tv = chains.run_marginal_experiment(eng, tr.final, n_iters=4 * 40,
                                        n_snapshots=2, ref_marginals=ref,
                                        site_reduce="max")
    assert tv.error.shape == (2,) and float(tv.error.max()) <= 1.0
    with pytest.raises(ValueError, match="at least one sweep"):
        chains.run_marginal_experiment(eng, st, n_iters=3, n_snapshots=1)
    with pytest.raises(TypeError, match="requires an Engine"):
        chains.run_marginal_experiment(eng.sweep_fn, st, n_iters=4,
                                       n_snapshots=1)


# ---------------------------------------------------------------------------
# registry and launcher
# ---------------------------------------------------------------------------

def test_registry_round_trip_and_errors():
    g = tfg.make_potts_graph(grid=3, beta=1.0, D=3, device="cpu")
    assert engine.names() == ("doublemin", "gibbs", "local-gibbs", "mgpmh",
                              "min-gibbs")
    for name in engine.names():
        # the dist backend serves every engine but local-gibbs
        assert engine.backends(name) == (
            ("torch", "cuda") if name == "local-gibbs"
            else ("torch", "cuda", "dist"))
        eng = engine.make(name, g, sweep=5, device="cpu")
        d = eng.describe()
        assert d == {"engine": name, "backend": "torch", "device": "cpu",
                     "schedule": "uniform-sites(S=5)", "updates_per_call": 5}
        st = eng.sweep(eng.init(0, 3))
        assert st.x.shape == (3, g.n) and st.x.dtype == torch.int32
    eng = engine.make("mgpmh", g, device="cpu")
    assert eng.params["lam"] == pytest.approx(4 * g.L ** 2)
    assert eng.updates_per_call == 1
    # every engine of the JAX package is ported: none is refused by name
    from repro.core import engine as jengine
    assert set(engine.names()) == set(jengine.names())
    with pytest.raises(KeyError, match="unknown engine"):
        engine.make("nope", g, device="cpu")
    with pytest.raises(ValueError, match="either sweep= or schedule="):
        engine.make("gibbs", g, sweep=2, schedule=engine.UniformSites(2),
                    device="cpu")
    colors = engine.ChromaticBlocks(np.arange(g.n) % 2)
    with pytest.raises(ValueError, match="only the UniformSites"):
        engine.make("mgpmh", g, schedule=colors, device="cpu")
    with pytest.raises(ValueError, match="not a proper coloring"):
        engine.make("gibbs", g, schedule=colors, device="cpu")
    with pytest.raises(TypeError, match="unknown params"):
        engine.make("gibbs", g, lam=3.0, device="cpu")
    with pytest.raises(ValueError, match="sweep_len"):
        engine.UniformSites(0)


def test_workloads_mirror_the_jax_registry():
    from repro.core import engine as jengine
    assert engine.WORKLOADS == jengine.WORKLOADS
    assert engine.workload_names() == jengine.workload_names()
    wl = engine.make_workload("hetero-pairs-24", device="cpu")
    assert wl.graph.n == 24 and wl.colors.shape == (24,)
    with pytest.raises(KeyError, match="unknown workload"):
        engine.make_workload("nope", device="cpu")


def test_launcher_prints_the_gibbs_line(capsys):
    st = launcher.run("potts-20x20", "mgpmh", 6, 4, log_every=3, sweep=4,
                      device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and out[-1].startswith("[gibbs] step       6 ")
    assert "marg_err=" in out[-1] and "k updates/s" in out[-1]
    assert st.x.shape == (4, 400)
    launcher.main(["--config", "hetero-pairs-24", "--engine", "gibbs",
                   "--chromatic", "--steps", "2", "--chains", "3",
                   "--device", "cpu"])
    assert "acc=1.000" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card: kernels vs their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _mgpmh_args(shape, dev):
    """The plain version's inputs at a test shape or an edge shape."""
    if shape in MGPMH_EDGE_SHAPES:
        return pin.mgpmh_edge_inputs(*shape, dev)
    return _torch(pin.mgpmh_inputs(*shape), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,K,D,n", MGPMH_SHAPES + MGPMH_EDGE_SHAPES)
def test_mgpmh_kernel_equals_plain_version(cuda, C, S, K, D, n):
    """The kernel, reading the packed row records, equals the plain version
    (the two tables) bit for bit, twice; at n = 23301 the ring streams each
    row in chunks."""
    args = _mgpmh_args((C, S, K, D, n), cuda)
    plan = fused_sweep.mgpmh_ring_plan(n, D)
    assert (plan["chunks"] > 1) == (n >= CHUNKED_N)
    kargs = pin.packed_mgpmh_args(args)
    before = fused_sweep.mgpmh_sweep_cuda.launches
    outs = [fused_sweep.mgpmh_sweep_cuda(*kargs, D=D, scale=0.7)
            for _ in range(2)]
    xr, ar = tref.mgpmh_sweep_ref(*args, D, 0.7)
    torch.cuda.synchronize()
    assert fused_sweep.mgpmh_sweep_cuda.launches == before + 2
    for xk, ak in outs:
        assert torch.equal(xk, xr) and torch.equal(ak, ar)


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,D,n", GIBBS_SHAPES)
def test_gibbs_kernel_equals_plain_version(cuda, C, S, D, n):
    x, W, i, g = _torch(pin.gibbs_inputs(C, S, D, n), cuda)
    xk = fused_sweep.gibbs_sweep_cuda(x, W, i, g, D=D)
    torch.cuda.synchronize()
    assert torch.equal(xk, tref.gibbs_sweep_ref(x, W, i, g, D))


def _ring_inputs(C, S, D, n, dev):
    """(x, W, i_sites, gumbel) on the card, x with values outside [0, D)
    in chain 0.  The chunked-ring sizes draw W (2.2 GB) on the card."""
    if n < CHUNKED_N:
        x, W, i, g = _torch(pin.gibbs_inputs(C, S, D, n), dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(n + D)
        W = torch.rand((n, n), generator=gen, device=dev)
        x = torch.randint(0, D, (C, n), generator=gen, device=dev,
                          dtype=torch.int32)
        i = torch.randint(0, n, (C, S), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand((C, S, D), generator=gen, device=dev)
        g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    x[0, :3] = torch.tensor([-1, D, D + 5], dtype=torch.int32)
    return x, W, i, g


@pytest.mark.gpu
@pytest.mark.parametrize("C,S,D,n", GIBBS_RING_SHAPES)
def test_gibbs_ring_kernel_equals_plain_version(cuda, C, S, D, n):
    plan = fused_sweep.gibbs_ring_plan(n, D)
    assert (plan["chunks"] > 1) == (n >= CHUNKED_N)
    assert plan["smem"] <= fused_sweep._MAX_SMEM
    x, W, i, g = _ring_inputs(C, S, D, n, cuda)
    before = fused_sweep.gibbs_sweep_cuda.launches
    outs = [fused_sweep.gibbs_sweep_cuda(x, W, i, g, D=D) for _ in range(2)]
    want = tref.gibbs_sweep_ref(x, W, i, g, D)
    torch.cuda.synchronize()
    assert fused_sweep.gibbs_sweep_cuda.launches == before + 2
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want)


@pytest.mark.gpu
def test_engines_on_the_card_reach_exact_marginals(cuda):
    g = tfg.make_potts_graph(grid=2, beta=0.8, D=3, device=cuda)
    ref = exact_marginals(j_make_potts_graph(grid=2, beta=0.8, D=3))
    for name in ("gibbs", "mgpmh"):
        eng = engine.make(name, g, sweep=8)
        assert eng.backend == "cuda"
        emp, _ = _empirical_marginals(eng, 1000, 256)
        assert np.abs(emp - ref).max() < 0.03
