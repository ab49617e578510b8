"""The port's fused Local Minibatch Gibbs sweep (``ops.local_gibbs_sweep``):
one launch per sweep call on the card, its subsets drawn by Floyd's
algorithm and its Gumbels by Philox under a seed.

  * Floyd's subsets (``ref.local_gibbs_subsets``): B distinct sites, none
    the sub-step's site, uniform over the B-subsets (chi-square), every
    other site at B = n - 1;
  * the plain sweep against the JAX package: on the sweep's own subsets and
    Gumbels, sub-step by sub-step, the JAX ``bucket_energy_ref`` and the
    Pallas bucket-energy kernel (interpret mode) followed by the same
    Gumbel-argmax give the same x;
  * at B = n - 1 the sweep is vanilla Gibbs (``gibbs_sweep_ref`` on the
    same Gumbels);
  * the engine draws sites then a seed from its generator, and the wrapper
    refuses what the kernel does not take;
  * (gpu) the kernel equals its plain version at the parity shapes, seeds
    0, 1 and 2^31 - 1, and a repeated launch gives the same bits whatever
    its consumer recomputed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.core import engine, samplers  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.kernels import local_sweep, ops, philox  # noqa: E402
from repro_torch.kernels import parity_inputs as pin  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

try:    # the JAX reference; a machine with the card may have no JAX, and
    # runs only the gpu tests below, which do not read it
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

SEEDS = (0, 1, 2 ** 31 - 1)
# (C, S, B, D, n): B = 1, B = n - 1, ragged n, several 32-lane rounds, more
# than one group of four rounds (B > 128), D > 32; a sweep in which nearly
# every sub-step the producers finish ahead reads a value that changes
# before the consumer's turn (n = 16, B = 12, D = 2), and a long sweep in
# which few do
PARITY = [(4, 5, 3, 3, 11), (8, 8, 10, 10, 40), (3, 1, 1, 2, 5),
          (5, 12, 19, 6, 20), (2, 3, 100, 4, 129), (3, 4, 130, 5, 200),
          (2, 2, 199, 3, 200), (2, 3, 40, 37, 90), (4, 64, 12, 2, 16),
          (2, 160, 32, 10, 1000)]
STALE = PARITY[-2]


def _seed(k, device="cpu"):
    return torch.tensor([k], dtype=torch.int32, device=device)


def _inputs(C, S, D, n, weights="real", device="cpu"):
    return tuple(torch.from_numpy(a).to(device)
                 for a in pin.local_gibbs_inputs(C, S, D, n, weights))


# ---------------------------------------------------------------------------
# Floyd's subsets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S,B,n", [(40, 6, 3, 11), (8, 4, 37, 60),
                                     (5, 3, 130, 200), (6, 5, 1, 2)])
def test_subsets_are_distinct_and_skip_the_site(C, S, B, n):
    i = torch.from_numpy(np.random.default_rng(n).integers(
        0, n, (C, S)).astype(np.int32))
    j = tref.local_gibbs_subsets(_seed(5), i, B, n)
    assert j.shape == (C, S, B) and j.dtype == torch.int64
    assert bool(((j >= 0) & (j < n)).all())
    assert not bool((j == i.long()[..., None]).any())
    srt = j.sort(dim=-1).values
    assert bool((srt[..., 1:] != srt[..., :-1]).all())


def test_subsets_are_uniform_over_the_ten_pairs():
    """n = 6, B = 2: the 20k subsets of the 5 other sites, relabelled to
    {0..4}, fall on the C(5, 2) = 10 pairs as a uniform draw does
    (chi-square, 9 degrees of freedom, 0.999 quantile 27.88)."""
    C, S, n = 2000, 10, 6
    i = torch.from_numpy(np.random.default_rng(0).integers(
        0, n, (C, S)).astype(np.int32))
    j = tref.local_gibbs_subsets(_seed(123), i, 2, n)
    k = j - (j > i.long()[..., None]).long()           # back to {0..4}
    lo, hi = k.min(-1).values, k.max(-1).values
    counts = torch.bincount((lo * 5 + hi).flatten(), minlength=25)
    counts = counts[counts > 0].double()
    assert counts.numel() == 10
    expect = C * S / 10
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 27.88, chi2


def test_fullbatch_subset_is_every_other_site():
    C, S, n = 4, 7, 13
    i = torch.from_numpy(np.random.default_rng(1).integers(
        0, n, (C, S)).astype(np.int32))
    j = tref.local_gibbs_subsets(_seed(9), i, n - 1, n)
    for c in range(C):
        for s in range(S):
            assert sorted(j[c, s].tolist()) == sorted(
                set(range(n)) - {int(i[c, s])})


# ---------------------------------------------------------------------------
# the plain sweep against the JAX package
# ---------------------------------------------------------------------------

def _jax_sweep(x, W, i_sites, j, g, D, scale, energy):
    """The JAX local step's arithmetic (``src/repro/core/samplers.py:161``:
    ``scale * bucket_energy``, then the Gumbel-max form of the categorical
    draw) on given subsets j (C, S, B) and Gumbels g (C, S, D), sub-step by
    sub-step."""
    x = np.array(x)
    rows = np.arange(x.shape[0])
    for s in range(i_sites.shape[1]):
        i = i_sites[:, s]
        w = W[i[:, None], j[:, s]]
        v = x[rows[:, None], j[:, s]]
        eps = scale * energy(jnp.asarray(w), jnp.asarray(v), D)
        x[rows, i] = np.asarray(jnp.argmax(eps + jnp.asarray(g[:, s]),
                                           axis=-1))
    return x


@pytest.mark.parametrize(
    "C,S,B,D,n,impl",
    [(C, S, B, D, n, impl)
     for C, S, B, D, n in [(4, 5, 3, 3, 11), (3, 4, 1, 2, 5),
                           (5, 6, 19, 6, 20), (2, 3, 100, 4, 129)]
     for impl in ("ref", "pallas")]
    # a long sweep, against the JAX reference energy only (one Pallas
    # interpret-mode call per sub-step would cost seconds)
    + [(4, 32, 12, 3, 30, "ref")])
def test_plain_sweep_equals_jax_bucket_energy_step_by_step(C, S, B, D, n,
                                                          impl):
    """Integer weights, so every order of summation (the plain sweep's draw
    order, the JAX einsum's, the Pallas kernel's one-hot product) gives the
    same bits: the states must be equal."""
    x, W, i = _inputs(C, S, D, n, "integer")
    seed = _seed(7)
    scale = (n - 1) / B
    got = ops.local_gibbs_sweep(x, W, i, seed, B=B, D=D, scale=scale)
    j = tref.local_gibbs_subsets(seed, i, B, n).numpy()
    g = philox.to_gumbel(philox.uniforms(
        seed, philox.LOCAL_GIBBS_STREAMS["gumbel"], C, S, D)).numpy()
    energy = (jref.bucket_energy_ref if impl == "ref" else
              lambda w, v, D: jops.bucket_energy(w, v, D, impl="pallas"))
    want = _jax_sweep(x.numpy(), W.numpy(), i.numpy(), j, g, D, scale,
                      energy)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x.numpy())            # chains moved


def test_fullbatch_sweep_is_vanilla_gibbs():
    """At B = n - 1 (scale 1) the subset is every other site, so the sweep
    is ``gibbs_sweep_ref`` on the same Gumbels (integer weights: the two
    summation orders give the same bits)."""
    C, S, D, n = 6, 9, 4, 17
    x, W, i = _inputs(C, S, D, n, "integer")
    seed = _seed(2 ** 31 - 1)
    g = philox.to_gumbel(philox.uniforms(
        seed, philox.LOCAL_GIBBS_STREAMS["gumbel"], C, S, D))
    got = tref.local_gibbs_sweep_ref(x, W, i, seed, n - 1, D, 1.0)
    assert torch.equal(got, tref.gibbs_sweep_ref(x, W, i, g, D))


def test_chain_offset_runs_the_rows_of_a_larger_call():
    x, W, i = _inputs(6, 4, 3, 15)
    seed = _seed(3)
    whole = tref.local_gibbs_sweep_ref(x, W, i, seed, 5, 3, 14 / 5)
    part = tref.local_gibbs_sweep_ref(x[2:5], W, i[2:5], seed, 5, 3, 14 / 5,
                                      chain0=2)
    assert torch.equal(whole[2:5], part)


# ---------------------------------------------------------------------------
# the engine and the wrapper
# ---------------------------------------------------------------------------

def test_engine_draws_sites_then_seed_and_runs_one_sweep_call():
    g = tfg.make_potts_graph(grid=3, beta=1.0, D=3, device="cpu")
    eng = engine.make("local-gibbs", g, sweep=6, device="cpu", batch_size=4)
    st = eng.init(11, 5, start="random")
    x0 = st.x.clone()
    gen = torch.Generator().set_state(st.gen.get_state())
    i = torch.randint(0, g.n, (5, 6), generator=gen, dtype=torch.int32)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32)
    want = tref.local_gibbs_sweep_ref(x0, g.W, i, seed, 4, 3, (g.n - 1) / 4)
    out = eng.sweep(st)
    assert torch.equal(out.x, want)
    assert torch.equal(out.gen.get_state(), gen.get_state())


def test_fused_sweep_matches_the_step_sweep_in_distribution():
    """One fused call of S sub-steps and S single-site steps
    (``_build_step_sweep`` of ``make_local_gibbs_step``: top-B of uniform
    keys, other bits) are the same Markov kernel: from the same start, each
    site's value distribution and each pair's agreement rate after the call
    agree within 4 Monte Carlo sigmas (three Ising pairs, B = 2 of the 5
    other sites, biased away from Gibbs)."""
    C, S, B = 4096, 6, 2
    g = tfg.make_pair_ising(2, 1, 3.5, 0.25, device="cpu")
    fused = samplers._build_local_gibbs_sweep(g, B, S)
    steps = samplers._build_step_sweep(samplers.make_local_gibbs_step(g, B),
                                       S)
    outs = []
    for k, sweep in enumerate((fused, steps)):
        st = samplers.init_state(torch.Generator().manual_seed(30 + k), g, C)
        outs.append(sweep(st).x.numpy())
    onehot = lambda x: (x[..., None] == np.arange(g.D)).astype(np.float64)
    agree = lambda x: (x[:, 0::2] == x[:, 1::2]).astype(np.float64)
    a, b = outs
    assert (a != 0).any() and (b != 0).any()       # both moved from zeros
    for f in (onehot, agree):
        diff = f(a).mean(0) - f(b).mean(0)
        sigma = np.sqrt((f(a).var(0) + f(b).var(0)) / C)
        assert np.all(np.abs(diff) <= 4 * sigma + 1e-9), (diff, sigma)


def test_wrapper_refuses_cpu_tensors_and_bad_inputs():
    x, W, i = _inputs(2, 3, 3, 8)
    seed = _seed(0)
    local_sweep.local_gibbs_sweep_cuda.launches = 0
    kw = dict(B=3, D=3, scale=7 / 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        local_sweep.local_gibbs_sweep_cuda(x, W, i, seed, **kw)
    with pytest.raises(ValueError, match="seed must be torch.int32"):
        local_sweep.local_gibbs_sweep_cuda(x, W, i, seed.long(), **kw)
    with pytest.raises(ValueError, match="i_sites must have shape"):
        local_sweep.local_gibbs_sweep_cuda(x, W, i[:1].contiguous(), seed,
                                           **kw)
    with pytest.raises(ValueError, match="recomputed must be torch.int32"):
        local_sweep.local_gibbs_sweep_cuda(
            x, W, i, seed, recomputed=torch.zeros(2, dtype=torch.int64),
            **kw)
    with pytest.raises(ValueError, match="recomputed must have shape"):
        local_sweep.local_gibbs_sweep_cuda(
            x, W, i, seed, recomputed=torch.zeros(3, dtype=torch.int32),
            **kw)
    meta = [t.to("meta") for t in (x, W, i, seed)]
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        ops.local_gibbs_sweep(*meta, **kw)
    assert local_sweep.local_gibbs_sweep_cuda.launches == 0


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
@pytest.mark.parametrize("weights", ["real", "integer"])
def test_local_sweep_kernel_equals_plain_version(cuda, weights):
    """Same Philox bits, same Floyd subsets, same summation order: the
    kernel and the plain version give the same states bit for bit."""
    for C, S, B, D, n in PARITY:
        x, W, i = _inputs(C, S, D, n, weights, device=cuda)
        for k in SEEDS:
            seed = _seed(k, cuda)
            before = local_sweep.local_gibbs_sweep_cuda.launches
            got = ops.local_gibbs_sweep(x, W, i, seed, B=B, D=D,
                                        scale=(n - 1) / B)
            want = tref.local_gibbs_sweep_ref(x, W, i, seed, B, D,
                                              (n - 1) / B)
            torch.cuda.synchronize()
            assert local_sweep.local_gibbs_sweep_cuda.launches == before + 1
            assert torch.equal(got, want), (C, S, B, D, n, k)


@pytest.mark.gpu
def test_local_sweep_kernel_repeats_its_bits(cuda):
    """The consumer recomputes a sub-step whose values changed after the
    producer read them, so a launch's states do not depend on timing: two
    launches on the same inputs give the same bits (and the plain
    version's).  The recompute counts may differ between the launches; at
    the shape where nearly every check fails they are not all zero, and no
    chain counts more than its S sub-steps."""
    C, S, B, D, n = STALE
    scale = (n - 1) / B
    total = 0
    for weights in ("real", "integer"):
        x, W, i = _inputs(C, S, D, n, weights, device=cuda)
        for k in SEEDS:
            seed = _seed(k, cuda)
            outs, counts = [], []
            for _ in range(2):
                rec = torch.full((C,), -1, dtype=torch.int32, device=cuda)
                outs.append(local_sweep.local_gibbs_sweep_cuda(
                    x, W, i, seed, B=B, D=D, scale=scale, recomputed=rec))
                counts.append(rec)
            want = tref.local_gibbs_sweep_ref(x, W, i, seed, B, D, scale)
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1]), (weights, k)
            assert torch.equal(outs[0], want), (weights, k)
            for rec in counts:
                assert bool(((rec >= 0) & (rec <= S)).all()), rec
                total += int(rec.sum())
    assert total > 0
    # the launch still takes the parent's envelope: a row of 40,000 sites
    # with a subset of 4,600 fits (with fewer producer warps)
    plan = local_sweep.local_sweep_plan(40_000, 64, 4_600, 2)
    assert plan["producers"] >= 1 and plan["slots"] >= 1, plan
