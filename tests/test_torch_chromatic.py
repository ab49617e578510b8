"""The port's chromatic Gibbs class update: its plain version against the
JAX oracle on the CPU, the neighbour table it walks, the chromatic engine's
replay, the class wrapper's checks -- and, on a machine with a CUDA card,
the class kernel against its plain version.

A color class of a proper coloring shares no factor, so one class update
equals the JAX package's sequential Gibbs sweep
(``repro.kernels.ref.gibbs_sweep_ref``) fed the class as every chain's
sites.  Decisions are compared exactly: both sides sum the same float32
terms of a dense row (the in-class terms are +0), and at these sizes the
two summation orders give the same argmax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402
from repro_torch.kernels import chromatic_sweep, ops  # noqa: E402
from repro_torch.kernels import parity_inputs as pin  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (graph kind, size, weights, D): lattice-ising's own weights at two grids,
# random float weights, make_pair_ising, a ragged graph with a hub of
# degree size - 1; D in {2, 3, 10}
CLASS_CASES = [("lattice", 4, "ising", 2), ("lattice", 6, "ising", 2),
               ("lattice", 6, "real", 3), ("lattice", 5, "real", 10),
               ("pairs", 3, "real", 2), ("hub", 40, "real", 3),
               ("hub", 70, "real", 10), ("hub", 70, "integer", 2)]


def _classes(colors):
    return [np.flatnonzero(colors == c) for c in range(colors.max() + 1)]


def _class_case(kind, size, weights, D, C=5, seed=0):
    """[(x, W, sites, gumbel) numpy, one per color class]."""
    W, colors = pin.class_graph(kind, size, weights)
    return [(*pin.gibbs_class_inputs(C, D, W.shape[0], sites, seed + k), W)
            for k, sites in enumerate(_classes(colors))]


@pytest.mark.parametrize("kind,size,weights,D", CLASS_CASES)
def test_class_sweep_ref_equals_jax_oracle(kind, size, weights, D):
    for x, sites, g, W in _class_case(kind, size, weights, D):
        C = x.shape[0]
        i_sites = np.ascontiguousarray(np.broadcast_to(sites, (C, sites.size)))
        xj = jref.gibbs_sweep_ref(jnp.asarray(x), jnp.asarray(W),
                                  jnp.asarray(i_sites), jnp.asarray(g), D)
        args = tuple(map(torch.from_numpy, (x, W, sites, g)))
        xt = tref.gibbs_class_sweep_ref(*args, D)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(args[0].numpy(), x)  # input untouched
        # the in-place op on the CPU routes to the plain version
        xo = args[0].clone()
        assert ops.gibbs_class_sweep(xo, args[1], None, args[2], args[3],
                                     D=D) is xo
        assert torch.equal(xo, xt)


@pytest.mark.parametrize("kind,size", [("lattice", 4), ("pairs", 2),
                                       ("hub", 40), ("isolated", 12)])
def test_nbr_pack_reproduces_W(kind, size):
    if kind == "isolated":              # rows 0, 5 and 11 have no neighbour
        W, _ = pin.class_graph("hub", size)
        W[0] = W[:, 0] = 0.0
        W[[5, 11]] = 0.0
        W[:, [5, 11]] = 0.0
    else:
        W, _ = pin.class_graph(kind, size)
    g = tfg.MatchGraph.from_interactions(W.astype(np.float64),
                                         match_weight_scale=1.0, D=3,
                                         device="cpu")
    offsets, records = g.nbr_pack
    assert offsets.dtype == torch.int32 and records.dtype == torch.int32
    assert offsets.shape == (g.n + 1,) and records.shape[1] == 2
    assert records.is_contiguous()
    nnz = int((g.W != 0).sum())
    assert int(offsets[0]) == 0 and int(offsets[-1]) == nnz
    assert records.shape[0] == nnz
    off = offsets.long()
    rows = torch.repeat_interleave(torch.arange(g.n), off[1:] - off[:-1])
    dense = torch.zeros_like(g.W)
    dense[rows, records[:, 0].long()] = records[:, 1].view(torch.float32)
    assert torch.equal(dense, g.W)                # bits, zeros included
    for i in range(g.n):                          # j ascending per row
        js = records[off[i]:off[i + 1], 0]
        assert bool((js[1:] > js[:-1]).all())
    assert (off[1:] == off[:-1]).any() == (kind == "isolated")
    assert g.nbr_pack[0] is offsets               # built once, kept


def test_chromatic_engine_replays_from_seed_and_keeps_its_input():
    g = tfg.make_lattice_ising(6, device="cpu")
    eng = engine.make("gibbs", g,
                      schedule=engine.ChromaticBlocks(tfg.lattice_colors(6)),
                      device="cpu")
    runs = []
    for _ in range(2):
        st = eng.init(11, 7, start="random")
        x0 = st.x.clone()
        for _ in range(3):
            prev = st.x
            st = eng.sweep(st)
            assert st.x is not prev
        assert not torch.equal(st.x, x0)
        runs.append(st.x)
    assert torch.equal(runs[0], runs[1])
    again = eng.init(11, 7, start="random")
    assert torch.equal(again.x, x0)               # init does not move


def test_class_wrapper_refuses_cpu_tensors_and_bad_inputs():
    chromatic_sweep.gibbs_class_sweep_cuda.launches = 0
    W, colors = pin.class_graph("lattice", 4, "ising")
    g = tfg.MatchGraph.from_interactions(W.astype(np.float64),
                                         match_weight_scale=1.0, D=2,
                                         device="cpu")
    off, rec = g.nbr_pack
    x, sites, gum = map(torch.from_numpy, pin.gibbs_class_inputs(
        3, 2, g.n, np.flatnonzero(colors == 0), 0))
    f = chromatic_sweep.gibbs_class_sweep_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        f(x, off, rec, sites, gum, D=2)
    with pytest.raises(ValueError, match="gumbel must have shape"):
        f(x, off, rec, sites, gum[:, :, :1], D=2)
    with pytest.raises(ValueError, match="x must be torch.int32"):
        f(x.long(), off, rec, sites, gum, D=2)
    with pytest.raises(ValueError, match="offsets must have shape"):
        f(x, off[:-1], rec, sites, gum, D=2)
    with pytest.raises(ValueError, match="records must have shape"):
        f(x, off, rec.flatten(), sites, gum, D=2)
    with pytest.raises(ValueError, match="sites must be torch.int32"):
        f(x, off, rec, sites.long(), gum, D=2)
    with pytest.raises(ValueError, match="sites must have shape"):
        f(x, off, rec, sites[None], gum, D=2)
    assert f.launches == 0


# ---------------------------------------------------------------------------
# on the card: the class kernel vs its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _on_card_exact(dev, W, colors, D, C, seed):
    """Every class of (W, colors): the kernel (twice, on fresh copies)
    equals its plain version and the sequential plain version exactly."""
    g = tfg.MatchGraph.from_interactions(W.astype(np.float64),
                                         match_weight_scale=1.0, D=D,
                                         device=dev)
    nbr = g.nbr_pack
    f = chromatic_sweep.gibbs_class_sweep_cuda
    for k, sites in enumerate(_classes(colors)):
        x, s, gum = (torch.from_numpy(a).to(dev) for a in
                     pin.gibbs_class_inputs(C, D, g.n, sites, seed + k))
        before = f.launches
        outs = [f(x.clone(), *nbr, s, gum, D=D) for _ in range(2)]
        want = tref.gibbs_class_sweep_ref(x, g.W, s, gum, D)
        seq = tref.gibbs_sweep_ref(x, g.W, s.expand(C, -1).contiguous(), gum,
                                   D)
        torch.cuda.synchronize()
        assert f.launches == before + 2
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(outs[0], want) and torch.equal(want, seq)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,C", [(4, 5), (6, 3), (64, 256)])
def test_class_kernel_equals_plain_version_on_the_lattice(cuda, grid, C):
    W, colors = pin.class_graph("lattice", grid, "ising")
    _on_card_exact(cuda, W, colors, 2, C, seed=grid)


@pytest.mark.gpu
@pytest.mark.parametrize("size,D", [(100, 2), (100, 10), (300, 3),
                                    (300, 129)])
def test_class_kernel_equals_plain_version_at_high_degree(cuda, size, D):
    """Integer weights: every summation order gives the same bits, so the
    warp form (the hub's row) is held to the dense plain version
    exactly."""
    W, colors = pin.class_graph("hub", size, "integer")
    assert (W != 0).sum(1).max() == size - 1 > 32
    _on_card_exact(cuda, W, colors, D, 6, seed=size + D)
