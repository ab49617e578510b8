"""The port's graphs and estimators against the JAX package's, on the CPU.

Same builders, same inputs: the port's alias tables and weights must equal
the JAX package's exactly (both run Vose's algorithm on the same float64
weights), energies agree to float32 summation order, and the capacity rule
picks the same capacity.
"""
import subprocess
import sys
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro.core import factor_graph as jfg  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import estimators as test_  # noqa: E402
from repro_torch.core import factor_graph as tfg  # noqa: E402

LEAVES = ("W", "row_sum", "row_prob", "row_alias", "pair_a", "pair_b",
          "pair_prob", "pair_alias")

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _pair(name):
    """(JAX graph, port graph) of one registered workload or lattice."""
    if name == "lattice-8":
        return jfg.make_lattice_ising(8), tfg.make_lattice_ising(8,
                                                                 device="cpu")
    return (jengine.make_workload(name).graph,
            tengine.make_workload(name, device="cpu").graph)


@pytest.mark.parametrize("name", ["ising-20x20", "potts-20x20",
                                  "hetero-pairs-24", "lattice-8"])
def test_tables_equal_jax_builders(name):
    jg, tg = _pair(name)
    for leaf in LEAVES:
        np.testing.assert_array_equal(np.asarray(getattr(jg, leaf)),
                                      getattr(tg, leaf).numpy(), err_msg=leaf)
    assert tg.D == jg.D and tg.delta == jg.delta
    np.testing.assert_allclose(tg.psi, jg.psi, rtol=1e-12)
    np.testing.assert_allclose(tg.L, jg.L, rtol=1e-12)
    assert tg.n == jg.n and tg.num_factors == jg.num_factors


def test_graph_from_numpy_round_trips_a_jax_graph():
    jg = jfg.make_potts_graph(grid=5, beta=2.0, D=4)
    arrays = {k: np.asarray(getattr(jg, k)) for k in LEAVES}
    tg = tfg.graph_from_numpy(arrays, D=jg.D, psi=jg.psi, L=jg.L,
                              delta=jg.delta, device="cpu")
    for leaf in LEAVES:
        t = getattr(tg, leaf)
        assert t.dtype == (torch.int32 if "alias" in leaf or leaf in
                           ("pair_a", "pair_b") else torch.float32)
        np.testing.assert_array_equal(arrays[leaf], t.numpy(), err_msg=leaf)
    assert (tg.D, tg.psi, tg.L, tg.delta) == (jg.D, jg.psi, jg.L, jg.delta)
    with pytest.raises(ValueError, match="row_prob"):
        tfg.graph_from_numpy({"W": arrays["W"], "row_sum": arrays["row_sum"]},
                             D=4, psi=1.0, L=1.0, delta=1, device="cpu")


@pytest.mark.parametrize("name", ["ising-20x20", "potts-20x20"])
def test_energies_match_jax(name):
    jg, tg = _pair(name)
    rng = np.random.default_rng(7)
    x = rng.integers(0, jg.D, (3, jg.n)).astype(np.int32)
    je = np.asarray(jg.energy(jnp.asarray(x)))
    te = tg.energy(torch.from_numpy(x)).numpy()
    W64 = np.asarray(jg.W).astype(np.float64)
    exact = 0.5 * ((x[:, :, None] == x[:, None, :]) * W64).sum((1, 2))
    # the port's float32 sum of n^2 terms is within 1e-6 of the float64
    # value; the JAX einsum's own float32 error reaches 1.1e-6 at n = 400,
    # so port and JAX are held to each other at twice that
    np.testing.assert_allclose(te, exact, rtol=1e-6)
    np.testing.assert_allclose(te, je, rtol=2e-6)
    for i in (0, 17, jg.n - 1):
        jc = np.asarray(jg.cond_energies(jnp.asarray(x[0]), i))
        tc = tg.cond_energies(torch.from_numpy(x[0]), i).numpy()
        np.testing.assert_allclose(tc, jc, rtol=1e-6)


def test_graph_moves_between_devices_with_its_tables():
    tg = tfg.make_potts_graph(grid=3, D=3, device="cpu")
    assert tg.to("cpu") is tg
    assert tg.device == torch.device("cpu")


def test_build_alias_table_equals_jax():
    rng = np.random.default_rng(3)
    for p in (rng.uniform(size=50), np.zeros(4), np.array([0.0, 2.0, 1.0])):
        for a, b in zip(tfg.build_alias_table(p), jfg.build_alias_table(p)):
            np.testing.assert_array_equal(a, b)


def _alias_rows(case):
    rng = np.random.default_rng(7)
    if case == "sparse":                # zeros, an all-zero row, ties at 1
        P = rng.uniform(size=(40, 37))
        P[rng.uniform(size=P.shape) < 0.4] = 0.0
        P[3] = 0.0
        P[4] = 1.0
        return P
    if case == "integers":
        return rng.integers(0, 3, (30, 16)).astype(np.float64)
    # potts-64x64's float32 W rows, a column block, as the dist shards
    W = tfg.gaussian_kernel_interactions(16) * 4.6
    return W.astype(np.float32)[:, 64:128]


@pytest.mark.parametrize("case", ["sparse", "integers", "potts-block"])
def test_build_alias_tables_equals_the_row_loop(case):
    """The vectorised Vose pass gives every row the table
    ``build_alias_table`` gives it alone, bit for bit."""
    P = _alias_rows(case)
    prob, alias = tfg.build_alias_tables(P)
    for r in range(P.shape[0]):
        p1, a1 = tfg.build_alias_table(P[r])
        np.testing.assert_array_equal(prob[r].view(np.int32),
                                      p1.view(np.int32), err_msg=str(r))
        np.testing.assert_array_equal(alias[r], a1, err_msg=str(r))


def test_alias_draw_distribution():
    p = np.array([0.1, 0.5, 0.0, 0.4])
    prob, alias = (torch.from_numpy(t) for t in tfg.build_alias_table(p))
    gen = torch.Generator().manual_seed(0)
    draws = tfg.alias_draw(gen, prob, alias, (200_000,))
    assert draws.dtype == torch.int32
    freq = np.bincount(draws.numpy(), minlength=4) / draws.numel()
    np.testing.assert_allclose(freq, p, atol=5e-3)


@pytest.mark.parametrize("lam", [0.5, 8.0, 103.5, 4 * 5.088 ** 2, 1000.0,
                                 16384.0])
def test_recommended_capacity_equals_jax(lam):
    assert test_.recommended_capacity(lam) == jest.recommended_capacity(lam)
    k = test_.recommended_capacity(lam)
    # float32 incomplete-gamma tails agree to ~1% relative near 1e-10;
    # what matters is the decision against the 1e-8 tail, checked above
    np.testing.assert_allclose(float(test_.capacity_overflow_prob(lam, k)),
                               float(jest.capacity_overflow_prob(lam, k)),
                               rtol=1e-4, atol=1e-10)


def test_recommended_capacity_at_workload_lambdas():
    """The capacities the port's mgpmh engine uses on the registered
    workloads are the JAX engine's."""
    for name in ("ising-20x20", "potts-20x20", "hetero-pairs-24"):
        L = tengine.make_workload(name, device="cpu").graph.L
        lam = 4.0 * L ** 2
        assert test_.recommended_capacity(lam) == \
            jest.recommended_capacity(lam)


def test_lemma2_lambda_equals_jax():
    assert test_.lemma2_lambda(957.1, 3.0, 0.01) == \
        jest.lemma2_lambda(957.1, 3.0, 0.01)


def test_draw_local_minibatch_shapes_and_support():
    g = tfg.make_potts_graph(grid=4, D=3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    j, B = test_.draw_local_minibatch(gen, g, 5, lam=30.0, capacity=60)
    assert j.shape == (60,) and j.dtype == torch.int32
    assert 0 <= int(B) <= 60
    assert bool((g.W[5, j.long()] > 0).all())     # only neighbours of 5


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    g = tfg.make_potts_graph(grid=2, D=3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.make("gibbs", g, sweep=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfg.make_potts_graph(grid=2, D=3)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": SRC},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12
