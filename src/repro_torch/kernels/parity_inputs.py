"""numpy-drawn inputs of the fused sweeps at the parity shapes.

The kernels, their plain versions and the JAX oracles are compared on the
same inputs, drawn exactly as the JAX package's ``tests/test_sweep.py``
draws them (seeded ``numpy.random.default_rng``, the same draw order).
The port's tests and ``chip_smoke.py`` both build their inputs here, in
each sweep's argument order.
"""
from __future__ import annotations

import numpy as np

from ..core.factor_graph import (build_alias_table, make_pair_ising,
                                 pack_alias, pair_colors)

__all__ = ["alias_rows", "node_table", "gibbs_inputs", "mgpmh_inputs",
           "mgpmh_edge_inputs",
           "min_gibbs_inputs", "double_min_inputs", "edge_totals",
           "packed_args", "packed_mgpmh_args", "local_gibbs_inputs",
           "class_graph", "gibbs_class_inputs", "telemetry_inputs"]


def _symmetric(rng, n):
    A = rng.uniform(0.1, 1.0, (n, n))
    A = (A + A.T) / 2
    np.fill_diagonal(A, 0)
    return A


def alias_rows(rng, n):
    """A random symmetric (n, n) weight matrix and its row alias tables:
    (W float32, row_prob float32, row_alias int32)."""
    A = _symmetric(rng, n)
    rp = np.zeros((n, n), np.float32)
    ra = np.zeros((n, n), np.int32)
    for i in range(n):
        rp[i], ra[i] = build_alias_table(A[i])
    return A.astype(np.float32), rp, ra


def node_table(rng, n):
    """The node alias table (prob, alias) of a second random matrix's row
    sums."""
    return build_alias_table(_symmetric(rng, n).sum(1))


def gibbs_inputs(C, S, D, n):
    """(x, W, i_sites, gumbel)."""
    rng = np.random.default_rng(C + S + D + n)
    W, _, _ = alias_rows(rng, n)
    return (rng.integers(0, D, (C, n)).astype(np.int32), W,
            rng.integers(0, n, (C, S)).astype(np.int32),
            rng.gumbel(size=(C, S, D)).astype(np.float32))


def mgpmh_inputs(C, S, K, D, n):
    """(x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias, gumbel,
    logu)."""
    rng = np.random.default_rng(C * 100 + S * 10 + K + D + n)
    W, rp, ra = alias_rows(rng, n)
    x = rng.integers(0, D, (C, n)).astype(np.int32)
    i = rng.integers(0, n, (C, S)).astype(np.int32)
    B = rng.integers(0, K + 1, (C, S)).astype(np.int32)
    u1 = rng.uniform(size=(C, S, K)).astype(np.float32)
    u2 = rng.uniform(size=(C, S, K)).astype(np.float32)
    g = rng.gumbel(size=(C, S, D)).astype(np.float32)
    lu = np.log(rng.uniform(size=(C, S))).astype(np.float32)
    return (x, W, rp, ra, i, B, u1, u2, g, lu)


# above it the edge inputs' tables are drawn on the device: the Python Vose
# build of an (n, n) table would take minutes to hours
VOSE_MAX_N = 2048


def mgpmh_edge_inputs(C, S, K, D, n, device):
    """``mgpmh_inputs``' tuple as torch tensors on ``device``, at the edges
    of the MGPMH kernels: x[:, :3] outside [0, D) (-1, D, D + 5) at sites no
    sub-step updates (i_sites in [3, n); the updated sites must hold values
    in [0, D)), and Poisson totals at 0 and at K (``edge_totals``).  Up to
    ``VOSE_MAX_N`` the row tables are Vose tables of a random symmetric
    matrix (``alias_rows``); above it W, prob and alias are uniform draws on
    the device (any prob in [0, 1) and alias in [0, n) is a valid input of
    the draw's formula).  Needs n >= 4 and C >= 2."""
    import torch
    rng = np.random.default_rng(C * 100 + S * 10 + K + D + n + 7)
    if n <= VOSE_MAX_N:
        tables = [torch.from_numpy(a).to(device) for a in alias_rows(rng, n)]
    else:
        gen = torch.Generator(device=device).manual_seed(n + D)
        tables = [torch.rand((n, n), generator=gen, device=device),
                  torch.rand((n, n), generator=gen, device=device),
                  torch.randint(0, n, (n, n), generator=gen, device=device,
                                dtype=torch.int32)]
    x = rng.integers(0, D, (C, n)).astype(np.int32)
    x[:, :3] = (-1, D, D + 5)
    i = rng.integers(3, n, (C, S)).astype(np.int32)
    B = edge_totals(rng.integers(0, K + 1, (C, S)).astype(np.int32), K)
    u1 = rng.uniform(size=(C, S, K)).astype(np.float32)
    u2 = rng.uniform(size=(C, S, K)).astype(np.float32)
    g = rng.gumbel(size=(C, S, D)).astype(np.float32)
    lu = np.log(rng.uniform(size=(C, S))).astype(np.float32)
    t = lambda *a: [torch.from_numpy(v).to(device) for v in a]
    return (*t(x), *tables, *t(i, B, u1, u2, g, lu))


def min_gibbs_inputs(C, S, K, D, n):
    """(x, node_prob, node_alias, row_prob, row_alias, i_sites, B, u_node,
    u_nacc, u_row, u_racc, gumbel, cache)."""
    rng = np.random.default_rng(C * 100 + S * 10 + K + D + n)
    _, rp, ra = alias_rows(rng, n)
    npb, nab = node_table(rng, n)
    x = rng.integers(0, D, (C, n)).astype(np.int32)
    i = rng.integers(0, n, (C, S)).astype(np.int32)
    B = rng.integers(0, K + 1, (C, S, D)).astype(np.int32)
    u4 = [rng.uniform(size=(C, S, D, K)).astype(np.float32) for _ in range(4)]
    g = rng.gumbel(size=(C, S, D)).astype(np.float32)
    cache = rng.uniform(0, 3, (C,)).astype(np.float32)
    return (x, npb, nab, rp, ra, i, B, *u4, g, cache)


def double_min_inputs(C, S, K1, K2, D, n):
    """(x, row_prob, row_alias, node_prob, node_alias, i_sites, B1, u_idx,
    u_alias, gumbel, B2, u_node, u_nacc, u_row, u_racc, logu, cache)."""
    rng = np.random.default_rng(C * 100 + S * 10 + K1 + K2 + D + n)
    _, rp, ra = alias_rows(rng, n)
    npb, nab = node_table(rng, n)
    x = rng.integers(0, D, (C, n)).astype(np.int32)
    i = rng.integers(0, n, (C, S)).astype(np.int32)
    B1 = rng.integers(0, K1 + 1, (C, S)).astype(np.int32)
    u1 = rng.uniform(size=(C, S, K1)).astype(np.float32)
    u2 = rng.uniform(size=(C, S, K1)).astype(np.float32)
    g = rng.gumbel(size=(C, S, D)).astype(np.float32)
    B2 = rng.integers(0, K2 + 1, (C, S)).astype(np.int32)
    v4 = [rng.uniform(size=(C, S, K2)).astype(np.float32) for _ in range(4)]
    lu = np.log(rng.uniform(size=(C, S))).astype(np.float32)
    cache = rng.uniform(0, 3, (C,)).astype(np.float32)
    return (x, rp, ra, npb, nab, i, B1, u1, u2, g, B2, *v4, lu, cache)


def edge_totals(B, K):
    """A copy of the Poisson totals ``B`` ((C, S) or (C, S, D)) with rows
    at the ends of [0, K]: chain 0's first sub-step 0, chain 1's first
    sub-step K, and the last (c, s) row K (with D candidates: 0 and K in
    turns) -- rows whose lanes a kernel skips whole or walks to the end."""
    B = np.array(B, copy=True)
    B[0, 0] = 0
    B[1 % B.shape[0], 0] = K
    if B.ndim == 3:
        B[-1, -1, ::2], B[-1, -1, 1::2] = 0, K
    else:
        B[-1, -1] = K
    return B


def packed_args(args):
    """A MIN-Gibbs or DoubleMIN kernel's arguments from its plain
    version's (tensors, host or Philox form): the (prob, alias) table pairs
    at positions 1-4 packed into records, as the engines hand them over."""
    return (args[0], pack_alias(args[1], args[2]),
            pack_alias(args[3], args[4]), *args[5:])


def packed_mgpmh_args(args):
    """An MGPMH kernel's arguments from its plain version's (tensors, host
    or Philox form): the row tables at positions 2-3 packed into one
    record per entry, as the engine hands them over."""
    return (args[0], args[1], pack_alias(args[2], args[3]), *args[4:])


def local_gibbs_inputs(C, S, D, n, weights="real"):
    """(x, W, i_sites) of a local-gibbs sweep call (its subsets and Gumbels
    come from the seed; it reads no alias table, so none is built).
    ``weights``: "real" (a random symmetric matrix, entries in [0.1, 1),
    zero diagonal) or "integer" (symmetric integers in [-4, 4], zero
    diagonal: every summation order gives the same bits)."""
    rng = np.random.default_rng(C * 100 + S * 10 + D + n)
    W = _symmetric(rng, n).astype(np.float32)
    if weights == "integer":
        A = np.triu(rng.integers(-4, 5, (n, n)), 1)
        W = (A + A.T).astype(np.float32)
    return (rng.integers(0, D, (C, n)).astype(np.int32), W,
            rng.integers(0, n, (C, S)).astype(np.int32))


def _weights(rng, mask, weights):
    """Symmetric weights on the symmetric 0/1 pattern ``mask``: "ising"
    (0.8, lattice-ising's 2*beta), "real" (uniform in [0.1, 1]) or
    "integer" (integers in [1, 4]: every summation order gives the same
    bits)."""
    n = mask.shape[0]
    if weights == "ising":
        A = np.full((n, n), 0.8)
    elif weights == "real":
        A = rng.uniform(0.1, 1.0, (n, n))
    elif weights == "integer":
        A = rng.integers(1, 5, (n, n)).astype(np.float64)
    else:
        raise ValueError(f"unknown weights {weights!r}")
    A = np.triu(A, 1)
    return ((A + A.T) * mask).astype(np.float32)


def _greedy_coloring(W):
    """A proper coloring of W's pattern: each site, in order, takes the
    smallest color none of its earlier neighbours has."""
    n = W.shape[0]
    colors = np.zeros(n, np.int32)
    for i in range(n):
        taken = set(colors[np.flatnonzero(W[i, :i])].tolist())
        colors[i] = min(set(range(n)) - taken)
    return colors


def class_graph(kind, size, weights="real"):
    """(W (n, n) float32, colors (n,) int32): a graph with zero diagonal and
    a proper coloring of it.

    ``kind``: "lattice", the size x size nearest-neighbour lattice (open
    edges) with its checkerboard coloring; "pairs", ``size`` + ``size``
    independent pairs with ``make_pair_ising``'s weights (3.5, then 0.25)
    and the even/odd coloring; "hub", ``size`` sites where site 0 is joined
    to every other site and the others by a sparse random pattern (some of
    them isolated from all but the hub), greedily colored, so site 0 is a
    class of its own of degree size - 1.  ``weights`` as ``_weights``
    (pairs ignore it).
    """
    rng = np.random.default_rng(1000 + size)
    if kind == "lattice":
        n = size * size
        r, c = np.divmod(np.arange(n), size)
        mask = ((np.abs(r[:, None] - r[None, :])
                 + np.abs(c[:, None] - c[None, :])) == 1).astype(np.float64)
        return _weights(rng, mask, weights), ((r + c) % 2).astype(np.int32)
    if kind == "pairs":
        return (make_pair_ising(size, size, device="cpu").W.numpy(),
                pair_colors(2 * size))
    if kind == "hub":
        n = size
        mask = np.triu(rng.uniform(size=(n, n)) < 3.0 / n, 1)
        mask[:, n // 2:] &= False             # the upper half: hub only
        mask[0, 1:] = True
        mask = (mask | mask.T).astype(np.float64)
        W = _weights(rng, mask, weights)
        return W, _greedy_coloring(W)
    raise ValueError(f"unknown graph kind {kind!r}")


def gibbs_class_inputs(C, D, n, sites, seed):
    """(x, sites, gumbel) of one class update: x (C, n) int32 with values
    in [-1, D] (a few outside [0, D), which match no bucket), the class
    sites as int32, gumbel (C, m, D) float32."""
    rng = np.random.default_rng(seed)
    sites = np.asarray(sites, np.int32)
    return (rng.integers(-1, D + 1, (C, n)).astype(np.int32), sites,
            rng.gumbel(size=(C, sites.size, D)).astype(np.float32))


def telemetry_inputs(T, C, n, D, seed, *, stay=0.8, S=64):
    """T steps of the telemetry update's inputs: a sticky (T + 1, C, n)
    int32 x trajectory (each value kept with probability ``stay``), and per
    step accept deltas (T, C) int32 in [0, S), per-site proposal and
    acceptance counts (T, n) float32 (acceptances <= proposals), caches
    (T, C) float32 from N(0, 1) and the sites of S sub-steps (T, C, S)
    int32 in [0, n) (a ``SiteDraws``).  Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, D, size=(C, n), dtype=np.int32)]
    for _ in range(T):
        fresh = rng.integers(0, D, size=(C, n), dtype=np.int32)
        xs.append(np.where(rng.random((C, n)) < stay, xs[-1], fresh))
    prop = rng.integers(0, 9, size=(T, n)).astype(np.float32)
    return dict(
        xs=np.stack(xs).astype(np.int32),
        acc=rng.integers(0, S, size=(T, C), dtype=np.int32),
        prop=prop,
        site_acc=np.minimum(prop, rng.integers(0, 9, size=(T, n))).astype(
            np.float32),
        cache=rng.normal(size=(T, C)).astype(np.float32),
        sites=rng.integers(0, n, size=(T, C, S), dtype=np.int32))
