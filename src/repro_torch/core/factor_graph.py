"""Factor-graph representations for minibatch Gibbs sampling (PyTorch).

The paper's experimental models (Ising / Potts with a Gaussian-kernel
interaction matrix) are both *weighted-match* pairwise models:

  Potts:  phi_{ij}(x) = beta * A_ij * delta(x_i, x_j)          M_phi = b A_ij
  Ising:  phi_{ij}(x) = beta * A_ij * (s_i s_j + 1)            M_phi = 2 b A_ij

with one factor per *unordered* pair {i,j}.  Both are
``phi_ij(x) = W_ij * delta(x_i, x_j)`` for a symmetric non-negative
match-weight matrix W.  :class:`MatchGraph` holds W and every Definition-1
quantity (``Psi``, ``L``, ``Delta``) as tensors on one device, plus the
alias tables that make a factor draw O(1).  :class:`TabularPairwiseGraph`
holds general tabular pairwise factors in numpy for the exact
transition-matrix validators (``spectral.py``) and exact marginals
(``diagnostics/exact.py``), small state spaces only.

Alias tables are built once on the host with Vose's algorithm, from the
float64 weights, so they are identical to the JAX package's tables.  The
per-row tables, kept as one packed record per entry (read by MGPMH,
MIN-Gibbs and DoubleMIN and the single-site local proposal), and the flat
pair table (read by the global minibatch estimators) are built on first
use: the Gibbs engines read neither, and the flat table alone has n(n-1)/2
entries.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "MatchGraph",
    "TabularPairwiseGraph",
    "build_alias_table",
    "build_alias_tables",
    "alias_draw",
    "pack_alias",
    "graph_from_numpy",
    "gaussian_kernel_interactions",
    "make_ising_graph",
    "make_potts_graph",
    "make_lattice_ising",
    "lattice_colors",
    "make_pair_ising",
    "pair_colors",
]


# ---------------------------------------------------------------------------
# Alias tables (Vose) — O(1) categorical sampling
# ---------------------------------------------------------------------------

def build_alias_table(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build a Vose alias table for probability vector ``p`` (need not be
    normalized).  Returns ``(prob, alias)`` with ``prob`` float32 in [0,1]
    and ``alias`` int32, each of shape ``p.shape``.
    """
    p = np.asarray(p, dtype=np.float64)
    m = p.shape[0]
    total = p.sum()
    if total <= 0:
        # Degenerate: uniform table.
        return np.ones(m, np.float32), np.arange(m, dtype=np.int32)
    q = p * (m / total)
    prob = np.zeros(m, np.float64)
    alias = np.zeros(m, np.int32)
    small = [i for i in range(m) if q[i] < 1.0]
    large = [i for i in range(m) if q[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = q[s]
        alias[s] = l
        q[l] = (q[l] + q[s]) - 1.0
        (small if q[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32)


def build_alias_tables(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias tables of every row of ``P`` (R, m), all rows advanced
    together: the same float64 arithmetic and the same stack order as
    :func:`build_alias_table` row by row, so the tables are bit-identical
    to it, in at most m vectorised steps instead of R * m Python ones.
    Returns ``(prob, alias)``, float32 and int32, each (R, m)."""
    P = np.asarray(P, dtype=np.float64)
    R, m = P.shape
    total = np.array([row.sum() for row in P])   # each row's own sum, as
    live = total > 0                             # build_alias_table's
    q = P * (m / np.where(live, total, 1.0))[:, None]
    prob = np.zeros((R, m), np.float64)
    alias = np.zeros((R, m), np.int32)
    # each row's small and large stacks, ascending, popped from the top
    is_small = q < 1.0
    small = np.argsort(~is_small, axis=1, kind="stable")
    large = np.argsort(is_small, axis=1, kind="stable")
    ns = is_small.sum(1)
    nl = m - ns
    while True:
        r = np.flatnonzero((ns > 0) & (nl > 0) & live)
        if r.size == 0:
            break
        ns[r] -= 1
        nl[r] -= 1
        s, l = small[r, ns[r]], large[r, nl[r]]
        prob[r, s] = q[r, s]
        alias[r, s] = l
        q[r, l] = (q[r, l] + q[r, s]) - 1.0
        back = q[r, l] < 1.0
        rs, rl = r[back], r[~back]
        small[rs, ns[rs]] = l[back]
        ns[rs] += 1
        large[rl, nl[rl]] = l[~back]
        nl[rl] += 1
    cols = np.arange(m)
    for stack, top in ((small, ns), (large, nl)):
        rows, k = np.nonzero(cols[None, :] < top[:, None])
        prob[rows, stack[rows, k]] = 1.0
    prob[~live] = 1.0                            # degenerate: uniform
    alias[~live] = cols
    return prob.astype(np.float32), alias


def alias_draw(gen: torch.Generator, prob: torch.Tensor, alias: torch.Tensor,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Draw ``shape`` iid samples from the alias table in O(1) each, from
    ``gen`` (a generator on the table's device)."""
    m = prob.shape[0]
    idx = torch.randint(0, m, shape, generator=gen, device=prob.device)
    u = torch.rand(shape, generator=gen, device=prob.device)
    return torch.where(u >= prob[idx], alias[idx].long(), idx).to(torch.int32)


def pack_alias(prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """An alias table as one record per entry: ``(..., 2)`` int32 whose
    record e holds ``prob[e]``'s float32 bits and ``alias[e]``.  The
    MIN-Gibbs and DoubleMIN kernels read one aligned 8-byte record per
    draw (one memory sector) where the two tables would cost two."""
    if prob.dtype != torch.float32 or alias.dtype != torch.int32:
        raise ValueError(f"pack_alias takes float32 prob and int32 alias, "
                         f"got {prob.dtype} and {alias.dtype}")
    if prob.shape != alias.shape:
        raise ValueError(f"prob {tuple(prob.shape)} and alias "
                         f"{tuple(alias.shape)} differ in shape")
    return torch.stack((prob.view(torch.int32), alias), dim=-1)


# ---------------------------------------------------------------------------
# Interaction matrices (paper Appendix B)
# ---------------------------------------------------------------------------

def gaussian_kernel_interactions(grid: int, gamma: float = 1.5) -> np.ndarray:
    """``A_ij = exp(-gamma * d_ij^2)`` for variables laid out on a
    ``grid x grid`` lattice (paper Appendix B).  Zero diagonal."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij"), -1).reshape(-1, 2)
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    A = np.exp(-gamma * d2.astype(np.float64))
    np.fill_diagonal(A, 0.0)
    return A


# ---------------------------------------------------------------------------
# MatchGraph
# ---------------------------------------------------------------------------

_PAIR_TABLES = ("pair_a", "pair_b", "pair_prob", "pair_alias")


class MatchGraph:
    """Dense weighted-match pairwise factor graph on one device.

    Attributes
    ----------
    W        : (n, n) float32 symmetric, zero diagonal — match weights = M_phi.
    D        : domain size of every variable.
    psi      : total maximum energy  Psi = sum_{i<j} W_ij.
    L        : local maximum energy  L = max_i sum_j W_ij.
    delta    : max degree Delta = max_i |{j : W_ij > 0}|.
    row_sum  : (n,) L_i = sum_j W_ij.
    row_pack : (n, n, 2) int32, the per-row alias tables, p_j = W_ij / L_i
               (the local minibatch over A[i]; stage two of the global
               pair draw), as one record per entry (:func:`pack_alias`):
               what every sampler reads.  Packed on the host at first use
               and the only copy kept: 8n^2 bytes (128 MiB at n = 4096).
    row_prob/row_alias   : (n, n) views of row_pack's two fields (float32
                           prob, int32 alias), for the plain versions.
    pair_a/b : (F,) endpoints of the F = n(n-1)/2 upper-triangle factors.
    pair_prob/pair_alias : alias table over factors, p_phi = M_phi / Psi;
                           built on first use.
    """

    def __init__(self, *, W: torch.Tensor, D: int, psi: float, L: float,
                 delta: int, row_sum: torch.Tensor,
                 tables: Optional[Mapping[str, torch.Tensor]] = None,
                 weights64: Optional[np.ndarray] = None):
        self.W = W
        self.D = int(D)
        self.psi = float(psi)
        self.L = float(L)
        self.delta = int(delta)
        self.row_sum = row_sum
        self._tables = dict(tables or {})
        # float64 weights the lazy alias tables are built from (as the JAX
        # builder does); None when every table was given
        self._weights64 = weights64

    @property
    def device(self) -> torch.device:
        return self.W.device

    @property
    def n(self) -> int:
        return self.W.shape[0]

    @property
    def num_factors(self) -> int:
        return self.n * (self.n - 1) // 2

    def _table(self, name: str) -> torch.Tensor:
        if name not in self._tables:
            if self._weights64 is None:
                raise ValueError(f"graph was built without {name!r} and "
                                 f"without host weights to build it from")
            if name == "row_pack":      # packed on the host; only it kept
                tables = {name: pack_alias(*map(
                    torch.from_numpy, build_alias_tables(self._weights64)))}
            else:
                tables = dict(zip(_PAIR_TABLES,
                                  map(torch.from_numpy,
                                      _pair_tables(self._weights64))))
            for k, v in tables.items():
                self._tables[k] = v.to(self.device)
        return self._tables[name]

    row_pack = property(lambda self: self._table("row_pack"))
    row_prob = property(
        lambda self: self.row_pack[..., 0].view(torch.float32))
    row_alias = property(lambda self: self.row_pack[..., 1])
    pair_a = property(lambda self: self._table("pair_a"))
    pair_b = property(lambda self: self._table("pair_b"))
    pair_prob = property(lambda self: self._table("pair_prob"))
    pair_alias = property(lambda self: self._table("pair_alias"))

    @property
    def nbr_pack(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """W's non-zero entries row by row, as a CSR neighbour table:
        (offsets (n + 1,) int32, records (nnz, 2) int32), row i's records
        ``records[offsets[i]:offsets[i + 1]]``, each (j, W[i, j]'s float32
        bits), j ascending.  Built on the host from the float32 W at first
        use and kept; only the chromatic engine reads it."""
        if "nbr_offsets" not in self._tables:
            W = self.W.cpu().numpy()
            rows, cols = np.nonzero(W)              # row-major, j ascending
            offsets = np.zeros(self.n + 1, np.int32)
            np.cumsum(np.bincount(rows, minlength=self.n), out=offsets[1:])
            records = np.stack([cols.astype(np.int32),
                                W[rows, cols].view(np.int32)], axis=-1)
            self._tables["nbr_offsets"] = torch.from_numpy(offsets).to(
                self.device)
            self._tables["nbr_records"] = torch.from_numpy(
                np.ascontiguousarray(records)).to(self.device)
        return self._tables["nbr_offsets"], self._tables["nbr_records"]

    def to(self, device) -> "MatchGraph":
        """This graph on ``device`` (self when it is there already)."""
        device = torch.device(device)
        if device.type == self.device.type and device.index in (
                None, self.device.index):
            return self
        return MatchGraph(
            W=self.W.to(device), D=self.D, psi=self.psi, L=self.L,
            delta=self.delta, row_sum=self.row_sum.to(device),
            tables={k: v.to(device) for k, v in self._tables.items()},
            weights64=self._weights64)

    # -- energies --
    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """Total energy zeta(x) = sum_{i<j} W_ij d(x_i, x_j).

        ``x``: (..., n) int32.  Returns (...,) float32.
        """
        match = (x[..., :, None] == x[..., None, :]).to(self.W.dtype)
        return 0.5 * torch.einsum("...ij,ij->...", match, self.W)

    def cond_energies(self, x: torch.Tensor, i) -> torch.Tensor:
        """Exact conditional energies eps_u = sum_{j != i} W_ij d(u, x_j)
        for all u (the O(D*Delta) inner loop of Algorithm 1).

        ``x``: (n,) int32, ``i``: scalar site index.  Returns (D,) float32.
        """
        w_row = self.W[i]  # (n,) ; diagonal is zero so j == i contributes 0
        onehot = (x[:, None] == torch.arange(self.D, device=x.device)
                  ).to(w_row.dtype)                         # (n, D)
        return w_row @ onehot

    @staticmethod
    def from_interactions(A: np.ndarray, *, match_weight_scale: float,
                          D: int, device=None) -> "MatchGraph":
        """Build from a symmetric interaction matrix A, with
        ``W = match_weight_scale * A``."""
        device = resolve_device(device)
        A = np.asarray(A, np.float64)
        if not np.allclose(A, A.T):
            raise ValueError("interaction matrix must be symmetric")
        W = match_weight_scale * A
        np.fill_diagonal(W, 0.0)
        n = W.shape[0]
        iu, ju = np.triu_indices(n, k=1)
        psi = float(W[iu, ju].sum())
        row_sum = W.sum(1)
        L = float(row_sum.max())
        delta = int((W > 0).sum(1).max())
        return MatchGraph(
            W=torch.from_numpy(W.astype(np.float32)).to(device), D=D,
            psi=psi, L=L, delta=delta,
            row_sum=torch.from_numpy(row_sum.astype(np.float32)).to(device),
            weights64=W)


def _pair_tables(W: np.ndarray):
    iu, ju = np.triu_indices(W.shape[0], k=1)
    pair_prob, pair_alias = build_alias_table(W[iu, ju])
    return (iu.astype(np.int32), ju.astype(np.int32), pair_prob, pair_alias)


def graph_from_numpy(arrays: Mapping[str, np.ndarray], *, D: int, psi: float,
                     L: float, delta: int, device=None) -> MatchGraph:
    """A port graph from another implementation's arrays — e.g. the JAX
    ``MatchGraph``'s leaves, ``{f: np.asarray(getattr(g, f))}`` for ``W``,
    ``row_sum``, ``row_prob``, ``row_alias``, ``pair_a``, ``pair_b``,
    ``pair_prob`` and ``pair_alias`` — so both compute on the same tables.
    Every array is required and taken as given; the row tables are kept
    packed (``MatchGraph.row_pack``)."""
    device = resolve_device(device)
    missing = {"W", "row_sum", "row_prob", "row_alias",
               *_PAIR_TABLES} - set(arrays)
    if missing:
        raise ValueError(f"graph_from_numpy needs arrays {sorted(missing)}")
    dtypes = {"W": torch.float32, "row_sum": torch.float32,
              "row_prob": torch.float32, "pair_prob": torch.float32,
              "row_alias": torch.int32, "pair_a": torch.int32,
              "pair_b": torch.int32, "pair_alias": torch.int32}
    t = {k: torch.tensor(np.asarray(arrays[k])).to(device, dtypes[k])
         for k in dtypes}
    t["row_pack"] = pack_alias(t.pop("row_prob"), t.pop("row_alias"))
    return MatchGraph(W=t.pop("W"), D=D, psi=psi, L=L, delta=delta,
                      row_sum=t.pop("row_sum"), tables=t)


def make_ising_graph(grid: int = 20, beta: float = 1.0, gamma: float = 1.5,
                     device=None) -> MatchGraph:
    """Paper Section 2 validation model: fully-connected Ising on a
    ``grid x grid`` lattice, Gaussian-kernel interactions, D = 2, match
    weight 2*beta*A (grid=20, beta=1 gives Psi = 416.1, L = 2.21)."""
    A = gaussian_kernel_interactions(grid, gamma)
    return MatchGraph.from_interactions(A, match_weight_scale=2.0 * beta,
                                        D=2, device=device)


def make_potts_graph(grid: int = 20, beta: float = 4.6, D: int = 10,
                     gamma: float = 1.5, device=None) -> MatchGraph:
    """Paper Section 3 validation model: Potts, match weight beta*A
    (grid=20, beta=4.6 gives Psi = 957.1, L = 5.09)."""
    A = gaussian_kernel_interactions(grid, gamma)
    return MatchGraph.from_interactions(A, match_weight_scale=beta, D=D,
                                        device=device)


def make_lattice_ising(grid: int, beta: float = 0.4,
                       device=None) -> MatchGraph:
    """Nearest-neighbor Ising on a grid (sparse, 2-colorable): the workload
    where chromatic scheduling applies."""
    n = grid * grid
    W = np.zeros((n, n))
    for r in range(grid):
        for c in range(grid):
            i = r * grid + c
            for (dr, dc) in ((0, 1), (1, 0)):
                rr, cc = r + dr, c + dc
                if rr < grid and cc < grid:
                    j = rr * grid + cc
                    W[i, j] = W[j, i] = 2.0 * beta   # ising match weight
    return MatchGraph.from_interactions(W, match_weight_scale=1.0, D=2,
                                        device=device)


def lattice_colors(grid: int) -> np.ndarray:
    """Checkerboard 2-coloring of the ``grid x grid`` lattice."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    return ((r + c) % 2).astype(np.int32)


def make_pair_ising(n_strong: int, n_weak: int, w_strong: float = 3.5,
                    w_weak: float = 0.25, device=None) -> MatchGraph:
    """Heterogeneous pair-Ising: ``n_strong + n_weak`` independent 2-site
    Ising pairs (sites 2p, 2p+1 coupled with match weight ``w_strong`` for
    the first ``n_strong`` pairs, ``w_weak`` after).  Every marginal is
    exactly uniform; pairs are 2-colorable (``pair_colors``)."""
    n = 2 * (n_strong + n_weak)
    W = np.zeros((n, n))
    for p in range(n_strong + n_weak):
        w = w_strong if p < n_strong else w_weak
        W[2 * p, 2 * p + 1] = W[2 * p + 1, 2 * p] = w
    return MatchGraph.from_interactions(W, match_weight_scale=1.0, D=2,
                                        device=device)


def pair_colors(n_pairs: int) -> np.ndarray:
    """Proper 2-coloring of ``make_pair_ising`` (even/odd site of a pair)."""
    return (np.arange(2 * n_pairs) % 2).astype(np.int32)


# ---------------------------------------------------------------------------
# TabularPairwiseGraph — general factors for exact validation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TabularPairwiseGraph:
    """General pairwise factor graph with explicit tables.

    Factor f connects variables (a_f, b_f) and has value
    ``phi_f(x) = table[f, x[a_f], x[b_f]] >= 0``.  Used by the exact
    transition-matrix validators, small n only.  Pure numpy (a copy of the
    JAX package's class, so the port reads no module of it).
    """

    pairs: np.ndarray   # (F, 2) int
    tables: np.ndarray  # (F, D, D) float64, non-negative
    n: int
    D: int

    def __post_init__(self):
        if self.tables.min() < 0.0:
            raise ValueError("factors must be non-negative")

    @property
    def num_factors(self) -> int:
        return self.pairs.shape[0]

    def factor_values(self, x: np.ndarray) -> np.ndarray:
        """phi_f(x) for all f.  x: (n,) -> (F,)."""
        a, b = self.pairs[:, 0], self.pairs[:, 1]
        return self.tables[np.arange(self.num_factors), x[a], x[b]]

    def energy(self, x: np.ndarray) -> float:
        return float(self.factor_values(x).sum())

    # Definition 1 quantities ------------------------------------------------
    @property
    def M(self) -> np.ndarray:
        """Per-factor maximum energies."""
        return self.tables.max(axis=(1, 2))

    @property
    def psi(self) -> float:
        return float(self.M.sum())

    def adjacent(self, i: int) -> np.ndarray:
        """Indices of factors that depend on variable i (A[i])."""
        return np.where((self.pairs == i).any(axis=1))[0]

    @property
    def L(self) -> float:
        return float(max(self.M[self.adjacent(i)].sum()
                         for i in range(self.n)))

    @property
    def delta(self) -> int:
        return int(max(len(self.adjacent(i)) for i in range(self.n)))

    def all_states(self) -> np.ndarray:
        """Enumerate Omega (D^n states).  (|Omega|, n) int array."""
        grids = np.meshgrid(*([np.arange(self.D)] * self.n), indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=-1)

    def pi(self) -> np.ndarray:
        """Exact stationary distribution over all_states()."""
        states = self.all_states()
        e = np.array([self.energy(s) for s in states])
        w = np.exp(e - e.max())
        return w / w.sum()

    @staticmethod
    def random(n: int, D: int, max_energy: float, seed: int,
               connectivity: str = "full") -> "TabularPairwiseGraph":
        rng = np.random.default_rng(seed)
        if connectivity == "full":
            pairs = np.array([(i, j) for i in range(n)
                              for j in range(i + 1, n)])
        elif connectivity == "chain":
            pairs = np.array([(i, i + 1) for i in range(n - 1)])
        else:
            raise ValueError(connectivity)
        tables = rng.uniform(0.0, max_energy, size=(len(pairs), D, D))
        return TabularPairwiseGraph(pairs=pairs, tables=tables, n=n, D=D)

    @staticmethod
    def from_match_graph(g: MatchGraph) -> "TabularPairwiseGraph":
        """The match graph's n(n-1)/2 upper-triangle factors (the order of
        ``pair_a`` / ``pair_b``) as tables ``W_ab * 1[x_a == x_b]``."""
        W = g.W.cpu().numpy()
        a, b = np.triu_indices(W.shape[0], k=1)
        pairs = np.stack([a, b], -1)
        tables = W[a, b][:, None, None] * np.eye(g.D)[None, :, :]
        return TabularPairwiseGraph(pairs=pairs, tables=tables,
                                    n=W.shape[0], D=g.D)
