"""Distributed minibatch Gibbs: the ``"dist"`` backend of the Engine API
(``core/engine.py``) on ``torch.distributed``, one process per rank.

Consumers never build distributed sweeps by hand: ``engine.make(name,
graph, mesh=...)`` shards the graph and returns an Engine whose ``sweep``
hides the collectives.  This module owns the sharded graph layout and the
distributed sweep template.

Parallelization (the JAX package's ``runtime/dist_gibbs.py``; its
``shard_map`` + ``psum`` become one process per rank and
``torch.distributed.all_reduce`` over the mesh's process groups):

* chains are split over the data dimensions of the mesh: a rank holds the
  C / dp chains of its data shard;
* the *graph* is split over "model": each model shard owns a column slice
  of the interaction matrix W (and the factors whose higher endpoint falls
  in those columns); the state x is replicated over the model shards of a
  data shard, so every shard evaluates its partial energies locally.

:func:`make_dist_sweep` computes the shard-local x-independent partial
energies plus the within-sweep delta-correction couplings for whichever
estimators the algorithm needs, packs them into ONE float32 buffer and
all-reduces it over the model group once per S-update call, then runs the
per-algorithm accept/update recursion replicated on every model shard from
shared draws (no communication; statistically identical to S single-site
updates of the reference sampler).  The substeps are the selection and
acceptance rules of ``core.samplers`` (``gibbs_select``,
``min_gibbs_select``, ``mh_accept``).

  algorithm   partials in the one all-reduce                substep
  ---------   ------------------------------------------   -------------
  gibbs       exact0 (C,S,D), Wp (C,S,S)                   gibbs_select
  mgpmh       + eps0 (C,S,D), Cp (C,S,S)                   select+mh_accept
  min-gibbs   m0 (C,S,D), n1 (C,S,D,S,D), n2 (C,S,D,S,S)   min_gibbs_select
  doublemin   eps0, Cp + m0 (C,S), n1 (C,S,S,D),           select+mh_accept
              n2 (C,S,S,S)                                  (cached xi)

(:func:`psum_footprint` gives the payload.)  On top of the template:

* :func:`make_dist_chromatic_sweep` — block updates of whole color classes
  against the sharded graph, one all-reduce per color class; bit-equal to
  the dense :func:`make_chromatic_gibbs_step` on the lattice workloads;
* :func:`make_dist_adaptive_sweep` — AdaptiveScan under sharding: per
  data-shard flip/hit counters; on refresh calls the cross-shard counter
  reduction rides the call's one all-reduce, widened to the whole mesh.

Draws.  A rank holds two ``torch.Generator``s on its device: ``gen``,
seeded from (seed, data shard) and so the same stream on every model
shard of a data shard, gives every draw the replicated recursion reads
(sites, Gumbels, MH uniforms, the AdaptiveScan site uniforms, the cache
seed), each shard drawing the same shapes in the same order; ``local_gen``,
seeded from (seed, data shard, model shard), gives the shard's own
proposal and global-estimator draws (the JAX package's ``fold_in(key,
shard_idx)``).  :func:`shard_seeds` makes both seeds.

Every collective of the module goes through :func:`all_reduce`, which
counts its calls.  The recursion runs eagerly: S sub-steps of ~15 small
operations each per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import checkpoint as ckpt
from ..core.estimators import min_gibbs_lscale
from ..core.factor_graph import (MatchGraph, build_alias_table,
                                 build_alias_tables)
from ..core.samplers import (at_code, gibbs_select, gumbel,
                             inverse_cdf_sites, mh_accept, min_gibbs_select)
from ..launch.mesh import MP_AXIS, mesh_coords, mesh_group

__all__ = ["ShardedMatchGraph", "MeshShard", "DistState",
           "DistAdaptiveState", "make_dist_sweep",
           "make_dist_chromatic_sweep", "make_dist_adaptive_sweep",
           "make_chromatic_gibbs_step", "dist_init_state", "shard_seeds",
           "gather_marginals", "psum_footprint", "all_reduce", "DIST_ALGOS",
           "dist_to_host", "dist_restore", "reshard_dp"]

DIST_ALGOS = ("gibbs", "mgpmh", "min-gibbs", "doublemin")


# ---------------------------------------------------------------------------
# Graph sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedMatchGraph:
    """One model shard of a MatchGraph: column slice ``shard`` of
    ``n_shards``, on one device.

      W_cols    (n, n_loc)   W[:, cols]
      row_prob  (n, n_loc)   per-row alias tables over the local columns
      row_alias (n, n_loc)
      row_sum   (n,)         L_i^loc = sum_{j in cols} W[i, j]
      pair_a/b  (F_max,)     the factors {a, b} (a < b, W_ab > 0) whose
                             column b the shard owns, padded to the largest
                             shard's count
      pair_prob/pair_alias (F_max,)  alias table over those factors
      psi_loc                the sum of their weights (a host float)

    ``row_sum_max`` / ``psi_loc_max`` are the largest over all shards (the
    engine sizes its draw capacities for the worst shard).  The arrays are
    the JAX package's ``ShardedMatchGraph`` arrays at index ``shard`` of
    their shard axis.  ``row_tables`` / ``pair_tables`` skip the tables an
    algorithm never reads (gibbs and chromatic read neither, min-gibbs only
    the pair tables): skipped arrays are size-1 placeholders.
    """
    W_cols: torch.Tensor
    row_prob: torch.Tensor
    row_alias: torch.Tensor
    row_sum: torch.Tensor
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    pair_prob: torch.Tensor
    pair_alias: torch.Tensor
    psi_loc: float
    D: int
    psi: float
    L: float
    n: int
    n_shards: int
    shard: int
    row_sum_max: float
    psi_loc_max: float

    @property
    def n_loc(self) -> int:
        return self.W_cols.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.W_cols.device

    @staticmethod
    def from_graph(g: MatchGraph, n_shards: int, shard: int = 0, *,
                   row_tables: bool = True, pair_tables: bool = True,
                   device=None) -> "ShardedMatchGraph":
        """Shard ``shard`` of ``g`` split into ``n_shards`` column slices,
        on ``device`` (the graph's unless given).  The tables are built on
        the host from the float32 W, as the JAX package builds them; the
        row tables of all n rows in one vectorised Vose pass."""
        W = g.W.cpu().numpy()
        n = W.shape[0]
        if n % n_shards:
            raise ValueError(f"graph.n={n} must divide into {n_shards} "
                             f"column shards")
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} outside [0, {n_shards})")
        n_loc = n // n_shards
        blocks = [np.ascontiguousarray(W[:, s * n_loc:(s + 1) * n_loc])
                  for s in range(n_shards)]
        row_sums = [b.sum(-1) for b in blocks]
        cols = blocks[shard]
        if row_tables:
            rp, ra = build_alias_tables(cols)
        else:
            rp, ra = np.zeros((1, 1), np.float32), np.zeros((1, 1), np.int32)
        if pair_tables:
            # factor shards: pair {a, b} (a < b) owned by b's shard
            iu, ju = np.triu_indices(n, k=1)
            M = W[iu, ju]
            keep = M > 0
            iu, ju, M = iu[keep], ju[keep], M[keep]
            own = ju // n_loc
            F_max = int(np.bincount(own, minlength=n_shards).max())
            psi_locs = []
            for s in range(n_shards):
                m = own == s
                Ms = np.zeros(F_max)
                Ms[:int(m.sum())] = M[m]
                psi_locs.append(np.float32(Ms.sum()))
                if s == shard:
                    f = int(m.sum())
                    pa = np.zeros(F_max, np.int32)
                    pb = np.zeros(F_max, np.int32)
                    pa[:f], pb[:f] = iu[m], ju[m]
                    pp, pl = build_alias_table(Ms)
        else:
            pa = pb = pl = np.zeros(1, np.int32)
            pp = np.zeros(1, np.float32)
            psi_locs = [np.float32(g.psi / n_shards)] * n_shards
        dev = g.device if device is None else torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return ShardedMatchGraph(
            W_cols=t(cols), row_prob=t(rp), row_alias=t(ra),
            row_sum=t(row_sums[shard]), pair_a=t(pa), pair_b=t(pb),
            pair_prob=t(pp), pair_alias=t(pl),
            psi_loc=float(psi_locs[shard]), D=g.D, psi=g.psi, L=g.L, n=n,
            n_shards=n_shards, shard=shard,
            row_sum_max=float(max(r.max() for r in row_sums)),
            psi_loc_max=float(max(psi_locs)))


# ---------------------------------------------------------------------------
# The mesh as a rank sees it, and the one collective
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShard:
    """This rank's place in a ("data"..., "model") mesh and the process
    groups its collectives run over (``None`` is the default group)."""
    dp_index: int
    dp: int
    mp_index: int
    mp: int
    model_group: Any = None
    mesh_group: Any = None

    @staticmethod
    def of(mesh) -> "MeshShard":
        dp_index, dp, mp_index, mp = mesh_coords(mesh)
        return MeshShard(dp_index, dp, mp_index, mp,
                         model_group=mesh.get_group(MP_AXIS),
                         mesh_group=mesh_group(mesh))


def all_reduce(buf: torch.Tensor, group) -> torch.Tensor:
    """Sum ``buf`` in place over ``group``: every collective of the dist
    backend goes through here, and ``all_reduce.calls`` counts them."""
    all_reduce.calls += 1
    dist.all_reduce(buf, group=group)
    return buf


all_reduce.calls = 0


def psum_footprint(algo: str, *, C: int, D: int, S: int = 0, n: int = 0,
                   n_colors: int = 0) -> dict:
    """Collective count and float32 all-reduce payload of ONE sweep call of
    the distributed template (per data shard).  ``algo`` is a template
    algorithm name or ``"chromatic"`` (``n`` / ``n_colors`` required there;
    one all-reduce per color class).  A copy of the JAX package's function.
    """
    if algo == "chromatic":
        return {"collectives_per_sweep": n_colors,
                "psum_payload_bytes": 4 * n_colors * C * n * D}
    elems = {
        "gibbs": C * S * D + C * S * S,
        "mgpmh": 2 * C * S * D + 2 * C * S * S,
        "min-gibbs": C * S * D + C * S * D * S * D + C * S * D * S * S,
        "doublemin": (C * S * D + C * S * S
                      + C * S + C * S * S * D + C * S * S * S),
    }[algo]
    return {"collectives_per_sweep": 1, "psum_payload_bytes": 4 * elems}


def _fused_psum(parts: dict, shard: MeshShard, ride=None):
    """THE one collective of a sweep call: ``parts`` packed into one flat
    float32 buffer, all-reduced over the model group, unpacked.

    With ``ride`` (the AdaptiveScan counters, on refresh calls) the same
    one all-reduce runs over the whole mesh instead: this data shard's
    partials sit in its slot of a data-shard-padded buffer, the counters
    after it, so one sum gives both the per-data-shard energy sums and the
    all-chain counters (each counted once per model shard, hence the
    division).  Returns ``(parts, ride_out)``."""
    names = list(parts)
    flat = torch.cat([parts[k].reshape(-1) for k in names])
    ride_out = None
    if ride is None:
        all_reduce(flat, shard.model_group)
    else:
        size = flat.numel()
        extra = torch.cat([r.reshape(-1) for r in ride])
        buf = flat.new_zeros(shard.dp * size + extra.numel())
        buf[shard.dp_index * size:(shard.dp_index + 1) * size] = flat
        buf[shard.dp * size:] = extra
        all_reduce(buf, shard.mesh_group)
        flat = buf[shard.dp_index * size:(shard.dp_index + 1) * size]
        ride_out = [t.view_as(r) / shard.mp for t, r in zip(
            buf[shard.dp * size:].split([r.numel() for r in ride]), ride)]
    out = flat.split([parts[k].numel() for k in names])
    return {k: t.view_as(parts[k]) for k, t in zip(names, out)}, ride_out


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

class DistState(NamedTuple):
    """One rank's part of the distributed chain state."""
    x: torch.Tensor              # (C_loc, n) int32, the same on every
    #                              model shard of the data shard
    cache: torch.Tensor          # (C_loc,) float32 cached eps / xi
    gen: torch.Generator         # the data shard's shared draws
    local_gen: torch.Generator   # this rank's own draws
    accepts: torch.Tensor        # (C_loc,) int32
    marg: torch.Tensor           # (C_loc, n_loc, D) float32 running one-hot
    #                              sums of this shard's columns
    count: int                   # samples accumulated


class DistAdaptiveState(NamedTuple):
    """DistState + the AdaptiveScan control state under sharding.

    ``cdf`` is the cumulative site-selection table, the same on every rank
    (it is rebuilt from the all-mesh-reduced counters); ``flips`` / ``hits``
    are this data shard's cumulative counters over its chains; ``calls`` is
    the host's call counter.  ``x`` / ``accepts`` / ``marg`` / ``count``
    forward to ``inner``."""
    inner: DistState
    cdf: torch.Tensor      # (n,) float32
    flips: torch.Tensor    # (n,) float32 value changes of this data shard
    hits: torch.Tensor     # (n,) float32 site visits of this data shard
    calls: int

    @property
    def x(self):
        return self.inner.x

    @property
    def accepts(self):
        return self.inner.accepts

    @property
    def marg(self):
        return self.inner.marg

    @property
    def count(self):
        return self.inner.count


def shard_seeds(seed: int, dp_index: int, mp_index: int) -> Tuple[int, int]:
    """``(shared, local)`` generator seeds of a rank: ``shared`` depends on
    (seed, data shard) only, ``local`` on the model shard too."""
    mix = lambda *key: int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])
    return mix(seed, 0, dp_index), mix(seed, 1, dp_index, mp_index)


def dist_init_state(seed: int, n_chains: int, gs: ShardedMatchGraph,
                    shard: MeshShard, *, cache_fn=None,
                    adaptive: bool = False):
    """This rank's start state for ``n_chains`` chains in all (its data
    shard's C / dp of them), every chain at the constant configuration.
    ``cache_fn(gen, x)`` seeds the cache from a host generator seeded with
    the shared seed (the same on every model shard of the data shard)."""
    if n_chains % shard.dp:
        raise ValueError(f"n_chains={n_chains} must divide into "
                         f"dp={shard.dp} data shards")
    C, dev = n_chains // shard.dp, gs.device
    gens = []
    for s in shard_seeds(seed, shard.dp_index, shard.mp_index):
        gens.append(torch.Generator(device=dev))
        gens[-1].manual_seed(s)
    x = torch.zeros((C, gs.n), dtype=torch.int32, device=dev)
    cache = (torch.zeros((C,), device=dev) if cache_fn is None else
             cache_fn(torch.Generator().manual_seed(gens[0].initial_seed()),
                      x))
    st = DistState(x=x, cache=cache, gen=gens[0], local_gen=gens[1],
                   accepts=torch.zeros((C,), dtype=torch.int32, device=dev),
                   marg=torch.zeros((C, gs.n_loc, gs.D), device=dev),
                   count=0)
    if not adaptive:
        return st
    n = gs.n
    return DistAdaptiveState(
        inner=st, cdf=torch.cumsum(torch.full((n,), 1.0 / n, device=dev), 0),
        flips=torch.zeros((n,), device=dev), hits=torch.zeros((n,), device=dev),
        calls=0)


def gather_marginals(state, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The running marginal sums of every chain and column, ``(C, n, D)``,
    and every chain's accept count, ``(C,)`` float32, on every rank of
    ``mesh``: each rank writes its block into a zero buffer and one
    all-reduce over the mesh sums them.  A log-line read: never call it
    inside a sweep."""
    dp_index, dp, mp_index, _ = mesh_coords(mesh)
    C_loc, n_loc, D = state.marg.shape
    C, n = C_loc * dp, state.x.shape[1]
    buf = state.marg.new_zeros(C * n * D + C)
    marg = buf[:C * n * D].view(C, n, D)
    acc = buf[C * n * D:]
    rows = slice(dp_index * C_loc, (dp_index + 1) * C_loc)
    marg[rows, mp_index * n_loc:(mp_index + 1) * n_loc] = state.marg
    if mp_index == 0:
        acc[rows] = state.accepts
    all_reduce(buf, mesh_group(mesh))
    return marg, acc


# ---------------------------------------------------------------------------
# Checkpoints of dist states: global arrays, each rank its slice
# ---------------------------------------------------------------------------

# the per-rank layout of a dist state's leaves, by field name: chains split
# over data (rows), marginal columns over model too, generators per data
# shard or per rank, adaptive counters per data shard; the rest replicated
_ROWS = ("x", "cache", "accepts")
_PER_DP = ("gen", "flips", "hits")


def _layout(key: str, leaf, coords):
    """How ``leaf`` (at checkpoint path ``key``) of this rank's dist state
    sits in the global array: ``(global shape, index of this rank's block,
    whether this rank writes it)``; None for a replicated leaf."""
    dp_index, dp, mp_index, mp = coords
    name = key.split("/")[-1]
    if isinstance(leaf, torch.Generator):
        size = leaf.get_state().numel()
        if name == "local_gen":       # one per rank, in mesh order
            return (dp * mp, size), (dp_index * mp + mp_index,), True
        return (dp, size), (dp_index,), mp_index == 0
    if not isinstance(leaf, torch.Tensor):
        return None
    if name in _ROWS:
        c = leaf.shape[0]
        return ((c * dp,) + tuple(leaf.shape[1:]),
                (slice(dp_index * c, (dp_index + 1) * c),), mp_index == 0)
    if name == "marg":
        c, n_loc = leaf.shape[:2]
        return ((c * dp, n_loc * mp) + tuple(leaf.shape[2:]),
                (slice(dp_index * c, (dp_index + 1) * c),
                 slice(mp_index * n_loc, (mp_index + 1) * n_loc)), True)
    if name in _PER_DP:
        return (dp,) + tuple(leaf.shape), (dp_index,), mp_index == 0
    return None


def dist_to_host(tree, mesh, lead: int):
    """A dist state tree as global numpy arrays on rank ``lead`` (the
    leaves are None elsewhere): chains gathered over data, marginal
    columns over model, generator states stacked (the data shards' shared
    ones on a leading dp axis, every rank's own on a leading world axis).
    One all-reduce over the mesh per split leaf; every rank of the mesh
    calls it."""
    coords, group = mesh_coords(mesh), mesh_group(mesh)
    is_lead = dist.get_rank() == lead
    # the collectives' device: the state's (NCCL sums on the card)
    device = next(v.device for v in ckpt.flatten(tree).values()
                  if isinstance(v, torch.Tensor))

    def one(key, leaf):
        lay = _layout(key, leaf, coords)
        if lay is None:
            if not is_lead:
                return None
            return (leaf.detach().cpu().numpy().copy()
                    if isinstance(leaf, torch.Tensor) else leaf)
        shape, block, writes = lay
        gen = isinstance(leaf, torch.Generator)
        part = leaf.get_state().to(torch.int32) if gen else leaf.detach()
        buf = torch.zeros(shape, dtype=part.dtype, device=device)
        if writes:
            buf[block] = part.to(buf.device)
        dist.all_reduce(buf, group=group)   # gloo reduces card tensors
        #                                     with all-reduce only
        if not is_lead:
            return None
        out = buf.cpu().numpy()
        return out.astype(np.uint8) if gen else out
    return ckpt.map_leaves(one, tree)


def _dist_host_template(template, mesh):
    """Global-shape numpy stand-ins for the dist ``template``: the dtype
    donors of ``checkpoint.restore`` and the shape donors of
    :func:`reshard_dp`."""
    coords = mesh_coords(mesh)

    def one(key, leaf):
        lay = _layout(key, leaf, coords)
        if isinstance(leaf, torch.Generator):
            return np.zeros(lay[0], np.uint8)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return np.zeros(tuple(leaf.shape) if lay is None else lay[0], dtype)
    return ckpt.map_leaves(one, template)


def _dist_from_host(host, template, mesh):
    """This rank's slice of the global ``host`` arrays, in ``template``'s
    structure (its generators take their states from ``host``)."""
    coords, flat = mesh_coords(mesh), ckpt.flatten(host)

    def one(key, leaf):
        arr, lay = flat[key], _layout(key, leaf, coords)
        if lay is not None:
            arr = arr[lay[1]]
        if isinstance(leaf, torch.Generator):
            leaf.set_state(torch.from_numpy(
                np.ascontiguousarray(arr, np.uint8)))
            return leaf
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
        return arr
    return ckpt.map_leaves(one, template)


def dist_restore(directory: str, step: int, template, mesh):
    """Restore a checkpoint of global arrays onto this rank of ``mesh``:
    the stacked per-shard leaves re-binned to the mesh's shape
    (:func:`reshard_dp`), then this rank's slice."""
    like = _dist_host_template(template, mesh)
    host = reshard_dp(ckpt.restore(directory, step, like), like)
    return _dist_from_host(host, template, mesh)


def reshard_dp(tree, like):
    """Re-bin restored leaves whose leading (data-parallel) axis no longer
    matches the template's -- the elastic-restart path, where a checkpoint
    written on dp shards restores onto dp' != dp.  Leaves are numpy arrays
    or tensors; other leaves pass through.

    Global (mesh-independent) shapes pass through untouched.  Shrinking:
    float counters (adaptive flip/hit tables) are group-summed so no
    statistics are lost; integer leaves (per-shard generator states) take
    the first dp' rows -- the surviving shards keep their streams.
    Growing: rows repeat cyclically.  The JAX package's rules."""
    flat = ckpt.flatten(tree)
    return ckpt.map_leaves(lambda k, b: _reshard_leaf(flat[k], b), like)


def _reshard_leaf(a, b):
    if not (hasattr(a, "shape") and hasattr(b, "shape")):
        return a
    if tuple(a.shape) == tuple(b.shape):
        return a
    if (tuple(a.shape[1:]) != tuple(b.shape[1:]) or a.ndim == 0
            or b.ndim == 0):
        raise ValueError(f"cannot reshard leaf {tuple(a.shape)} -> "
                         f"{tuple(b.shape)}")
    new, old = b.shape[0], a.shape[0]
    floating = (b.dtype.is_floating_point if isinstance(b, torch.Tensor)
                else np.issubdtype(b.dtype, np.floating))
    if new <= old:
        if floating and old % new == 0:
            return a.reshape((new, old // new) + tuple(a.shape[1:])).sum(1)
        return a[:new]
    reps = -(-new // old)
    cat = torch.cat if isinstance(a, torch.Tensor) else np.concatenate
    return cat([a] * reps, 0)[:new]


# ---------------------------------------------------------------------------
# Shard-local partials: everything the one all-reduce carries
# ---------------------------------------------------------------------------

def _one_hot(v: torch.Tensor, D: int) -> torch.Tensor:
    return (v.unsqueeze(-1) == torch.arange(
        D, dtype=v.dtype, device=v.device)).to(torch.float32)


def _x_cols(x, shard_idx: int, n_loc: int):
    """This shard's column slice of the replicated state."""
    return x[:, shard_idx * n_loc:(shard_idx + 1) * n_loc]


def _owned(i, shard_idx: int, n_loc: int):
    """Which sweep slots' sites the shard owns, and their local column
    (clamped into range where not owned): (C, S) each."""
    off = shard_idx * n_loc
    return (i >= off) & (i < off + n_loc), (i - off).clamp(0, n_loc - 1)


def _slot_columns(t, loc):
    """``t[c, s, loc[c, u]]`` for every (c, s, u): (C, S, S)."""
    C, S = loc.shape
    return t.gather(2, loc.long()[:, None, :].expand(C, S, S))


def _exact_partials(gs: ShardedMatchGraph, oh_loc, i, shard_idx: int):
    """x-independent exact energies against the sweep-entry state plus the
    within-sweep coupling matrix:
      exact0[c,s,u] = sum_{j loc} W[i_s, j] d(x0_j, u)        (C, S, D)
      Wp[c,s,t]     = W[i_s, i_t] when the shard owns i_t     (C, S, S)
    Returns ``(exact0, Wp, (owned, loc))``."""
    w_rows = gs.W_cols[i]                                 # (C, S, n_loc)
    exact0 = torch.bmm(w_rows, oh_loc)
    owned, loc = _owned(i, shard_idx, gs.n_loc)
    wp = torch.where(owned[:, None, :], _slot_columns(w_rows, loc), 0.0)
    return exact0, wp, (owned, loc)


def _proposal_draws(gs: ShardedMatchGraph, gen, i, lam: float,
                    capacity: int):
    """The shard's MGPMH / DoubleMIN proposal draws for all S sub-steps:
    Poisson totals at the thinned rate ``lam * L_i^loc / L`` (C, S) int32,
    local column indices (C, S, K) int32, alias uniforms (C, S, K)."""
    C, S = i.shape
    dev = i.device
    rate = lam * gs.row_sum[i] / gs.L
    B = torch.poisson(rate, generator=gen).clamp_(max=capacity).to(
        torch.int32)
    idx = torch.randint(0, gs.n_loc, (C, S, capacity), generator=gen,
                        device=dev, dtype=torch.int32)
    u = torch.rand((C, S, capacity), generator=gen, device=dev)
    return B, idx, u


def _proposal_partials(gs: ShardedMatchGraph, oh_loc, i, draws, lam: float,
                       shard_idx: int, exact_aux=None):
    """The proposal minibatch energies by per-shard Poisson thinning, all S
    sub-steps at once:
      eps0[c,s,u] = (L/lam) sum_{draws k} d(x0_{j_k}, u)      (C, S, D)
      Cp[c,s,t]   = (L/lam) draws of sub-step s at i_t        (C, S, S)
    The draws are counted per local column as integers (the sums then do
    not depend on the order the card adds them in)."""
    B, idx, u = draws
    C, S, K = idx.shape
    flat = (i.long() * gs.n_loc)[..., None] + idx
    j_loc = torch.where(u < gs.row_prob.view(-1)[flat], idx,
                        gs.row_alias.view(-1)[flat])
    live = (torch.arange(K, device=i.device) < B[..., None]).to(torch.int32)
    cnt = torch.zeros((C, S, gs.n_loc), dtype=torch.int32, device=i.device)
    cnt = cnt.scatter_add_(2, j_loc.long(), live).to(torch.float32)
    scale = gs.L / lam
    eps0 = scale * torch.bmm(cnt, oh_loc)
    owned, loc = (exact_aux if exact_aux is not None
                  else _owned(i, shard_idx, gs.n_loc))
    cp = torch.where(owned[:, None, :], scale * _slot_columns(cnt, loc), 0.0)
    return eps0, cp


def _global_draws(gs: ShardedMatchGraph, gen, C: int, S: int, U: int,
                  lam2: float, capacity2: int):
    """The shard's global (eq.-2) estimator draws, over its own factors at
    the thinned rate ``lam2 * psi_loc / Psi``: Poisson totals (C, S, U)
    int32, factor indices (C, S, U, K) int32, alias uniforms (C, S, U, K).
    """
    dev = gs.device
    rate = torch.full((C, S, U), lam2 * gs.psi_loc / gs.psi, device=dev)
    B = torch.poisson(rate, generator=gen).clamp_(max=capacity2).to(
        torch.int32)
    shape = (C, S, U, capacity2)
    idx = torch.randint(0, gs.pair_prob.shape[0], shape, generator=gen,
                        device=dev, dtype=torch.int32)
    u = torch.rand(shape, generator=gen, device=dev)
    return B, idx, u


def _first_slots(i, n: int):
    """(C, n) int32: the first sweep slot t with ``i[c, t] == j``, or -1
    where site j is not in chain c's sweep."""
    C, S = i.shape
    slot = torch.full((C, n), S, dtype=torch.int64, device=i.device)
    t = torch.arange(S, device=i.device).expand(C, S)
    slot.scatter_reduce_(1, i.long(), t, reduce="amin")
    return torch.where(slot == S, -1, slot).to(torch.int32)


def _global_partials(gs: ShardedMatchGraph, x0, i, draws):
    """Global (eq.-2) estimator draws for all S sub-steps (and, for
    MIN-Gibbs, all ``U = D`` candidate values: independent minibatches per
    candidate, Alg 2) compressed into the delta-correction tensors the
    replicated recursion evaluates against the *current* state:

      m0[c,s,u]         matches among draws with NO endpoint in the sweep
                        site set {i_1..i_S} (x0 values: never change);
      n1[c,s,u,t,d]     draws with exactly ONE endpoint at sweep slot t,
                        the free endpoint carrying x0-value d;
      n2[c,s,u,t1,t2]   draws with BOTH endpoints in the sweep set.

    An endpoint maps to its site's first slot in the sweep through a
    (C, n) table (:func:`_first_slots`), read by a gather: the same
    function as the JAX package's first-occurrence compare masks, without
    their (C, S, U, K, S) size.  Counts are integers, added in any order.
    """
    B, idx, u = draws
    C, S, U, K = idx.shape
    D, dev = gs.D, x0.device
    # alias draw: keep idx when u < prob[idx], else its alias (the JAX
    # package's src/repro/runtime/dist_gibbs.py:391 has the two swapped,
    # which biases its global estimator toward the heavier factors)
    f = torch.where(u < gs.pair_prob[idx], idx, gs.pair_alias[idx])
    del idx, u
    a = gs.pair_a[f].view(C, -1).long()
    b = gs.pair_b[f].view(C, -1).long()
    del f
    slot = _first_slots(i, gs.n)
    ta = slot.gather(1, a).view(C, S, U, K)
    tb = slot.gather(1, b).view(C, S, U, K)
    x0a = x0.gather(1, a).view(C, S, U, K)
    x0b = x0.gather(1, b).view(C, S, U, K)
    del a, b
    live = torch.arange(K, device=dev) < B[..., None]
    a_in, b_in = ta >= 0, tb >= 0
    m0 = (live & ~a_in & ~b_in & (x0a == x0b)).sum(-1, dtype=torch.float32)
    base = torch.arange(C * S * U, device=dev).view(C, S, U, 1) * S
    ta, tb = ta.clamp(min=0).long(), tb.clamp(min=0).long()
    # a free endpoint's value outside [0, D) counts in no value slot
    da, db = x0a.clamp(0, D - 1), x0b.clamp(0, D - 1)
    n1 = torch.zeros(C * S * U * S * D, dtype=torch.int32, device=dev)
    n1.scatter_add_(0, ((base + ta) * D + db).view(-1),
                    (live & a_in & ~b_in & (db == x0b)).view(-1).to(
                        torch.int32))
    n1.scatter_add_(0, ((base + tb) * D + da).view(-1),
                    (live & b_in & ~a_in & (da == x0a)).view(-1).to(
                        torch.int32))
    n2 = torch.zeros(C * S * U * S * S, dtype=torch.int32, device=dev)
    n2.scatter_add_(0, ((base + ta) * S + tb).view(-1),
                    (live & a_in & b_in).view(-1).to(torch.int32))
    return (m0, n1.view(C, S, U, S, D).to(torch.float32),
            n2.view(C, S, U, S, S).to(torch.float32))


def _global_matches(m0_s, n1_s, n2_s, vals_sub):
    """Evaluate the compressed global estimator at recursion time.

    ``vals_sub`` (..., S) holds the sweep-slot site values *after* the
    sub-step's substitution (candidate u for MIN-Gibbs, proposal v for
    DoubleMIN); leading axes broadcast against the (C[, U], S, ...) count
    tensors."""
    oh_sub = _one_hot(vals_sub, n1_s.shape[-1])
    eq_sub = (vals_sub[..., :, None] == vals_sub[..., None, :]).to(
        torch.float32)
    return (m0_s + (n1_s * oh_sub).sum((-2, -1))
            + (n2_s * eq_sub).sum((-2, -1)))


# ---------------------------------------------------------------------------
# The template: one all-reduce, pluggable per-algorithm substeps
# ---------------------------------------------------------------------------

def make_dist_sweep(gs: ShardedMatchGraph, algo: str, sweep_len: int,
                    shard: MeshShard, *, lam: Optional[float] = None,
                    capacity: Optional[int] = None,
                    lam2: Optional[float] = None,
                    capacity2: Optional[int] = None):
    """``sweep_len`` sequential updates of ``algo`` per call with a single
    all-reduce over the model group (the delta-correction scheme).

    Statistically identical to ``sweep_len`` single-site updates of the
    reference sampler; marginals are accumulated once per call.  Returns
    ``step(state, sites=None, ride=None)``: ``sites`` overrides the
    i.i.d.-uniform site draw (the AdaptiveScan hook); with ``ride`` (a pair
    of counter tensors) the call's one all-reduce runs over the whole mesh
    and it returns ``(state, ride_out)`` (:func:`_fused_psum`).  The
    returned state has a new ``x``; its ``marg`` is the input's buffer,
    updated in place.

    ``lam`` / ``capacity`` are the proposal minibatch (mgpmh, doublemin's
    first batch); ``lam2`` / ``capacity2`` the global estimator batch
    (min-gibbs, where they arrive as ``lam`` / ``capacity`` from the engine
    and are mapped here, and doublemin's second batch).
    """
    if algo not in DIST_ALGOS:
        raise ValueError(f"unknown dist algorithm {algo!r}; "
                         f"supported: {DIST_ALGOS}")
    if algo == "min-gibbs":         # single-minibatch params = global batch
        lam2, capacity2 = lam, capacity
        lam = capacity = None
    n, n_loc, D, S, k = gs.n, gs.n_loc, gs.D, sweep_len, shard.mp_index
    is_mh = algo in ("mgpmh", "doublemin")
    lscale = (min_gibbs_lscale(gs.psi, lam2)
              if algo in ("min-gibbs", "doublemin") else None)

    def step(state: DistState, sites=None, ride=None):
        gen, dev = state.gen, state.x.device
        C = state.x.shape[0]
        x0 = state.x
        i = sites if sites is not None else torch.randint(
            0, n, (C, S), generator=gen, device=dev, dtype=torch.int32)
        parts, ride_out = _fused_psum(
            _local_partials(gs, algo, x0, i, state.local_gen, k, lam=lam,
                            capacity=capacity, lam2=lam2,
                            capacity2=capacity2), shard, ride)

        # --- replicated sequential recursion (shared draws, no comms) ---
        g = gumbel((C, S, D), gen, dev)
        logu = (torch.rand((C, S), generator=gen, device=dev).log_()
                if is_mh else None)
        x, cache, acc = _recursion(algo, parts, x0, i, state.cache, g, logu,
                                   D, lscale)
        state.marg.add_(_one_hot(_x_cols(x, k, n_loc), D))
        new = state._replace(
            x=x, cache=cache,
            accepts=state.accepts + acc if is_mh else state.accepts,
            count=state.count + 1)
        return new if ride is None else (new, ride_out)
    return step


def _local_partials(gs: ShardedMatchGraph, algo: str, x0, i, local_gen,
                    shard_idx: int, *, lam=None, capacity=None, lam2=None,
                    capacity2=None) -> dict:
    """Shard ``shard_idx``'s partials of one call for ``algo`` (the table in
    the module docstring), the proposal draws then the global draws taken
    from ``local_gen``: the parts the call's one all-reduce sums."""
    C, S = i.shape
    needs_exact = algo in ("gibbs", "mgpmh")
    needs_proposal = algo in ("mgpmh", "doublemin")
    n_global = {"min-gibbs": gs.D, "doublemin": 1}.get(algo, 0)
    parts, aux = {}, None
    if needs_exact or needs_proposal:
        # the shard's state columns one-hot once, for both partials
        oh_loc = _one_hot(_x_cols(x0, shard_idx, gs.n_loc), gs.D)
    if needs_exact:
        parts["exact0"], parts["wp"], aux = _exact_partials(gs, oh_loc, i,
                                                            shard_idx)
    if needs_proposal:
        parts["eps0"], parts["cp"] = _proposal_partials(
            gs, oh_loc, i, _proposal_draws(gs, local_gen, i, lam, capacity),
            lam, shard_idx, aux)
    if n_global:
        parts["m0"], parts["n1"], parts["n2"] = _global_partials(
            gs, x0, i, _global_draws(gs, local_gen, C, S, n_global, lam2,
                                     capacity2))
    return parts


def _recursion(algo, parts, x0, i, cache, g, logu, D, lscale):
    """The S sub-steps of one call on the all-reduced partials, the same
    on every model shard.  Returns ``(x, cache, accepts)``."""
    C, S = i.shape
    dev = x0.device
    rows = torch.arange(C, device=dev)
    il = i.long()
    # count each duplicated site once: first occurrence along t
    dup = torch.tril(i[:, :, None] == i[:, None, :], diagonal=-1).any(-1)
    nodup = (~dup)[:, :, None].to(torch.float32)           # (C, S, 1)
    vals = x0.gather(1, il)                                 # (C, S)
    oh0 = _one_hot(vals, D)
    u_cand = torch.arange(D, dtype=torch.int32, device=dev)
    x = x0.clone()
    acc = torch.zeros((C,), dtype=torch.int32, device=dev)

    def delta_correct(base_s, coup_s, vals_cur):
        """base + coupling . (one-hot(current) - one-hot(entry))."""
        delta = (_one_hot(vals_cur, D) - oh0) * nodup       # (C, S, D)
        return base_s + torch.bmm(coup_s[:, None, :], delta)[:, 0]

    at = lambda t, v: t.gather(1, v.long()[:, None])[:, 0]
    for s in range(S):
        i_s = il[:, s:s + 1]
        xi = x.gather(1, i_s)[:, 0]
        same = i == i[:, s:s + 1]                           # (C, S)
        accept = None
        if algo == "gibbs":
            exact_s = delta_correct(parts["exact0"][:, s], parts["wp"][:, s],
                                    vals)
            new_v = gibbs_select(exact_s, g[:, s])
        elif algo == "mgpmh":
            exact_s = delta_correct(parts["exact0"][:, s], parts["wp"][:, s],
                                    vals)
            eps_s = delta_correct(parts["eps0"][:, s], parts["cp"][:, s],
                                  vals)
            v = gibbs_select(eps_s, g[:, s])
            accept = mh_accept(logu[:, s],
                               at(exact_s, v) - at_code(exact_s, xi),
                               at_code(eps_s, xi), at(eps_s, v))
            new_v = torch.where(accept, v, xi)
        elif algo == "min-gibbs":
            # vals_sub[c,u,t]: slot values with candidate u at site i_s
            vals_sub = torch.where(same[:, None, :], u_cand[None, :, None],
                                   vals[:, None, :])        # (C, D, S)
            eps_s = lscale * _global_matches(
                parts["m0"][:, s], parts["n1"][:, s], parts["n2"][:, s],
                vals_sub)                                   # (C, D)
            new_v, cache = min_gibbs_select(eps_s, cache, xi, g[:, s], rows)
        else:  # doublemin
            eps_s = delta_correct(parts["eps0"][:, s], parts["cp"][:, s],
                                  vals)
            v = gibbs_select(eps_s, g[:, s])
            vals_sub = torch.where(same, v[:, None], vals)  # (C, S)
            xi_y = lscale * _global_matches(
                parts["m0"][:, s, 0], parts["n1"][:, s, 0],
                parts["n2"][:, s, 0], vals_sub)
            accept = mh_accept(logu[:, s], xi_y - cache,
                               at_code(eps_s, xi), at(eps_s, v))
            new_v = torch.where(accept, v, xi)
            cache = torch.where(accept, xi_y, cache)
        x.scatter_(1, i_s, new_v[:, None])
        vals = torch.where(same, new_v[:, None], vals)
        if accept is not None:
            acc += accept
    return x, cache, acc


# ---------------------------------------------------------------------------
# Chromatic block schedule against the sharded graph (gibbs only)
# ---------------------------------------------------------------------------

def _class_energies(W, oh):
    """``W @ oh`` per chain as one product: W (n, m), oh (C, m, D) ->
    (n, C, D) (contiguous, for the all-reduce)."""
    C, m, D = oh.shape
    return (W @ oh.permute(1, 0, 2).reshape(m, C * D)).view(-1, C, D)


def make_dist_chromatic_sweep(gs: ShardedMatchGraph, colors,
                              shard: MeshShard):
    """One full chromatic sweep per call against the *sharded* graph:
    every color class updated as a parallel block, one all-reduce per
    class (``n_colors`` collectives per n site updates: the changed-site
    set of a class is O(n), so the S^2-coupling trick of the uniform
    template would need the full W row).

    Per class, in color order, the call draws Gumbels (C_loc, n, D) from
    the shared generator, as :func:`make_chromatic_gibbs_step` does: on
    graphs whose energies are exactly representable (small-integer
    multiples of one weight: every registered lattice workload) the
    sharded sweep is bit-equal to the dense one."""
    colors_t = torch.as_tensor(np.asarray(colors), dtype=torch.int32,
                               device=gs.device)
    n_colors = int(np.asarray(colors).max()) + 1
    n_loc, D, k = gs.n_loc, gs.D, shard.mp_index

    def step(state: DistState) -> DistState:
        x = state.x
        for c in range(n_colors):
            eps = all_reduce(_class_energies(
                gs.W_cols, _one_hot(_x_cols(x, k, n_loc), D)),
                shard.model_group).transpose(0, 1)          # (C, n, D)
            v = gibbs_select(eps, gumbel(eps.shape, state.gen, x.device))
            x = torch.where(colors_t == c, v, x)
        state.marg.add_(_one_hot(_x_cols(x, k, n_loc), D))
        return state._replace(x=x, count=state.count + 1)
    return step


def make_chromatic_gibbs_step(g: MatchGraph, colors):
    """The dense (unsharded) reference of the chromatic dist sweep:
    ``step(x, gen, color)`` updates every site of one color class at once
    (exact for graphs where same-color sites share no factor), drawing
    Gumbels (C, n, D) from ``gen`` as the dist sweep draws them."""
    colors_t = torch.as_tensor(np.asarray(colors), dtype=torch.int32,
                               device=g.device)

    def step(x, gen, color):
        eps = _class_energies(g.W, _one_hot(x, g.D)).transpose(0, 1)
        v = gibbs_select(eps, gumbel(eps.shape, gen, x.device))
        return torch.where(colors_t == color, v, x)
    return step


# ---------------------------------------------------------------------------
# AdaptiveScan under sharding
# ---------------------------------------------------------------------------

def make_dist_adaptive_sweep(gs: ShardedMatchGraph, algo: str, schedule,
                             shard: MeshShard, **params):
    """AdaptiveScan over the distributed template: per-data-shard flip/hit
    counters drive a site-selection table shared by the whole mesh.

    Sites are drawn per data shard from the carried inverse-CDF table with
    uniforms from the shared generator, so all model shards of a data
    shard agree.  Every ``refresh_every``-th call (the host's call counter
    decides: no host sync) the table is rebuilt from the counters of ALL
    chains: the cross-shard reduction rides the call's one all-reduce,
    widened from the model group to the whole mesh.  The refresh consumes
    statistics through the *previous* call (the current call's counters
    need the updated state, which only exists after the all-reduce).
    Between refreshes each segment is a fixed-distribution random-scan
    chain, valid as the single-device AdaptiveScan is."""
    from ..diagnostics.adaptive import refresh_cdf
    inner = make_dist_sweep(gs, algo, schedule.sweep_len, shard, **params)
    n, S, K = gs.n, schedule.sweep_len, schedule.refresh_every
    mix, r0 = schedule.uniform_mix, schedule.smoothing

    def step(ast: DistAdaptiveState) -> DistAdaptiveState:
        st = ast.inner
        C = st.x.shape[0]
        u = torch.rand((C, S), generator=st.gen, device=st.x.device)
        i = inverse_cdf_sites(ast.cdf, u)
        calls = ast.calls + 1
        cdf = ast.cdf
        if calls % K == 0:
            new, (gflips, ghits) = inner(st, sites=i,
                                         ride=(ast.flips, ast.hits))
            cdf = refresh_cdf(gflips, ghits, n, mix, r0)
        else:
            new = inner(st, sites=i)
        flips = ast.flips + (new.x != st.x).sum(0, dtype=torch.float32)
        hits = ast.hits.index_add(0, i.reshape(-1),
                                  torch.ones(i.numel(), device=i.device))
        return DistAdaptiveState(inner=new, cdf=cdf, flips=flips, hits=hits,
                                 calls=calls)
    return step
