"""PyTorch wrappers of the fused sweep kernels in ``csrc/fused_sweep.cu``.

Each wrapper checks dtype, shape, contiguity and device, allocates its
outputs with ``torch.empty``, launches its kernel on PyTorch's current
stream (no synchronisation) and raises if the launch was refused.  It takes
CUDA tensors only: the CPU path is the plain version in ``ref.py``, chosen
by ``ops.py`` from the tensors' device.  ``<wrapper>.launches`` counts the
kernel launches the wrapper made; nothing else touches it but a caller that
resets it.

Site ids must lie in range (the samplers draw them so); the kernels do
not check them.  Poisson totals are clamped to [0, capacity] in-kernel.

The TPU bodies (``_sweep_kernel``, ``_min_gibbs_kernel``,
``_double_min_kernel`` in ``src/repro/kernels/fused_sweep.py``) hold the
whole (n, n) tables in VMEM and gather rows with one-hot matrix products.
On Hopper the tables (64 MiB each at potts-64x64) cannot sit in shared
memory, and a one-hot product would do n times the work of a gather, so the
kernels gather straight from global memory: per sub-step and chain one W
row (4n bytes) and the alias entries the draws land on.  One block per
chain keeps the chain's state in shared memory across all S sub-steps, so
x never round-trips to global memory inside a sweep.  Gibbs and MGPMH
stream each sub-step's W row into shared memory with TMA one sub-step
ahead (one producer warp, one row ring).  MGPMH, MIN-Gibbs and DoubleMIN
read the alias tables as packed 8-byte records
(``core.factor_graph.pack_alias``; MIN-Gibbs and DoubleMIN take four
consecutive draw lanes per thread): a draw's random row entry is one memory
sector where the two tables cost two.  ``chip_smoke.py`` computes each
kernel's bound for its run.

The ``*_rng_cuda`` wrappers take a (1,) int32 ``seed`` tensor on the card
in place of the uniform streams: the kernel draws every uniform, Gumbel and
log-uniform in-kernel with Philox4x32-10 (``philox.py`` has the layout), so
they allocate only their outputs and no stream of C·S·K uniforms exists.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

__all__ = ["gibbs_sweep_cuda", "gibbs_ring_plan", "mgpmh_ring_plan",
           "mgpmh_sweep_cuda", "mgpmh_sweep_rng_cuda",
           "min_gibbs_sweep_cuda", "min_gibbs_sweep_rng_cuda",
           "double_min_sweep_cuda", "double_min_sweep_rng_cuda",
           "reset_launch_counts"]

# dynamic shared memory one block may use (H100: 227 KB)
_MAX_SMEM = 232448


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda(tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA sweep kernels take CUDA tensors, got "
                         f"{dev}; CPU tensors go through kernels.ops")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")


def _check_smem(n: int, D: int, words_per_value: int = 2):
    if 4 * (n + words_per_value * D) + 256 > _MAX_SMEM:
        raise ValueError(f"n={n} sites do not fit one block's shared memory "
                         f"({_MAX_SMEM} bytes)")


def _call(name: str, index: int, args):
    """Launch ``name`` with ``args`` (ints, floats and data pointers, in the
    C order) on the current stream of device ``index``, switching the
    device only when it is not the current one; raises if the launch was
    refused."""
    info = load_library()                  # built and typed once per process
    # the raw cudaStream_t: 0.14 us per call against 3.9 us for
    # torch.cuda.current_stream(index).cuda_stream (scripts/bucket_ab.py,
    # NVIDIA H100 80GB HBM3), where a bucket-energy launch takes 10-20 us
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = info.fns[name](*args, stream)
    else:
        with torch.cuda.device(index):
            err = info.fns[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({info.lib.cuda_error_string(err).decode()})")


def _launch(name: str, x: torch.Tensor, args):
    """``_call`` on x's device; ``args`` are tensors (passed by data
    pointer) and scalars, in the C order."""
    _call(name, x.get_device(),
          [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args])


def _sites(i_sites) -> int:
    return i_sites.shape[1] if i_sites.dim() == 2 else -1


def _check_packs(node_pack, row_pack, n):
    _check(node_pack, "node_pack", torch.int32, (n, 2))
    _check(row_pack, "row_pack", torch.int32, (n, n, 2))


def gibbs_sweep_cuda(x, W, i_sites, gumbel, *, D: int):
    """S fused vanilla-Gibbs site updates per chain (``ref.gibbs_sweep_ref``).

    x (C, n) int32; W (n, n) float32; i_sites (C, S) int32;
    gumbel (C, S, D) float32.  Returns x_out (C, n) int32.

    Replaces ``gibbs_sweep_pallas`` (``src/repro/kernels/fused_sweep.py:577``).
    Bound by bytes: one W row per sub-step and chain.  One block per chain:
    a producer thread keeps the next sub-step's row in flight through a
    ring of two shared-memory stages (1-D TMA copies, one mbarrier pair
    per stage; rows too long for two stages stream as chunks), and
    256 consumer threads sum each staged row into D value buckets in
    registers in one pass, reduce them in a fixed order and take the
    argmax with warp shuffles, one block barrier per sub-step.  W must be
    16-byte aligned (any tensor PyTorch allocates is).
    """
    C, n = x.shape
    S = _sites(i_sites)
    _check(x, "x", torch.int32, (C, n))
    _check(W, "W", torch.float32, (n, n))
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(gumbel, "gumbel", torch.float32, (C, S, D))
    _check_cuda([x, W, i_sites, gumbel])
    _check_smem(n, D)
    _check_tma(W)
    out = torch.empty_like(x)
    if C == 0:
        return out
    _launch("gibbs_sweep_launch", x, (x, W, i_sites, gumbel, out, C, n, S, D))
    gibbs_sweep_cuda.launches += 1
    return out


def _ring_plan(n: int, D: int, mgpmh: bool) -> dict:
    out = (ctypes.c_int * 3)()
    info = load_library()
    err = info.fns["sweep_ring_plan"](int(n), int(D), int(mgpmh),
                                      ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"no ring fits n={n}, D={D}: "
                           f"{info.lib.cuda_error_string(err).decode()}")
    return dict(zip(("chunk", "chunks", "smem"), out))


def gibbs_ring_plan(n: int, D: int) -> dict:
    """The two-stage ring ``gibbs_sweep_cuda`` plans at (n, D): ``chunk``
    (floats of a row per stage), ``chunks`` (per row; 1 = whole rows) and
    ``smem`` (bytes per block).  Builds the library at first use."""
    return _ring_plan(n, D, False)


def mgpmh_ring_plan(n: int, D: int) -> dict:
    """``gibbs_ring_plan`` for ``mgpmh_sweep_cuda`` (and its Philox form),
    whose blocks also hold three buffers of D counts."""
    return _ring_plan(n, D, True)


def _check_tma(W):
    if W.data_ptr() % 16:
        raise ValueError("W must start 16-byte aligned (the kernel copies "
                         "its rows with TMA)")


def _mgpmh_checks(x, W, row_pack, i_sites, B, D, streams=()):
    """The MGPMH wrappers' checks of x, the tables, the sites and totals,
    and (host form) the four streams; returns (C, n, S, K)."""
    C, n = x.shape
    S = _sites(i_sites)
    K = streams[0][0].shape[-1] if streams else None
    _check(x, "x", torch.int32, (C, n))
    _check(W, "W", torch.float32, (n, n))
    _check(row_pack, "row_pack", torch.int32, (n, n, 2))
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(B, "B", torch.int32, (C, S))
    shapes = {"u_idx": (C, S, K), "u_alias": (C, S, K), "gumbel": (C, S, D),
              "logu": (C, S)}
    for t, name in streams:
        _check(t, name, torch.float32, shapes[name])
    _check_smem(n, D)
    _check_tma(W)
    return C, n, S, K


def mgpmh_sweep_cuda(x, W, row_pack, i_sites, B, u_idx, u_alias, gumbel,
                     logu, *, D: int, scale: float):
    """S fused MGPMH site updates per chain (``ref.mgpmh_sweep_ref``, which
    reads the two row tables; here they come as one packed record each).

    x (C, n) int32; W (n, n) float32, 16-byte aligned; row_pack (n, n, 2)
    int32, row i's alias table packed by ``core.factor_graph.pack_alias``
    (``MatchGraph.row_pack``); i_sites/B (C, S) int32; logu (C, S) float32;
    u_idx/u_alias (C, S, K) float32; gumbel (C, S, D) float32.
    ``scale`` = L/lambda.  The sites' values must lie in [0, D).
    Returns (x_out (C, n) int32, accepts (C,) int32).

    Replaces ``mgpmh_sweep_pallas`` (``src/repro/kernels/fused_sweep.py:505``).
    Bound by its sub-steps' latency chain, not by bytes (PERF.md): each
    sub-step reads one W row (the Gibbs kernel's row ring stages it with
    TMA one sub-step ahead) and makes B alias draws, each a dependent
    chain of a uniform, a random 8-byte row record and a state lookup.  One
    pass of 256 consumer threads per sub-step sums the row into D value
    buckets in registers and makes the draws (their record loads issued
    before the row loop, their uniforms one sub-step ahead), counting them
    into integer buckets (order-free, exact); one block barrier, then every
    warp takes the proposal, the exact energies at v and x_i and the
    accept in the first kernel's float order, so the decisions equal the
    plain version's.
    """
    C, n, S, K = _mgpmh_checks(
        x, W, row_pack, i_sites, B, D,
        ((u_idx, "u_idx"), (u_alias, "u_alias"), (gumbel, "gumbel"),
         (logu, "logu")))
    _check_cuda([x, W, row_pack, i_sites, B, u_idx, u_alias, gumbel, logu])
    out = torch.empty_like(x)
    acc = torch.empty((C,), dtype=torch.int32, device=x.device)
    if C == 0:
        return out, acc
    _launch("mgpmh_sweep_launch", x,
            (x, W, row_pack, i_sites, B, u_idx, u_alias, gumbel, logu, out,
             acc, C, n, S, K, D, float(scale)))
    mgpmh_sweep_cuda.launches += 1
    return out, acc


def mgpmh_sweep_rng_cuda(x, W, row_pack, i_sites, B, seed, *, D: int,
                         scale: float, K: int):
    """``mgpmh_sweep_cuda`` with in-kernel Philox uniforms
    (``ref.mgpmh_sweep_rng_ref``): ``seed`` (1,) int32 on the card replaces
    u_idx, u_alias, gumbel and logu; K is the capacity.
    Returns (x_out (C, n) int32, accepts (C,) int32).

    Replaces ``mgpmh_sweep_pallas_rng``
    (``src/repro/kernels/fused_sweep.py:542``).  The MGPMH body of
    ``mgpmh_sweep_cuda`` instantiated with the Philox source: each
    uniform, Gumbel and log-uniform is one Philox4x32-10 call (~100 int32
    operations), computed a sub-step ahead where the host form loads it;
    like the host form it is bound by its sub-steps' latency chain.
    """
    C, n, S, _ = _mgpmh_checks(x, W, row_pack, i_sites, B, D)
    _check(seed, "seed", torch.int32, (1,))
    _check_cuda([x, W, row_pack, i_sites, B, seed])
    out = torch.empty_like(x)
    acc = torch.empty((C,), dtype=torch.int32, device=x.device)
    if C == 0:
        return out, acc
    _launch("mgpmh_sweep_rng_launch", x,
            (x, W, row_pack, i_sites, B, seed, out, acc, C, n, S, int(K), D,
             float(scale)))
    mgpmh_sweep_rng_cuda.launches += 1
    return out, acc


def _min_gibbs_checks(x, node_pack, row_pack, i_sites, B, cache, D):
    C, n = x.shape
    S = _sites(i_sites)
    _check(x, "x", torch.int32, (C, n))
    _check_packs(node_pack, row_pack, n)
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(B, "B", torch.int32, (C, S, D))
    _check(cache, "cache", torch.float32, (C,))
    _check_smem(n, D, words_per_value=3)
    return C, n, S


def min_gibbs_sweep_cuda(x, node_pack, row_pack, i_sites, B, u_node, u_nacc,
                         u_row, u_racc, gumbel, cache, *, D: int,
                         lscale: float):
    """S fused MIN-Gibbs site updates per chain
    (``ref.min_gibbs_sweep_ref``, which reads the unpacked tables).

    x (C, n) int32; node_pack (n, 2) / row_pack (n, n, 2) int32, the node
    and row alias tables packed by ``core.factor_graph.pack_alias``;
    i_sites (C, S) int32; B (C, S, D) int32; u_node/u_nacc/u_row/u_racc
    (C, S, D, K) float32; gumbel (C, S, D) float32; cache (C,) float32.
    ``lscale`` = log1p(Psi/lam).
    Returns (x_out (C, n) int32, cache_out (C,) float32).

    Replaces ``min_gibbs_sweep_pallas``
    (``src/repro/kernels/fused_sweep.py:605``, body ``_min_gibbs_kernel``).
    Bound by bytes: per live draw 16 bytes of uniforms and one random
    8-byte row record (the node records stay in cache); the card's
    random-gather rate, not the bound, sets its time
    (``scripts/pair_draw_ab.py``, PERF.md).  One block of 512 threads per
    chain walks a sub-step's D*K lanes in one flat loop, four consecutive
    lanes per thread (one 16-byte load per stream where D*K % 4 == 0; four
    independent gather chains), skips the records of dead lanes
    (k >= B[c, s, u]) and counts matches in warp-aggregated shared
    counters.
    """
    C, n, S = _min_gibbs_checks(x, node_pack, row_pack, i_sites, B, cache,
                                D)
    K = u_node.shape[-1]
    for t, name in ((u_node, "u_node"), (u_nacc, "u_nacc"), (u_row, "u_row"),
                    (u_racc, "u_racc")):
        _check(t, name, torch.float32, (C, S, D, K))
    _check(gumbel, "gumbel", torch.float32, (C, S, D))
    _check_cuda([x, node_pack, row_pack, i_sites, B, u_node, u_nacc, u_row,
                 u_racc, gumbel, cache])
    out = torch.empty_like(x)
    cache_out = torch.empty_like(cache)
    if C == 0:
        return out, cache_out
    _launch("min_gibbs_sweep_launch", x,
            (x, node_pack, row_pack, i_sites, B, u_node, u_nacc, u_row,
             u_racc, gumbel, cache, out, cache_out, C, n, S, K, D,
             float(lscale)))
    min_gibbs_sweep_cuda.launches += 1
    return out, cache_out


def min_gibbs_sweep_rng_cuda(x, node_pack, row_pack, i_sites, B, cache, seed,
                             *, D: int, lscale: float, K: int):
    """``min_gibbs_sweep_cuda`` with in-kernel Philox uniforms
    (``ref.min_gibbs_sweep_rng_ref``): ``seed`` (1,) int32 on the card
    replaces the four (C, S, D, K) streams and the Gumbels; B stays an
    input.  Returns (x_out (C, n) int32, cache_out (C,) float32).

    Replaces ``min_gibbs_sweep_pallas_rng``
    (``src/repro/kernels/fused_sweep.py:650``).  The MIN-Gibbs body with
    the Philox source: a thread's four lanes take the four words of one
    Philox4x32-10 call per stream (the counter is lane // 4), beside the
    same random row-record gathers, which set its time.  Allocates only
    x_out and cache_out: at potts-64x64's default lam the host form's
    streams would be 45 GB at C=256, S=64.
    """
    C, n, S = _min_gibbs_checks(x, node_pack, row_pack, i_sites, B, cache,
                                D)
    _check(seed, "seed", torch.int32, (1,))
    _check_cuda([x, node_pack, row_pack, i_sites, B, cache, seed])
    out = torch.empty_like(x)
    cache_out = torch.empty_like(cache)
    if C == 0:
        return out, cache_out
    _launch("min_gibbs_sweep_rng_launch", x,
            (x, node_pack, row_pack, i_sites, B, cache, seed, out, cache_out,
             C, n, S, int(K), D, float(lscale)))
    min_gibbs_sweep_rng_cuda.launches += 1
    return out, cache_out


def _double_min_checks(x, row_pack, node_pack, i_sites, B1, B2, cache, D):
    C, n = x.shape
    S = _sites(i_sites)
    _check(x, "x", torch.int32, (C, n))
    _check_packs(node_pack, row_pack, n)
    _check(i_sites, "i_sites", torch.int32, (C, S))
    _check(B1, "B1", torch.int32, (C, S))
    _check(B2, "B2", torch.int32, (C, S))
    _check(cache, "cache", torch.float32, (C,))
    _check_smem(n, D, words_per_value=3)
    return C, n, S


def _double_min_outputs(x, cache):
    return (torch.empty_like(x), torch.empty_like(cache),
            torch.empty((x.shape[0],), dtype=torch.int32, device=x.device))


def double_min_sweep_cuda(x, row_pack, node_pack, i_sites, B1, u_idx,
                          u_alias, gumbel, B2, u_node, u_nacc, u_row, u_racc,
                          logu, cache, *, D: int, scale1: float,
                          lscale2: float):
    """S fused DoubleMIN site updates per chain
    (``ref.double_min_sweep_ref``, which reads the unpacked tables).

    x (C, n) int32; row_pack (n, n, 2) / node_pack (n, 2) int32, the packed
    row and node alias tables (``core.factor_graph.pack_alias``);
    i_sites/B1/B2 (C, S) int32; u_idx/u_alias (C, S, K1) float32; gumbel
    (C, S, D); u_node/u_nacc/u_row/u_racc (C, S, K2) float32; logu (C, S);
    cache (C,).  ``scale1`` = L/lam1, ``lscale2`` = log1p(Psi/lam2).
    Returns (x_out (C, n) int32, cache_out (C,) float32, accepts (C,) int32).

    Replaces ``double_min_sweep_pallas``
    (``src/repro/kernels/fused_sweep.py:687``, body ``_double_min_kernel``).
    Bound by bytes: per sub-step B1 local draws (MGPMH's stage 1, no exact
    pass) and B2 two-stage pair draws, 16 bytes of uniforms and one random
    8-byte row record each.  One block of 512 threads per chain; the B2
    pair draws go four consecutive lanes per thread, count matches in
    registers and reduce once per sub-step; the accept test uses the
    cached estimate, so no W row is read.
    """
    C, n, S = _double_min_checks(x, row_pack, node_pack, i_sites, B1, B2,
                                 cache, D)
    K1 = u_idx.shape[-1]
    K2 = u_node.shape[-1]
    _check(u_idx, "u_idx", torch.float32, (C, S, K1))
    _check(u_alias, "u_alias", torch.float32, (C, S, K1))
    _check(gumbel, "gumbel", torch.float32, (C, S, D))
    for t, name in ((u_node, "u_node"), (u_nacc, "u_nacc"), (u_row, "u_row"),
                    (u_racc, "u_racc")):
        _check(t, name, torch.float32, (C, S, K2))
    _check(logu, "logu", torch.float32, (C, S))
    _check_cuda([x, row_pack, node_pack, i_sites, B1, u_idx, u_alias, gumbel,
                 B2, u_node, u_nacc, u_row, u_racc, logu, cache])
    out, cache_out, acc = _double_min_outputs(x, cache)
    if C == 0:
        return out, cache_out, acc
    _launch("double_min_sweep_launch", x,
            (x, row_pack, node_pack, i_sites, B1, u_idx, u_alias, gumbel, B2,
             u_node, u_nacc, u_row, u_racc, logu, cache, out, cache_out, acc,
             C, n, S, K1, K2, D, float(scale1), float(lscale2)))
    double_min_sweep_cuda.launches += 1
    return out, cache_out, acc


def double_min_sweep_rng_cuda(x, row_pack, node_pack, i_sites, B1, B2, cache,
                              seed, *, D: int, scale1: float, lscale2: float,
                              K1: int, K2: int):
    """``double_min_sweep_cuda`` with in-kernel Philox uniforms
    (``ref.double_min_sweep_rng_ref``): ``seed`` (1,) int32 on the card
    replaces the proposal, Gumbel, second-batch and MH streams; B1, B2 stay
    inputs.  Returns (x_out, cache_out, accepts).

    Replaces ``double_min_sweep_pallas_rng``
    (``src/repro/kernels/fused_sweep.py:739``).  The DoubleMIN body with the
    Philox source: the pair draws take one Philox4x32-10 call per stream
    and four lanes, the local draws one per uniform, beside the same
    random row-record gathers.  Allocates only its three outputs.
    """
    C, n, S = _double_min_checks(x, row_pack, node_pack, i_sites, B1, B2,
                                 cache, D)
    _check(seed, "seed", torch.int32, (1,))
    _check_cuda([x, row_pack, node_pack, i_sites, B1, B2, cache, seed])
    out, cache_out, acc = _double_min_outputs(x, cache)
    if C == 0:
        return out, cache_out, acc
    _launch("double_min_sweep_rng_launch", x,
            (x, row_pack, node_pack, i_sites, B1, B2, cache, seed, out,
             cache_out, acc, C, n, S, int(K1), int(K2), D, float(scale1),
             float(lscale2)))
    double_min_sweep_rng_cuda.launches += 1
    return out, cache_out, acc


WRAPPERS = (gibbs_sweep_cuda, mgpmh_sweep_cuda, mgpmh_sweep_rng_cuda,
            min_gibbs_sweep_cuda, min_gibbs_sweep_rng_cuda,
            double_min_sweep_cuda, double_min_sweep_rng_cuda)


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
