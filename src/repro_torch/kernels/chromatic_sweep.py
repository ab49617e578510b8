"""PyTorch wrapper of the chromatic Gibbs class kernel in
``csrc/chromatic_sweep.cu``.

One launch updates one color class of every chain at once: for chain c
and class site i = sites[k], x[c, i] <- argmax_u (sum_j W[i, j]
1[x[c, j] = u] + gumbel(u[c, k, u])), the sum walked over row i's non-zero
entries in the neighbour table ``MatchGraph.nbr_pack`` and the Gumbel made
in the kernel from the class's uniforms, with ``ref.gumbel_from_uniform``'s
operations.  Like the other wrappers (``fused_sweep.py``) it checks its
inputs, launches on PyTorch's current stream without synchronising, raises
if the launch was refused, and counts its launches in
``gibbs_class_sweep_cuda.launches``.  CUDA tensors only: the CPU path is
the plain version, ``ref.gibbs_class_sweep_ref`` fed
``ref.gumbel_from_uniform(u)``, chosen by ``ops.gibbs_class_sweep``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .fused_sweep import _check, _check_cuda, _launch

__all__ = ["gibbs_class_sweep_cuda", "gibbs_class_plan",
           "gumbel_from_uniform_cuda"]


def gibbs_class_sweep_cuda(x, offsets, records, sites, u, *, D: int):
    """One chromatic Gibbs class update of every chain, IN PLACE in ``x``
    (``ref.gibbs_class_sweep_ref`` fed ``ref.gumbel_from_uniform(u)``);
    returns ``x``.

    x (C, n) int32; offsets (n + 1,) int32 and records (nnz, 2) int32, the
    CSR neighbour table of W (``MatchGraph.nbr_pack``: one (j, W[i, j]'s
    float32 bits) record per non-zero, j ascending within a row); sites
    (m,) int32, distinct; u (C, m, D) float32, the class's uniforms as
    ``torch.rand`` draws them (the kernel makes each Gumbel
    ``-log(-log(max(u, tiny)))`` itself, bit for bit as
    ``ref.gumbel_from_uniform``).

    The class is written into ``x`` in place: the kernel writes x[:, sites]
    and reads x only at the sites' neighbours, which no class site is when
    ``sites`` is a color class of a proper coloring
    (``samplers.validate_coloring``), so an update never reads another's
    write.  A sweep therefore copies the state once per call, not once per
    class.

    Replaces ``gibbs_sweep_pallas``
    (``src/repro/kernels/fused_sweep.py:577``) on the chromatic path, where
    the TPU kernel runs a class as |class| sequential sub-steps over dense W
    rows.  Bound by bytes: x, the uniforms, the class rows' records.  A
    block takes a tile of 128 class sites and a group of chains
    (``gibbs_class_plan``): each thread loads its site's row once and walks
    the group's chains; a row of degree above 32 is summed by a whole
    warp.
    """
    C, n = x.shape
    m = sites.shape[0] if sites.dim() == 1 else -1
    D = int(D)
    _check(x, "x", torch.int32, (C, n))
    _check(offsets, "offsets", torch.int32, (n + 1,))
    if records.dim() != 2 or records.shape[1] != 2:
        raise ValueError(f"records must have shape (nnz, 2), got "
                         f"{tuple(records.shape)}")
    _check(records, "records", torch.int32, tuple(records.shape))
    _check(sites, "sites", torch.int32, (m,))
    _check(u, "u", torch.float32, (C, m, D))
    _check_cuda([x, offsets, records, sites, u])
    if D < 1:
        raise ValueError(f"D must be at least 1, got {D}")
    if C == 0 or m == 0:
        return x
    _launch("gibbs_class_sweep_launch", x,
            (x, offsets, records, sites, u, C, n, m, D))
    gibbs_class_sweep_cuda.launches += 1
    return x


gibbs_class_sweep_cuda.launches = 0


def gibbs_class_plan(C: int, m: int, D: int) -> dict:
    """The class launch's shape on the current card: chains a block, site
    tiles (128 sites each), chain groups and resident blocks an SM (the
    grid, tiles x groups, is one wave of the card's resident blocks where
    the chains allow).  Needs the card: the plan asks the CUDA runtime for
    the kernel's occupancy."""
    out = (ctypes.c_int * 4)()
    info = load_library()
    err = info.fns["gibbs_class_plan"](int(C), int(m), int(D),
                                       ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"gibbs_class_plan failed: CUDA error {err} "
                           f"({info.lib.cuda_error_string(err).decode()})")
    return dict(zip(("chains", "tiles", "groups", "blocks_per_sm"), out))


def gumbel_from_uniform_cuda(u):
    """The class kernel's in-kernel Gumbel transform applied to every
    float32 of the CUDA tensor ``u`` (a new tensor): the check that it
    equals ``ref.gumbel_from_uniform`` bit for bit.  Not on any sampler's
    path."""
    _check(u, "u", torch.float32, tuple(u.shape))
    _check_cuda([u])
    g = torch.empty_like(u)
    _launch("gumbel_transform_launch", u, (u, g, u.numel()))
    return g
