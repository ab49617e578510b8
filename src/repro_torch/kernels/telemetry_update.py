"""PyTorch wrapper of the fused telemetry-update kernel in
``csrc/telemetry_update.cu``.

One launch per call does the whole streaming update of
``diagnostics.telemetry.telemetry_update_plain`` (both Welford halves, the
K lag sums and the ring slot, the per-site and per-chain counters, the
health guards and the scalars), in place on the carry.  The host keeps
the ring's head, the sample count and the split, so the branches the plain
version takes from them reach the kernel as arguments
(:func:`update_plan`): the kernel reads no device scalar.  Like the sweep
wrappers (``fused_sweep.py``) it checks dtype, shape, contiguity and
device, launches on PyTorch's current stream without synchronising, raises
if the launch was refused, and counts its launches in
``telemetry_update_cuda.launches``.  CUDA tensors only: the CPU path is the
plain version, chosen by ``diagnostics.telemetry.telemetry_update``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fused_sweep import _call

__all__ = ["UpdatePlan", "update_plan", "telemetry_update_cuda",
           "CARRY_FIELDS"]

# the carry's device fields, in the C interface's order
CARRY_FIELDS = ("mean", "m2", "mean_h", "m2_h", "prev", "cross", "cross_n",
                "accepts", "site_prop", "site_acc", "site_flips", "samples",
                "samples_h", "updates", "bad_state", "win_prop", "win_acc")
_INT_MAX = 2 ** 31 - 1
_CHAINS_PER_BLOCK = 4            # kChains; gridDim.y = ceil(C / 4)
_MAX_GRID_Y = 65535
_DELTA_KINDS = {torch.int32: 1, torch.float32: 2}


class UpdatePlan(NamedTuple):
    """The host-side decisions of one update, from the carry's host copies.

    ``count_new``: ``samples`` after the update; ``second``: whether the
    snapshot feeds the second-half Welford pair (``count >= split``);
    ``count_h_new``: ``samples_h`` after the update when ``second`` (0
    otherwise); ``head``: the ring slot of x_{t-1}; ``new_head``: where the
    snapshot goes (slots ``new_head`` and ``new_head + K``); ``live``: the
    lags whose pair count grows, ``min(count, K)``."""
    count_new: int
    second: bool
    count_h_new: int
    head: int
    new_head: int
    live: int


def update_plan(head: int, count: int, split: float, K: int) -> UpdatePlan:
    """The branches of one update of a carry with ring head ``head``,
    ``count`` snapshots so far and second half from snapshot ``split``
    (``inf``: none), at lag depth K.

    ``samples_h`` counts the earlier snapshot indices t < count with
    t >= split, so after this one it is ``count + 1 - max(ceil(split),
    0)``, for a carry from ``telemetry_init`` and for one converted from
    the JAX package (which applies the same rule)."""
    second = count >= split
    count_h = count + 1 - max(math.ceil(split), 0) if second else 0
    return UpdatePlan(count + 1, second, count_h, head, (head - 1) % K,
                      min(count, K))


def _check_input(t, name, dtypes, shape, dev):
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_carry(fields, dev):
    """(C, n, K) of a carry whose fields the kernel takes, or raise."""
    if dev.type != "cuda":
        raise ValueError(f"the telemetry kernel takes a carry on the card, "
                         f"got {dev}; a CPU carry goes through "
                         f"diagnostics.telemetry")
    for name, t in zip(CARRY_FIELDS, fields):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"carry field {name} must be contiguous "
                             f"float32 on {dev}")
    C, n = fields[0].shape
    K = fields[5].shape[0]
    shapes = [tuple(t.shape) for t in fields]
    if (shapes[:4] != [(C, n)] * 4 or shapes[4] != (2 * K, C, n)
            or shapes[5] != (K, C, n) or shapes[6] != (K,)
            or shapes[7] != (C,) or shapes[8:11] != [(n,)] * 3
            or any(sh != () for sh in shapes[11:])):
        raise ValueError(f"the carry's fields have shapes {shapes}, not "
                         f"those of a (C, n) = {(C, n)}, K = {K} carry")
    if C < 1 or n < 1 or -(-C // _CHAINS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"the telemetry kernel takes 1 <= C <= "
                         f"{_CHAINS_PER_BLOCK * _MAX_GRID_Y} chains and "
                         f"n >= 1 sites, got C={C}, n={n}")
    return C, n, K


def telemetry_update_cuda(tel, old_x: torch.Tensor, new_x: torch.Tensor,
                          updates: int, accept_delta=None, stats=None,
                          cache=None, n_values=None, *, decay: float
                          ) -> UpdatePlan:
    """Update the carry ``tel`` (a ``diagnostics.telemetry.Telemetry`` on
    the card) in place from a sweep call that took ``old_x`` to ``new_x``
    in ``updates`` site updates per chain; returns the :class:`UpdatePlan`
    it launched with (the caller moves the carry's ``head`` to
    ``new_head`` and its ``count`` to ``count_new``).

    old_x, new_x (C, n) int32; ``accept_delta`` (C,) int32 or float32 (an
    integer count per chain) or None; ``stats`` None, a ``SweepStats`` of
    (n,) float32 counters, or a ``SiteDraws`` whose ``sites`` (C, S) int32
    the kernel counts (acceptances: the hits, or with ``moves`` the value
    changes it counts as flips); ``cache`` (C,) float32 or None;
    ``n_values`` the site domain size D or None; ``decay`` the windowed
    acceptance's per-call decay (``HEALTH_DECAY``).  Every tensor
    contiguous, on the carry's device.

    Replaces no Pallas kernel: the JAX package computes this update in jnp
    (``src/repro/diagnostics/telemetry.py:125``).  Bound by bytes (~128-144
    MiB per call at potts-64x64, C=256, K=8; ``csrc/telemetry_update.cu``
    has the count).  The plain version's float operations, each rounded as
    ATen rounds it on the card, so the carry's bits equal the plain
    update's.
    """
    fields = [getattr(tel, f) for f in CARRY_FIELDS]
    dev = fields[0].device
    C, n, K = _check_carry(fields, dev)
    _check_input(old_x, "old_x", (torch.int32,), (C, n), dev)
    _check_input(new_x, "new_x", (torch.int32,), (C, n), dev)
    delta_kind, delta = 0, None
    if accept_delta is not None:
        _check_input(accept_delta, "accept_delta", tuple(_DELTA_KINDS), (C,),
                     dev)
        delta_kind, delta = _DELTA_KINDS[accept_delta.dtype], accept_delta
    stats_kind, S, prop, acc, sites = 0, 0, None, None, None
    if stats is not None:
        sites = getattr(stats, "sites", None)
        if sites is None:
            stats_kind, prop, acc = 1, stats.site_prop, stats.site_acc
            _check_input(prop, "stats.site_prop", (torch.float32,), (n,),
                         dev)
            _check_input(acc, "stats.site_acc", (torch.float32,), (n,), dev)
        else:
            stats_kind = 3 if stats.moves else 2
            S = sites.shape[-1] if sites.dim() == 2 else -1
            _check_input(sites, "stats.sites", (torch.int32,), (C, S), dev)
    if cache is not None:
        _check_input(cache, "cache", (torch.float32,), (C,), dev)
    hi = _INT_MAX if n_values is None else min(int(n_values), _INT_MAX)
    plan = update_plan(tel.head, tel.count, tel.split, K)
    ptr = lambda t: None if t is None else t.data_ptr()
    _call("telemetry_update_launch", dev.index,
          [t.data_ptr() for t in fields]
          + [old_x.data_ptr(), new_x.data_ptr(), ptr(delta), ptr(prop),
             ptr(acc), ptr(sites), ptr(cache), C, n, K, plan.head,
             plan.new_head, plan.live, plan.count_new, int(plan.second),
             plan.count_h_new, hi, delta_kind, stats_kind, S,
             float(updates), float(decay)])
    telemetry_update_cuda.launches += 1
    return plan


telemetry_update_cuda.launches = 0
