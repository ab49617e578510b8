"""Mixture-of-Experts layer: top-k routing with capacity-bucketed dispatch,
the counterpart of ``repro/models/moe.py``'s ``router_topk`` and
``moe_ffn``.

Token -> expert assignments are numbered token-major, each one's position
within its expert is an exclusive running count in that order, and those
within the capacity fill fixed (E, capacity, d) buckets; the experts run as
three batched products over the buckets (so only the buckets' rows are
computed), and the results are gathered back with the routing weights.
Assignments past an expert's capacity are dropped (capacity factor 1.25 by
default).  Shared experts (DeepSeek) see every token densely.

Where the port must take care to give the reference's numbers:

* **Top-k ties.** ``jax.lax.top_k`` keeps the lower index first among equal
  values; ``torch.topk`` does not promise an order.  The ids come from a
  stable descending sort, which does on every device.
* **Router logits in true float32**: the product relies on PyTorch's
  default ``torch.backends.cuda.matmul.allow_tf32 = False``, as every
  float32 product of the port does (TF32's 10-bit mantissa would move
  expert choices); a caller that turns TF32 on gives up the reference's
  ids.
* **The combine** is the reference's bf16 scatter-add, k adds in slot order
  each rounded to the activation dtype, not a float32 sum rounded once
  (they differ from k = 3 on); and with no float atomics, so it is
  deterministic on the card.
* **No host sync.** Every shape is a Python int (T, k, E, capacity); the
  dispatch uses no boolean indexing and no ``nonzero``.

The expert products are library GEMMs (``torch.bmm``): the reference
computes them as einsums outside any Pallas kernel.  The sharded dispatch
(``moe_ffn_sharded``) waits for the mesh modules; like the reference with
no ambient mesh, the model always runs ``moe_ffn``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["router_topk", "capacity", "dispatch_slots", "combine",
           "moe_ffn"]


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (weights (T, k) float32, ids (T, k) int32, router probs
    (T, E) float32).  The logits are x and the router widened to float32;
    the k largest probabilities, lower index first among equals, are
    renormalised by max(sum, 1e-9)."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = ranked[..., :top_k], order[..., :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, ids.to(torch.int32), probs


def capacity(T: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Bucket rows per expert: the reference's Python arithmetic."""
    return max(top_k, int(capacity_factor * T * top_k / num_experts))


def dispatch_slots(ids: torch.Tensor, num_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, keep) of the T * k assignments ``ids`` (T, k), numbered
    token-major (t * k + j): an assignment at position p of its expert e
    (an exclusive running count in that order) is kept when p < cap and
    goes to bucket row e * cap + p; a dropped one to row E * cap, the
    discard row."""
    flat = ids.reshape(-1).to(torch.int64)
    experts = torch.arange(num_experts, device=ids.device)
    onehot = (experts[:, None] == flat).to(torch.int32)        # (E, T*k)
    # one running count over the rows laid end to end (a single 1-D scan;
    # a scan down the T*k axis of a (T*k, E) table runs E-wide), then each
    # row less the assignments of the experts before it
    count = torch.cumsum(onehot.view(-1), 0, dtype=torch.int32).view_as(
        onehot) - onehot
    pos_in_e = count - count[:, :1]                            # exclusive
    pos = pos_in_e.gather(0, flat[None, :])[0].to(torch.int64)
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos,
                       torch.full_like(flat, num_experts * cap))
    return slot, keep


def combine(contrib: torch.Tensor) -> torch.Tensor:
    """contrib (T, k, d) -> (T, d): the reference's scatter-add into zeros,
    (0 + c_0) + c_1 + ... in slot order, each add rounded to contrib's
    dtype (0 + c_0 turns a -0 into +0, as there)."""
    out = contrib[:, 0] + 0.0
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], *, top_k: int,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) in x's dtype.  params: router (d, E);
    w_gate / w_up (E, d, ff); w_down (E, ff, d); optionally shared_gate /
    shared_up (d, ff_s) and shared_down (ff_s, d), in the compute dtype."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E = params["router"].shape[-1]
    weights, ids, _ = router_topk(xt, params["router"], top_k)

    # ---- capacity bucketing ----
    cap = capacity(T, top_k, E, capacity_factor)
    slot, keep = dispatch_slots(ids, E, cap)
    src = xt.unsqueeze(1).expand(T, top_k, d).reshape(T * top_k, d)
    buckets = torch.zeros((E * cap + 1, d), dtype=xt.dtype, device=x.device)
    # kept slots are distinct; only the discard row is written twice
    buckets.index_copy_(0, slot, src)
    buckets = buckets[:-1].view(E, cap, d)

    # ---- expert ffn over the buckets ----
    h = F.silu(torch.bmm(buckets, params["w_gate"])) * torch.bmm(
        buckets, params["w_up"])
    out_b = torch.bmm(h, params["w_down"]).view(E * cap, d)

    # ---- gather back, weighted combine over the k slots ----
    gathered = out_b.index_select(0, slot.clamp(max=E * cap - 1))
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * weights.reshape(-1, 1).to(gathered.dtype)
    out = combine(contrib.view(T, top_k, d))

    # ---- shared experts (dense path) ----
    if "shared_gate" in params:
        hs = F.silu(xt @ params["shared_gate"]) * (xt @ params["shared_up"])
        out = out + hs @ params["shared_down"]
    return out.reshape(B, S, d).to(x.dtype)
