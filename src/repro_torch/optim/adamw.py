"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule: the counterpart of ``repro/optim/adamw.py``, as
plain functions over a model's parameter tensors.

The JAX package's optimizer is pure (it returns new trees); here the state
is float32 ``m`` and ``v`` tensors per parameter, keyed by the parameter's
name, and ``adamw_update`` writes the parameters, ``m`` and ``v`` in place
under ``torch.no_grad()`` (the trainer's memory at full width: a copy of
the state per step would add 13 GB).  The arithmetic is the reference's,
operation for operation in float32 (``b1 * m + (1 - b1) * g``, the bias
corrections ``1 - b^step``, ``p - lr * (mh / (sqrt(vh) + eps) + wd * p)``);
each step is a few dozen ``torch._foreach_*`` passes over all the
parameters.  The schedule is computed on the host in float32, so a step
reads nothing back from the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: int                         # updates taken
    m: Dict[str, torch.Tensor]        # first moments, float32, by name
    v: Dict[str, torch.Tensor]        # second moments, float32, by name


def _named(tree) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a mapping or of an ``nn.Module``'s parameters."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def adamw_init(params) -> AdamWState:
    """Zero moments shaped as ``params`` (a module or a name -> tensor
    mapping), float32, on the parameters' devices; step 0."""
    named = _named(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=0, m={k: zeros(p) for k, p in named.items()},
                      v={k: zeros(p) for k, p in named.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, float32, a 0-d tensor on
    the leaves' device (no host sync): each leaf's sum of squares, added in
    the order of sorted names (the reference's tree order)."""
    total = None
    for k in sorted(tree):
        t = tree[k].to(torch.float32)
        sq = torch.sum(t * t)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Mapping[str, torch.Tensor], torch.Tensor]:
    """Scale every leaf IN PLACE by min(1, max_norm / max(norm, 1e-9));
    returns (tree, norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(list(tree.values()), scale)
    return tree, norm


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
    """lr(step): linear warmup to ``base_lr`` over ``warmup_steps``, then a
    cosine from ``base_lr`` to ``min_frac * base_lr`` at ``total_steps``;
    float32 arithmetic in the reference's order, returned as a Python
    float."""
    f32 = np.float32
    warm_div = f32(max(warmup_steps, 1))
    span = f32(max(total_steps - warmup_steps, 1))
    half_amp = f32((1 - min_frac) * 0.5)

    def lr(step: int) -> float:
        s = f32(step)
        if step < warmup_steps:
            return float(f32(base_lr) * s / warm_div)
        t = np.clip((s - f32(warmup_steps)) / span, f32(0.0), f32(1.0))
        cos = f32(base_lr) * (f32(min_frac) + half_amp
                              * (f32(1.0) + np.cos(f32(np.pi) * t)))
        return float(cos)
    return lr


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params, *, lr_fn: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0,
                 decay: Optional[Mapping[str, bool]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step, IN PLACE: ``params`` (a module or name -> tensor
    mapping), ``state.m`` and ``state.v`` are written; ``grads`` (same
    names, float32) are clipped in place.  ``decay[name]`` says which
    parameters take the decoupled weight decay (default: those of two or
    more dimensions, the reference's rule on its leaves).  Returns
    (params by name, the new state, {"grad_norm": 0-d tensor, "lr": float}).
    """
    named = _named(params)
    names = list(named)
    if set(grads) != set(names):
        raise ValueError(f"grads and params name different tensors: "
                         f"{sorted(set(grads) ^ set(names))[:5]}")
    if clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_fn(step)
    b1c = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    b2c = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    p = [named[k] for k in names]
    g = [grads[k].to(torch.float32) for k in names]
    m = [state.m[k] for k in names]
    v = [state.v[k] for k in names]
    # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, gg)
    del gg
    # u = mh / (sqrt(vh) + eps) (+ wd p);  p -= lr u
    u = torch._foreach_div(m, b1c)
    den = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(u, den)
    del den
    if decay is None:
        decay = {k: named[k].dim() >= 2 for k in names}
    dec = [i for i, k in enumerate(names) if decay[k]]
    if weight_decay and dec:
        torch._foreach_add_([u[i] for i in dec],
                            torch._foreach_mul([p[i] for i in dec],
                                               weight_decay))
    torch._foreach_mul_(u, lr)
    torch._foreach_sub_(p, u)
    return named, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                       "lr": lr}
