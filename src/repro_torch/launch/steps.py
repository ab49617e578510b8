"""Step functions (train / prefill / decode), the counterparts of
``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` in
``repro/launch/steps.py``.  Plain functions: PyTorch runs eagerly, so
nothing is traced or compiled.  The reference's ``kv_chunk`` and ``unroll``
knobs (its scan's TPU tiling and unrolling) have no counterpart: the
attention kernels tile themselves.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..optim.adamw import AdamWState, adamw_update, cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


def _on(x, device) -> torch.Tensor:
    """A batch entry (numpy or tensor) as an int64 tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.int64)


def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    loss_chunk: int = 2048):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss and its gradient (``models.transformer.loss_fn``,
    backward through the flash and selective-scan backward kernels on the
    card), then one AdamW update IN PLACE on ``params`` (a master-form
    ``Transformer``) and ``opt_state``.  With ``cfg.microbatches`` m > 1
    the batch is split into m microbatches along B; their float32
    gradients are summed one microbatch at a time (activations live one
    microbatch at a time) and divided by m, as is the loss.  metrics:
    ``loss`` and ``grad_norm`` as 0-d float32 tensors on the model's
    device (nothing is read back), and ``lr`` (a float).  Any ported
    family: dense GQA, SSM, hybrid."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(params: T.Transformer, opt_state: AdamWState,
                   batch: Dict[str, Any]):
        if not params.master:
            raise ValueError(f"{cfg.name}: training needs the float32 master "
                             f"form (init_params(..., master=True))")
        m = max(1, cfg.microbatches)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        tokens, labels = (_on(batch[k], params.device)
                          for k in ("tokens", "labels"))
        if tokens.shape[0] % m:
            raise ValueError(f"batch {tokens.shape[0]} is not a multiple of "
                             f"{m} microbatches")
        loss = None
        for tk, lb in zip(tokens.chunk(m), labels.chunk(m)):
            lossi = T.loss_fn(cfg, params, {"tokens": tk, "labels": lb},
                              loss_chunk=loss_chunk)
            lossi.backward()
            loss = lossi.detach() if loss is None else loss + lossi.detach()
        grads = {k: p.grad for k, p in named.items()}
        if m > 1:
            torch._foreach_div_(list(grads.values()), m)
            loss = loss / m
        _, opt_state, metrics = adamw_update(
            grads, opt_state, named, lr_fn=lr_fn,
            decay=T.decay_mask(params))
        for p in named.values():
            p.grad = None
        metrics["loss"] = loss
        return params, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> next-token logits (B, vocab_padded)
    float32: one forward pass over batch['tokens'] (B, S), the last
    position's hidden state times the lm head in bf16, widened.  Any ported
    family: dense GQA, SSM (the scan kernel on the card), hybrid."""
    def prefill_step(params: T.Transformer, batch: Dict[str, Any]):
        if batch.get("frontend_embeds") is not None:
            raise NotImplementedError(
                f"{cfg.name}: frontend embeddings (VLM / audio) are not "
                f"ported yet (ROADMAP.md Queue 1 item 10)")
        with torch.no_grad():
            h = T.forward(cfg, params, batch["tokens"])
            return (h[:, -1] @ params.head()).to(torch.float32)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, tokens (B, 1), cache) -> (logits (B,
    vocab_padded) float32, cache): one decode step, the cache (KV ring
    buffers, SSM conv and state) written in place
    (``models.transformer.decode_step``)."""
    def serve_step(params: T.Transformer, tokens, cache):
        return T.decode_step(cfg, params, tokens, cache)
    return serve_step
