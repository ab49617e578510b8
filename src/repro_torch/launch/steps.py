"""Step functions of the serve path (prefill / decode), the counterparts of
``make_prefill_step`` and ``make_serve_step`` in
``repro/launch/steps.py``.  Plain functions: PyTorch runs eagerly, so
nothing is traced or compiled.  The train step is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> next-token logits (B, vocab_padded)
    float32: one forward pass over batch['tokens'] (B, S), the last
    position's hidden state times the lm head in bf16, widened."""
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
    vocab_padded) float32, cache): one decode step, the cache written in
    place (``models.transformer.decode_step``)."""
    def serve_step(params: T.Transformer, tokens, cache):
        return T.decode_step(cfg, params, tokens, cache)
    return serve_step
