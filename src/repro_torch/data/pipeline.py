"""Deterministic synthetic data pipeline: a copy of the JAX package's
``repro/data/pipeline.py`` (numpy only), so the port reads the same batches
byte for byte without importing it.

Design goals for the 1000+-node story:
* **Stateless addressing** — batch contents are a pure function of
  (step, shard_index, num_shards, seed), so any host can reconstruct any
  batch: restart/elastic-reshard never replays or skips data, and there is
  no coordinator.
* **Packed documents** — documents with zipf-ish lengths are packed into
  fixed (B, S) windows with EOS separators and next-token labels (-1 at
  padding), exercising the same label masking a real corpus pipeline needs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["SyntheticTokens", "make_batch"]


class SyntheticTokens:
    """Host-side deterministic token source."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, shard_index: int = 0, num_shards: int = 1,
                 seed: int = 1234, mean_doc_len: int = 512):
        assert global_batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.shard = shard_index
        self.num_shards = num_shards
        self.seed = seed
        self.mean_doc = mean_doc_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """(tokens, labels) for ``step`` on this shard — pure function."""
        rng = np.random.default_rng(
            (self.seed, step, self.shard, self.num_shards))
        B, S = self.local_batch, self.seq
        tokens = np.empty((B, S), np.int32)
        labels = np.empty((B, S), np.int32)
        for b in range(B):
            row = _pack_documents(rng, S, self.vocab, self.mean_doc)
            tokens[b] = row
            labels[b, :-1] = row[1:]
            labels[b, -1] = -1
        return {"tokens": tokens, "labels": labels}


def _pack_documents(rng, seq_len: int, vocab: int, mean_doc: int
                    ) -> np.ndarray:
    eos = 0
    out = np.empty(seq_len, np.int32)
    pos = 0
    while pos < seq_len:
        n = int(np.clip(rng.geometric(1.0 / mean_doc), 8, seq_len - pos))
        out[pos:pos + n] = rng.integers(1, vocab, n)
        pos += n
        if pos < seq_len:
            out[pos] = eos
            pos += 1
    return out


def make_batch(vocab: int, seq: int, batch: int, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """One-shot convenience used by tests/examples."""
    return SyntheticTokens(vocab, seq, batch, seed=seed).batch(step)
