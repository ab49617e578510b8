"""Optimizers: AdamW with clipping and a warmup + cosine schedule (the
counterpart of the JAX package's ``repro.optim``)."""
from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]
