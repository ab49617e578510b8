"""--arch registry: full + smoke configs for every assigned architecture.

A copy of ``repro/configs/registry.py`` without its ``GIBBS_CONFIGS``
alias, which would import the JAX engine registry.  Every architecture is
known here; ``models.transformer`` refuses the families the port does not
run yet.
"""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, SHAPES
from . import (mixtral_8x7b, deepseek_v2_lite_16b, falcon_mamba_7b,
               gemma3_12b, tinyllama_1_1b, h2o_danube3_4b,
               starcoder2_7b, hymba_1_5b, whisper_tiny)

_MODULES = {
    "mixtral-8x7b": mixtral_8x7b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "gemma3-12b": gemma3_12b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "starcoder2-7b": starcoder2_7b,
    "hymba-1.5b": hymba_1_5b,
    "whisper-tiny": whisper_tiny,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKES: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells — 36 total; skipped ones carry the skip
    reason from the config."""
    out = []
    for aname, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            skipped = sname in cfg.skip_shapes
            if skipped and not include_skipped:
                continue
            out.append((aname, sname, skipped))
    return out
