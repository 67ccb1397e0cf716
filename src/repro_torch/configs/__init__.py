"""Architecture config registry: ``--arch <id>`` resolution.

Each assigned architecture has one module with the exact published config
(``CONFIG``) plus a reduced same-family smoke config (``SMOKE``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from repro_torch.configs import (
    chatglm3_6b,
    deepseek_67b,
    falcon_mamba_7b,
    grok1_314b,
    paligemma_3b,
    qwen15_4b,
    qwen2_moe_a27b,
    qwen3_32b,
    recurrentgemma_9b,
    whisper_medium,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, tokens_of
from repro_torch.models.config import ModelConfig

_MODULES = (
    chatglm3_6b,
    qwen3_32b,
    qwen15_4b,
    deepseek_67b,
    whisper_medium,
    recurrentgemma_9b,
    grok1_314b,
    qwen2_moe_a27b,
    paligemma_3b,
    falcon_mamba_7b,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    reg = SMOKE_REGISTRY if smoke else REGISTRY
    try:
        return reg[arch]
    except KeyError as exc:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(REGISTRY)}") from exc


def cells(
    archs: Optional[Tuple[str, ...]] = None,
    shapes: Optional[Tuple[str, ...]] = None,
) -> Iterator[Tuple[ModelConfig, ShapeSpec, bool, Optional[str]]]:
    """All (arch x shape) cells: (config, shape, runnable, skip_reason)."""
    for arch in archs or ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in shapes or tuple(SHAPES):
            shape = SHAPES[shape_name]
            ok, reason = applicable(cfg, shape)
            yield cfg, shape, ok, reason


__all__ = [
    "ARCH_IDS",
    "REGISTRY",
    "SHAPES",
    "SMOKE_REGISTRY",
    "ShapeSpec",
    "applicable",
    "cells",
    "get_config",
    "tokens_of",
]
