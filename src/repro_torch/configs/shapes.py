"""Assigned input shapes (identical across the 10 LM-family architectures).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token with a KV cache
of seq_len), not ``train_step``.  ``long_500k`` requires sub-quadratic
sequence mixing: it runs for the SSM/hybrid archs and is skipped (with the
reason recorded) for pure full-attention archs -- see DESIGN.md §5.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# --- model-zoo grid -------------------------------------------------------
#
# The zoo suite (core/model_zoo.py) profiles every registry config under
# three serving scenarios.  Each scenario maps to a step kind plus a small
# (seq_len, global_batch) grid; the full grid gives
# 10 archs x 3 scenarios x 4 shapes = 120 cells, the smoke grid one tiny
# single-device shape per scenario so the fast CI tier can recompile it.

ZOO_SCENARIOS: Tuple[str, ...] = ("train", "serve-prefill", "serve-decode")

_SCENARIO_KIND: Dict[str, str] = {
    "train": "train",
    "serve-prefill": "prefill",
    "serve-decode": "decode",
}

_ZOO_GRID: Dict[str, Tuple[Tuple[int, int], ...]] = {
    # scenario -> ((seq_len, global_batch), ...)
    "train": ((2_048, 64), (2_048, 256), (8_192, 64), (8_192, 256)),
    # prefill batches must split across the 16-way pod data axis
    "serve-prefill": ((4_096, 16), (4_096, 64), (32_768, 16), (32_768, 64)),
    "serve-decode": ((4_096, 32), (4_096, 256), (32_768, 32), (32_768, 256)),
}

_ZOO_SMOKE_GRID: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "train": ((128, 8),),
    "serve-prefill": ((128, 4),),
    "serve-decode": ((128, 8),),
}


def scenario_kind(scenario: str) -> str:
    """Step kind (train|prefill|decode) for a zoo scenario name."""
    try:
        return _SCENARIO_KIND[scenario]
    except KeyError:
        raise ValueError(
            f"unknown zoo scenario {scenario!r}; "
            f"expected one of {sorted(_SCENARIO_KIND)}") from None


def zoo_shapes(scenario: str, *, smoke: bool = False) -> Tuple[ShapeSpec, ...]:
    """ShapeSpecs for one zoo scenario (the batch/seq grid)."""
    kind = scenario_kind(scenario)
    grid = (_ZOO_SMOKE_GRID if smoke else _ZOO_GRID)[scenario]
    prefix = "zoo_smoke" if smoke else "zoo"
    return tuple(
        ShapeSpec(f"{prefix}_{kind}_s{seq}_b{batch}", seq, batch, kind)
        for seq, batch in grid
    )


def resolve_shape(name: str) -> ShapeSpec:
    """Look up a shape by name across SHAPES and the zoo grids."""
    if name in SHAPES:
        return SHAPES[name]
    for smoke in (False, True):
        for scenario in ZOO_SCENARIOS:
            for shape in zoo_shapes(scenario, smoke=smoke):
                if shape.name == name:
                    return shape
    known = sorted(SHAPES) + [
        s.name for sc in ZOO_SCENARIOS
        for smoke in (False, True) for s in zoo_shapes(sc, smoke=smoke)
    ]
    raise KeyError(f"unknown shape {name!r}; known: {', '.join(known)}")


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, Optional[str]]:
    """Whether this (arch, shape) cell is runnable, else the skip reason."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "full-attention architecture: 500k dense-KV decode is "
            "O(seq) per token with an unbounded window; assigned-shape rules "
            "direct skipping pure full-attention archs"
        )
    return True, None


def tokens_of(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Token count processed by one step (for MODEL_FLOPS)."""
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one new token per sequence
