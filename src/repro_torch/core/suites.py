"""Suite names: the ONE grammar for naming a profile suite by string.

  gen:<count>[:seed=<int>][:mode=halton|rng]   generated stress workloads
                                               (``repro_torch.core.genload``)
  zoo-smoke[:train|serve-prefill|serve-decode] the six smoke profiles of the
                                               model zoo, read from the JSON
                                               files in ``zoo_cache/`` (the
                                               JAX package's extraction)
  zoo[:scenario]                               the full zoo, read from the
                                               port's cache under
                                               ``build/repro_torch/zoo/``
                                               (``core.model_zoo``)

Zoo profiles are read cache-only: a missing entry raises (with the command
that extracts it, for the full zoo) instead of extracting anything.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.genload import (
    is_gen_suite,
    parse_gen_suite,
    resolve_gen_suite,
)

SUITE_BASES = ("zoo", "zoo-smoke")
ZOO_SCENARIOS: Tuple[str, ...] = ("train", "serve-prefill", "serve-decode")

#: The smoke suite's cells in the JAX package's order: architecture, then
#: scenario; each scenario has one (step kind, seq_len, global_batch) shape.
SMOKE_ARCHS: Tuple[str, ...] = ("chatglm3-6b", "falcon-mamba-7b")
_SMOKE_SHAPES = {
    "train": ("train", 128, 8),
    "serve-prefill": ("prefill", 128, 4),
    "serve-decode": ("decode", 128, 8),
}

SMOKE_CACHE_DIR = os.path.join(os.path.dirname(__file__), "zoo_cache")


def parse_suite(suite: str) -> Tuple[bool, Optional[str]]:
    """``zoo[:scenario]`` | ``zoo-smoke[:scenario]`` -> (smoke, scenario)."""
    if not isinstance(suite, str):
        raise ValueError(f"suite must be a string, got {type(suite).__name__}")
    base, sep, scenario = suite.partition(":")
    if base not in SUITE_BASES:
        raise ValueError(
            f"unknown suite {suite!r}; expected "
            f"{' | '.join(SUITE_BASES)} with an optional "
            f":scenario of {ZOO_SCENARIOS}, or a generated suite "
            f"gen:<count>[:seed=<int>][:mode=halton|rng]")
    if sep and scenario not in ZOO_SCENARIOS:
        raise ValueError(
            f"unknown zoo scenario {scenario!r} in suite {suite!r}; "
            f"have {ZOO_SCENARIOS}")
    return base == "zoo-smoke", (scenario if sep else None)


def validate_suite_name(suite: Optional[str]) -> None:
    """Raise ``ValueError`` for a suite string outside the grammar."""
    if suite is None:
        return
    if is_gen_suite(suite):
        parse_gen_suite(suite)
    else:
        parse_suite(suite)


def smoke_cache_paths(scenario: Optional[str] = None,
                      cache_dir: str = SMOKE_CACHE_DIR) -> List[str]:
    """The smoke suite's JSON files, in suite order."""
    scenarios = (scenario,) if scenario else ZOO_SCENARIOS
    paths = []
    for arch in SMOKE_ARCHS:
        for sc in scenarios:
            kind, seq, batch = _SMOKE_SHAPES[sc]
            paths.append(os.path.join(
                cache_dir, f"{arch}__zoo_smoke_{kind}_s{seq}_b{batch}.json"))
    return paths


def resolve_suite(suite: str, *,
                  cache_dir: str = SMOKE_CACHE_DIR) -> List[WorkloadProfile]:
    """Suite name -> profile list.

    Generated suites regenerate deterministically from the string alone;
    ``zoo-smoke`` suites load the checked-in profiles; ``zoo`` suites load
    the port's full-zoo cache (``core.model_zoo.resolve_zoo``).
    """
    if is_gen_suite(suite):
        return resolve_gen_suite(suite)
    smoke, scenario = parse_suite(suite)
    if not smoke:
        from repro_torch.core.model_zoo import resolve_zoo
        return resolve_zoo(scenario)
    out = []
    for path in smoke_cache_paths(scenario, cache_dir):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"zoo cache entry {path} is missing; the port reads the "
                "smoke suite from its checked-in cache only")
        out.append(WorkloadProfile.load(path))
    return out
