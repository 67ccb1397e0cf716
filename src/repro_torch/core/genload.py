"""Generated-workload stress populations (SPRING-style).

The named zoo suites cover a few dozen real cells; the congruence scores
are only trustworthy if they behave sanely *off* those suites.  Following
SPRING (PAPERS.md), the cheapest way to stress the methodology across the
whole workload space is a randomly generated application population:
``AppSpace`` is the workload-side mirror of ``ParamSpace`` -- a bounded
knob space over per-device compute / bandwidth / collective intensities
that samples ``WorkloadProfile``s instead of machine variants, so an
``(A x V)`` cross-product sweep stresses every layer built on the batched
kernels (scoring, fronts, co-design, packing) with arbitrarily many apps.

Sampling is INDEX-ADDRESSED exactly like ``PopulationStream``: both the
Halton mode (elementwise radical inverse) and the counter-based RNG mode
regenerate any index subset byte-identically to slicing the full draw, so
streamed shards equal the materialized population.

Generated suites travel as strings through the ONE suite grammar
(``repro_torch.core.suites.validate_suite_name`` / ``resolve_suite``):

    gen:<count>[:seed=<int>][:mode=halton|rng]

which makes them accepted everywhere suites are -- ``run_sweep``,
``shard_sweep``, ``evaluate`` and the CLI
(``python -m repro_torch.launch.sweep --gen``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.sweep import Dim, ProfileBatch, halton_at

#: The workload knobs an ``AppSpace`` may vary, in canonical order.
#: Each knob is a scalar per generated app; ``_profile_of_row`` maps a
#: knob row onto ``WorkloadProfile`` fields.
APP_PARAMS = (
    "flops",                 # per-device HLO FLOPs per step
    "intensity",             # arithmetic intensity (FLOPs/byte) -> hbm_bytes
    "collective_fraction",   # collective traffic as a fraction of HBM bytes
    "pod_fraction",          # share of collective bytes crossing the pod axis
    "allreduce_mix",         # all-reduce vs all-to-all split of the traffic
    "log2_devices",          # mesh size as a power of two
    "useful_ratio",          # model_flops / global HLO FLOPs (remat waste)
)

#: Index-addressed sampling modes (both regenerate any index subset).
GEN_MODES = ("halton", "rng")


@dataclasses.dataclass
class AppSpace:
    """Bounded synthetic-workload space over the ``APP_PARAMS`` knobs.

    The workload-side mirror of ``ParamSpace``: ``dims`` maps knob names
    to ``Dim`` ranges and populations are drawn by seeded low-discrepancy
    (Halton) or counter-based RNG sampling, index-addressed either way.

    >>> from repro_torch.core.genload import AppSpace
    >>> space = AppSpace.default()
    >>> pop = space.sample(6, seed=0)
    >>> len(pop), pop.names[0]
    (6, 'gen-00000')
    >>> shard = space.sample_at(range(2, 5), seed=0)
    >>> shard.names == pop.names[2:5]
    True
    >>> bool((shard.flops == pop.flops[2:5]).all())
    True
    """

    dims: Dict[str, Dim]

    def __post_init__(self) -> None:
        for name in self.dims:
            if name not in APP_PARAMS:
                raise KeyError(
                    f"unknown workload knob {name!r}; have {APP_PARAMS}")
        missing = [n for n in APP_PARAMS if n not in self.dims]
        if missing:
            raise KeyError(f"AppSpace is missing knobs {missing}")

    @staticmethod
    def default() -> "AppSpace":
        """Training-shaped stress ranges: three decades of per-device
        FLOPs, intensities from bandwidth-bound to MXU-bound, collective
        shares from negligible to dominant, meshes of 8..4096 chips."""
        return AppSpace(dims={
            "flops": Dim(1e12, 2e15),
            "intensity": Dim(8.0, 2048.0),
            "collective_fraction": Dim(1e-3, 0.5),
            "pod_fraction": Dim(0.0, 0.5, log=False),
            "allreduce_mix": Dim(0.0, 1.0, log=False),
            "log2_devices": Dim(3, 12, log=False, integer=True),
            "useful_ratio": Dim(0.3, 0.95, log=False),
        })

    # ------------------------------------------------------------------ #

    def _unit_at(self, idx: np.ndarray, seed: int, mode: str) -> np.ndarray:
        """``(len(idx), D)`` uniform [0, 1) draws, elementwise in the index.

        Halton rows come from the shared ``halton_at`` (the same rotation
        ``ParamSpace`` uses); RNG rows key a fresh counter-based generator
        on ``(seed, index)`` so row ``i`` never depends on how many other
        rows were drawn -- the property that makes streamed sampling equal
        materialized sampling in BOTH modes.
        """
        d = len(APP_PARAMS)
        if mode == "halton":
            return halton_at(idx, d, seed=seed)
        if mode == "rng":
            out = np.empty((idx.shape[0], d), dtype=np.float64)
            for r, i in enumerate(idx):
                out[r] = np.random.default_rng([seed, int(i)]).random(d)
            return out
        raise ValueError(f"unknown generation mode {mode!r}; have {GEN_MODES}")

    def _profile_of_row(self, index: int, row: Dict[str, float]
                        ) -> WorkloadProfile:
        """One knob row -> a consistent ``WorkloadProfile``.

        Derived rather than independent fields keep every sample
        physically coherent: bytes follow from FLOPs and intensity,
        collective traffic is a fraction of those bytes, and the analytic
        model FLOPs stay below the HLO count (``useful_ratio < 1``).
        """
        flops = row["flops"]
        hbm = flops / row["intensity"]
        coll = row["collective_fraction"] * hbm
        mix = row["allreduce_mix"]
        nd = int(2 ** int(row["log2_devices"]))
        return WorkloadProfile(
            name=f"gen-{index:05d}",
            arch="genload",
            step_kind="train",
            num_devices=nd,
            flops=flops,
            bytes_accessed=hbm,
            hbm_bytes=hbm,
            collective_bytes={"all-reduce": mix * coll,
                              "all-to-all": (1.0 - mix) * coll},
            pod_collective_bytes=row["pod_fraction"] * coll,
            model_flops=row["useful_ratio"] * flops * nd,
        )

    def profiles_at(self, indices, seed: int = 0, mode: str = "halton"
                    ) -> List[WorkloadProfile]:
        """Profiles for the given GLOBAL indices (names carry the index)."""
        idx = np.asarray(list(indices) if not isinstance(indices, np.ndarray)
                         else indices, dtype=np.int64)
        unit = self._unit_at(idx, seed, mode)
        names = list(self.dims)
        cols = {name: self.dims[name].from_unit(unit[:, j])
                for j, name in enumerate(names)}
        return [self._profile_of_row(int(i), {n: float(cols[n][r])
                                              for n in names})
                for r, i in enumerate(idx)]

    def sample_at(self, indices, seed: int = 0, mode: str = "halton"
                  ) -> ProfileBatch:
        """Rows ``indices`` of ``sample(n, seed, mode)`` -- byte-identical
        to slicing the full draw (the streamed == materialized property)."""
        return ProfileBatch.from_profiles(
            self.profiles_at(indices, seed=seed, mode=mode))

    def sample(self, n: int, seed: int = 0, mode: str = "halton"
               ) -> ProfileBatch:
        """``n`` generated apps as a ``ProfileBatch``."""
        return self.sample_at(np.arange(n), seed=seed, mode=mode)


# --------------------------------------------------------------------------- #
# Generated-suite strings (the gen:* arm of the ONE suite grammar)
# --------------------------------------------------------------------------- #

GEN_SUITE_PREFIX = "gen"


def is_gen_suite(suite) -> bool:
    """Cheap dispatch test: does this suite string name a generated suite?"""
    return (isinstance(suite, str)
            and suite.partition(":")[0] == GEN_SUITE_PREFIX)


def parse_gen_suite(suite: str) -> Tuple[int, int, str]:
    """``gen:<count>[:seed=<int>][:mode=halton|rng]`` -> (n, seed, mode).

    >>> from repro_torch.core.genload import parse_gen_suite
    >>> parse_gen_suite("gen:64")
    (64, 0, 'halton')
    >>> parse_gen_suite("gen:32:seed=7:mode=rng")
    (32, 7, 'rng')
    >>> parse_gen_suite("gen")
    Traceback (most recent call last):
        ...
    ValueError: generated suite 'gen' needs a count: gen:<count>[:seed=<int>][:mode=halton|rng]
    """
    grammar = "gen:<count>[:seed=<int>][:mode=halton|rng]"
    if not isinstance(suite, str):
        raise ValueError(f"suite must be a string, got {type(suite).__name__}")
    parts = suite.split(":")
    if parts[0] != GEN_SUITE_PREFIX:
        raise ValueError(f"not a generated suite {suite!r}; expected {grammar}")
    if len(parts) < 2:
        raise ValueError(f"generated suite {suite!r} needs a count: {grammar}")
    try:
        n = int(parts[1])
    except ValueError:
        raise ValueError(f"bad count {parts[1]!r} in generated suite "
                         f"{suite!r}; expected {grammar}") from None
    if n <= 0:
        raise ValueError(f"generated suite count must be positive, got {n}")
    seed, mode = 0, "halton"
    for part in parts[2:]:
        key, sep, value = part.partition("=")
        if not sep or key not in ("seed", "mode"):
            raise ValueError(f"bad option {part!r} in generated suite "
                             f"{suite!r}; expected {grammar}")
        if key == "seed":
            try:
                seed = int(value)
            except ValueError:
                raise ValueError(f"bad seed {value!r} in generated suite "
                                 f"{suite!r}; expected an integer") from None
        else:
            if value not in GEN_MODES:
                raise ValueError(f"unknown generation mode {value!r} in "
                                 f"suite {suite!r}; have {GEN_MODES}")
            mode = value
    return n, seed, mode


def resolve_gen_suite(suite: str) -> List[WorkloadProfile]:
    """Generated-suite string -> profile list (default ``AppSpace``).

    Regeneration is deterministic in the string alone -- the same suite
    name always yields the same profiles, so generated suites memoize and
    micro-batch through the serving front door exactly like zoo suites.
    """
    n, seed, mode = parse_gen_suite(suite)
    return AppSpace.default().profiles_at(np.arange(n), seed=seed, mode=mode)
