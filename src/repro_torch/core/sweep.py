"""Vectorized design-space sweep engine (paper §III at population scale).

The paper's central economics: packing/placement/routing (for us: the XLA
compile) is paid once per application, after which re-timing an architecture
variant is pure arithmetic.  The scalar DSE loop in ``dse`` walks
(app, variant, subsystem) cells one at a time in Python, which wastes that
cheapness.  This module re-states the whole pipeline --
``subsystem_times`` -> ``step_time`` -> Eq. 1 ``congruence_score`` ->
aggregate (paper §II-B, §III-C) -- as struct-of-arrays passes with shape
``(A, V)`` (apps x variants), so sweeping a million machine designs costs a
handful of kernel launches.

The port of the JAX package's sweep engine: the same populations (host-side
NumPy float64, byte-identical to the JAX package's), the same extractions,
and the ``(A, V)`` scoring on a ``repro_torch`` backend -- the Hopper
kernels by default, the plain torch version with ``device="cpu"``.

Three layers:

  ParamSpace     -- bounded design space over the machine-model constants
                    (``peak_flops``, ``hbm_bw``, ``ici_bw``, ``ici_links``,
                    ``inter_pod_bw``, per-subsystem ``scale``); generates
                    populations by full grid or low-discrepancy (Halton)
                    random sampling, the paper's "denser / densest" axis
                    extended to a continuous sweep.
  MachineBatch / ProfileBatch
                 -- struct-of-arrays packings of ``MachineModel`` /
                    ``WorkloadProfile`` (one float64 array per field).
  batched_*      -- thin wrappers over a ``repro_torch.core.kernels_xp``
                    backend: ``"cuda"`` (the kernels, float32; default on
                    a CUDA device) or ``"torch"`` (the plain version,
                    float64; default with ``device="cpu"``).

``SweepResult`` holds the full score tensor plus the DSE extractions the
paper's Table I points at: per-app best-fit variants (lowest aggregate =
smallest radar area, §III-C), the 2-D Pareto front of aggregate congruence
vs. silicon area, and the 3-D front over (congruence, area, power) via the
configurable ``repro_torch.core.costmodel.CostModel`` (the PPA trade-off of
§I).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import kernels_xp as K
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.machine import (
    IDEAL_EPS,
    MachineModel,
    Subsystem,
    TPU_V5E,
)

# The machine-model constants a sweep may vary, in canonical order.
SWEEP_PARAMS = (
    "peak_flops",
    "hbm_bw",
    "ici_bw",
    "ici_links",
    "inter_pod_bw",
    "scale_compute",
    "scale_memory",
    "scale_interconnect",
)


# --------------------------------------------------------------------------- #
# ParamSpace: grid + low-discrepancy population generators
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Dim:
    """One bounded sweep dimension.

    ``log=True`` spaces points geometrically -- hardware rates span decades,
    so a log grid is the natural "denser / densest" ladder.  ``integer``
    rounds to whole values (link counts).
    """

    lo: float
    hi: float
    log: bool = True
    integer: bool = False

    def points(self, k: int) -> np.ndarray:
        """``k`` grid points across the range (deduplicated if integer)."""
        if k <= 1:
            pts = np.array([self.hi if self.integer else
                            float(np.sqrt(self.lo * self.hi)) if self.log
                            else 0.5 * (self.lo + self.hi)])
        elif self.log:
            pts = np.geomspace(self.lo, self.hi, k)
        else:
            pts = np.linspace(self.lo, self.hi, k)
        if self.integer:
            pts = np.unique(np.rint(pts))
        return pts.astype(np.float64)

    def from_unit(self, u: np.ndarray) -> np.ndarray:
        """Map uniform [0, 1) samples onto the dimension's range."""
        u = np.asarray(u, dtype=np.float64)
        if self.integer:
            lo, hi = int(round(self.lo)), int(round(self.hi))
            return np.clip(np.floor(lo + (hi - lo + 1) * u), lo, hi)
        if self.log:
            return self.lo * (self.hi / self.lo) ** u
        return self.lo + (self.hi - self.lo) * u


_HALTON_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _radical_inverse(index: np.ndarray, base: int) -> np.ndarray:
    """Van der Corput radical inverse of ``index`` in ``base`` (vectorized)."""
    idx = np.asarray(index, dtype=np.int64).copy()
    inv = np.zeros(idx.shape, dtype=np.float64)
    frac = 1.0 / base
    while np.any(idx > 0):
        inv += frac * (idx % base)
        idx //= base
        frac /= base
    return inv


def halton_at(indices, d: int, seed: int = 0) -> np.ndarray:
    """Rows ``indices`` of the seeded Halton sequence, shape ``(len, d)``.

    The radical inverse is elementwise in the index, so any subset of rows
    is byte-identical to slicing ``halton(n, d, seed)`` -- the property
    that lets ``PopulationStream`` regenerate an arbitrary shard of a
    mega-sweep population without materializing the rest.
    """
    if d > len(_HALTON_PRIMES):
        raise ValueError(f"halton supports at most {len(_HALTON_PRIMES)} dims")
    idx = np.asarray(indices, dtype=np.int64)
    shifts = np.random.default_rng(seed).random(d)
    out = np.empty((idx.shape[0], d), dtype=np.float64)
    for j in range(d):
        out[:, j] = (_radical_inverse(idx + 1, _HALTON_PRIMES[j])
                     + shifts[j]) % 1.0
    return out


def halton(n: int, d: int, seed: int = 0) -> np.ndarray:
    """``(n, d)`` low-discrepancy points in [0, 1).

    Halton sequence with a seeded Cranley-Patterson rotation so different
    seeds give different (still low-discrepancy) populations.
    """
    return halton_at(np.arange(n), d, seed=seed)


@dataclasses.dataclass
class ParamSpace:
    """Bounded machine design space around a ``nominal`` machine.

    ``dims`` maps a subset of ``SWEEP_PARAMS`` to ``Dim`` ranges; parameters
    not present stay pinned at the nominal machine's value.

    Example -- the default space sweeps every rate 4x below/above the
    nominal chip and generates populations by Halton sampling or full grid:

    >>> from repro_torch.core import ParamSpace
    >>> space = ParamSpace.default(span=2.0, max_links=4)
    >>> pop = space.sample(8, seed=0)            # low-discrepancy draw
    >>> len(pop)
    8
    >>> d = space.dims["peak_flops"]
    >>> bool((pop.peak_flops >= d.lo).all() and (pop.peak_flops <= d.hi).all())
    True
    >>> grid = space.grid({"peak_flops": 3, "ici_links": 2})
    >>> len(grid)                                # 3 x 2 cross-product
    6
    """

    dims: Dict[str, Dim]
    nominal: MachineModel = TPU_V5E

    def __post_init__(self) -> None:
        for name in self.dims:
            if name not in SWEEP_PARAMS:
                raise KeyError(
                    f"unknown sweep parameter {name!r}; have {SWEEP_PARAMS}")

    @staticmethod
    def default(nominal: MachineModel = TPU_V5E, span: float = 4.0,
                max_links: int = 8) -> "ParamSpace":
        """The paper's density ladder as a continuous space: every rate swept
        geometrically ``span``x below/above the nominal chip, link count up
        to ``max_links``."""
        dims = {
            "peak_flops": Dim(nominal.peak_flops / span, nominal.peak_flops * span),
            "hbm_bw": Dim(nominal.hbm_bw / span, nominal.hbm_bw * span),
            "ici_bw": Dim(nominal.ici_bw / span, nominal.ici_bw * span),
            "ici_links": Dim(1, max_links, log=False, integer=True),
            "inter_pod_bw": Dim(nominal.inter_pod_bw / span,
                                nominal.inter_pod_bw * span),
        }
        return ParamSpace(dims=dims, nominal=nominal)

    @staticmethod
    def scale_space(nominal: MachineModel = TPU_V5E, span: float = 4.0,
                    max_links: int = 8, scale_span: float = 4.0
                    ) -> "ParamSpace":
        """``default()`` plus the per-subsystem idealization scales as
        swept dimensions (``scale_span``x below/above 1.0) -- the
        stress-test preset that exercises every ``SWEEP_PARAMS`` column
        at once.

        >>> space = ParamSpace.scale_space(scale_span=2.0)
        >>> sorted(space.dims) == sorted(SWEEP_PARAMS)
        True
        >>> space.dims["scale_compute"].lo
        0.5
        """
        space = ParamSpace.default(nominal=nominal, span=span,
                                   max_links=max_links)
        dims = dict(space.dims)
        for name in ("scale_compute", "scale_memory", "scale_interconnect"):
            dims[name] = Dim(1.0 / scale_span, scale_span)
        return ParamSpace(dims=dims, nominal=nominal)

    # ------------------------------------------------------------------ #

    def _nominal_value(self, name: str) -> float:
        if name.startswith("scale_"):
            return self.nominal.scale_for(Subsystem(name[len("scale_"):]))
        return float(getattr(self.nominal, name))

    def _columns_to_batch(self, cols: Dict[str, np.ndarray], n: int,
                          prefix: str) -> "MachineBatch":
        return self._columns_to_batch_at(cols, np.arange(n), prefix)

    def _columns_to_batch_at(self, cols: Dict[str, np.ndarray], indices,
                             prefix: str) -> "MachineBatch":
        """Pack generated columns, naming rows by their GLOBAL indices --
        so a regenerated shard carries the same names as the full batch."""
        idx = np.asarray(indices, dtype=np.int64)
        full = {}
        for name in SWEEP_PARAMS:
            if name in cols:
                full[name] = np.asarray(cols[name], dtype=np.float64)
            else:
                full[name] = np.full(idx.shape[0], self._nominal_value(name))
        return MachineBatch(
            names=[f"{prefix}{i:05d}" for i in idx], **full)

    def grid_axes(self, points: Union[int, Mapping[str, int]] = 3
                  ) -> Dict[str, np.ndarray]:
        """Per-dimension grid point arrays (the factors of ``grid``'s
        cross-product), WITHOUT materializing the product itself."""
        if isinstance(points, int):
            points = {name: points for name in self.dims}
        return {name: self.dims[name].points(k) for name, k in points.items()
                if name in self.dims}

    def grid(self, points: Union[int, Mapping[str, int]] = 3) -> "MachineBatch":
        """Full cross-product grid.

        ``points`` is either a per-dimension count mapping or one count
        applied to every dimension in the space.
        """
        axes = self.grid_axes(points)
        names = list(axes)
        combos = list(itertools.product(*(axes[n] for n in names)))
        cols = {n: np.array([c[i] for c in combos], dtype=np.float64)
                for i, n in enumerate(names)}
        return self._columns_to_batch(cols, len(combos), "grid-")

    def grid_at(self, indices, points: Union[int, Mapping[str, int]] = 3
                ) -> "MachineBatch":
        """Rows ``indices`` of ``grid(points)`` without building the grid.

        ``itertools.product`` emits combinations in row-major order, so row
        ``i`` unravels to per-dimension positions by mixed-radix division --
        an O(len(indices)) computation regardless of the grid's size.
        """
        axes = self.grid_axes(points)
        names = list(axes)
        lens = [len(axes[n]) for n in names]
        idx = np.asarray(indices, dtype=np.int64)
        cols = {}
        stride = 1
        strides = [0] * len(names)
        for j in range(len(names) - 1, -1, -1):
            strides[j] = stride
            stride *= lens[j]
        for j, n in enumerate(names):
            cols[n] = axes[n][(idx // strides[j]) % lens[j]]
        return self._columns_to_batch_at(cols, idx, "grid-")

    def sample(self, n: int, seed: int = 0) -> "MachineBatch":
        """``n`` low-discrepancy (Halton) samples across every dimension."""
        return self.sample_at(np.arange(n), seed=seed)

    def sample_at(self, indices, seed: int = 0) -> "MachineBatch":
        """Rows ``indices`` of ``sample(n, seed)`` -- byte-identical to
        slicing the full draw (``halton_at`` is elementwise in the index),
        which is what lets streamed mega-sweeps regenerate any shard."""
        names = list(self.dims)
        idx = np.asarray(indices, dtype=np.int64)
        unit = halton_at(idx, len(names), seed=seed)
        cols = {name: self.dims[name].from_unit(unit[:, j])
                for j, name in enumerate(names)}
        return self._columns_to_batch_at(cols, idx, "sweep-")


# --------------------------------------------------------------------------- #
# Struct-of-arrays packings
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class MachineBatch:
    """``V`` machine variants as one float64 array per model constant."""

    names: List[str]
    peak_flops: np.ndarray
    hbm_bw: np.ndarray
    ici_bw: np.ndarray
    ici_links: np.ndarray
    inter_pod_bw: np.ndarray
    scale_compute: np.ndarray
    scale_memory: np.ndarray
    scale_interconnect: np.ndarray

    def __len__(self) -> int:
        return len(self.names)

    @property
    def ici_bw_total(self) -> np.ndarray:
        return self.ici_bw * self.ici_links

    def scale_for(self, subsystem: Subsystem) -> np.ndarray:
        return {
            Subsystem.COMPUTE: self.scale_compute,
            Subsystem.MEMORY: self.scale_memory,
            Subsystem.INTERCONNECT: self.scale_interconnect,
        }[subsystem]

    @staticmethod
    def from_models(models: Sequence[MachineModel]) -> "MachineBatch":
        arr = lambda get: np.array([get(m) for m in models], dtype=np.float64)
        return MachineBatch(
            names=[m.name for m in models],
            peak_flops=arr(lambda m: m.peak_flops),
            hbm_bw=arr(lambda m: m.hbm_bw),
            ici_bw=arr(lambda m: m.ici_bw),
            ici_links=arr(lambda m: m.ici_links),
            inter_pod_bw=arr(lambda m: m.inter_pod_bw),
            scale_compute=arr(lambda m: m.scale_for(Subsystem.COMPUTE)),
            scale_memory=arr(lambda m: m.scale_for(Subsystem.MEMORY)),
            scale_interconnect=arr(lambda m: m.scale_for(Subsystem.INTERCONNECT)),
        )

    @staticmethod
    def concat(*batches: "MachineBatch") -> "MachineBatch":
        cat = lambda get: np.concatenate([get(b) for b in batches])
        return MachineBatch(
            names=[n for b in batches for n in b.names],
            peak_flops=cat(lambda b: b.peak_flops),
            hbm_bw=cat(lambda b: b.hbm_bw),
            ici_bw=cat(lambda b: b.ici_bw),
            ici_links=cat(lambda b: b.ici_links),
            inter_pod_bw=cat(lambda b: b.inter_pod_bw),
            scale_compute=cat(lambda b: b.scale_compute),
            scale_memory=cat(lambda b: b.scale_memory),
            scale_interconnect=cat(lambda b: b.scale_interconnect),
        )

    def slice(self, lo: int, hi: int) -> "MachineBatch":
        """Contiguous sub-batch ``[lo, hi)`` (one shard of a sharded sweep)."""
        sel = {name: getattr(self, name)[lo:hi] for name in SWEEP_PARAMS}
        return MachineBatch(names=self.names[lo:hi], **sel)

    def take(self, indices) -> "MachineBatch":
        """Arbitrary sub-batch by variant index (Pareto-survivor gathers)."""
        idx = np.asarray(indices, dtype=np.int64)
        sel = {name: getattr(self, name)[idx] for name in SWEEP_PARAMS}
        return MachineBatch(names=[self.names[i] for i in idx], **sel)

    def model(self, i: int) -> MachineModel:
        """Materialize variant ``i`` as a scalar ``MachineModel``."""
        return MachineModel(
            name=self.names[i],
            peak_flops=float(self.peak_flops[i]),
            hbm_bw=float(self.hbm_bw[i]),
            ici_bw=float(self.ici_bw[i]),
            ici_links=int(self.ici_links[i]),
            inter_pod_bw=float(self.inter_pod_bw[i]),
            scale={
                Subsystem.COMPUTE.value: float(self.scale_compute[i]),
                Subsystem.MEMORY.value: float(self.scale_memory[i]),
                Subsystem.INTERCONNECT.value: float(self.scale_interconnect[i]),
            },
        )

    def models(self) -> List[MachineModel]:
        return [self.model(i) for i in range(len(self))]

    def area(self, reference: MachineModel = TPU_V5E) -> np.ndarray:
        """Relative silicon/cost proxy per variant (see ``CostModel.area``;
        the default equal-weight model is used, matching the historical
        four-rate-mean proxy exactly)."""
        return CostModel(reference=reference).area(self)

    def arrays(self) -> K.MachineArrays:
        """The kernel-layer view: one ``MachineArrays`` namedtuple."""
        return K.MachineArrays(
            peak_flops=self.peak_flops,
            hbm_bw=self.hbm_bw,
            ici_bw=self.ici_bw,
            ici_links=self.ici_links,
            inter_pod_bw=self.inter_pod_bw,
            scale_compute=self.scale_compute,
            scale_memory=self.scale_memory,
            scale_interconnect=self.scale_interconnect,
        )

    def select(self, i: int) -> "MachineBatch":
        """Single-variant sub-batch (used as the default-beta reference)."""
        sel = {name: getattr(self, name)[i:i + 1] for name in SWEEP_PARAMS}
        return MachineBatch(names=[self.names[i]], **sel)

    def params_row(self, i: int) -> Dict[str, float]:
        return {name: float(getattr(self, name)[i]) for name in SWEEP_PARAMS}


@dataclasses.dataclass
class ProfileBatch:
    """``A`` workload profiles packed into the arrays the timing model reads.

    ``mem_bytes`` applies the scalar path's fallback (``hbm_bytes`` when
    positive, else raw ``bytes_accessed``) at pack time.
    """

    names: List[str]
    flops: np.ndarray
    mem_bytes: np.ndarray
    collective_bytes: np.ndarray
    pod_collective_bytes: np.ndarray
    model_flops: np.ndarray
    num_devices: np.ndarray
    profiles: List[WorkloadProfile]

    def __len__(self) -> int:
        return len(self.names)

    @staticmethod
    def from_profiles(profiles: Sequence[WorkloadProfile]) -> "ProfileBatch":
        profiles = list(profiles)
        return ProfileBatch(
            names=[p.name for p in profiles],
            flops=np.array([p.flops for p in profiles], dtype=np.float64),
            mem_bytes=np.array(
                [p.hbm_bytes if p.hbm_bytes > 0 else p.bytes_accessed
                 for p in profiles], dtype=np.float64),
            collective_bytes=np.array(
                [p.total_collective_bytes for p in profiles], dtype=np.float64),
            pod_collective_bytes=np.array(
                [p.pod_collective_bytes for p in profiles], dtype=np.float64),
            model_flops=np.array(
                [p.model_flops for p in profiles], dtype=np.float64),
            num_devices=np.array(
                [p.num_devices for p in profiles], dtype=np.float64),
            profiles=profiles,
        )

    def arrays(self) -> K.ProfileArrays:
        """The kernel-layer view: one ``ProfileArrays`` namedtuple."""
        return K.ProfileArrays(
            flops=self.flops,
            mem_bytes=self.mem_bytes,
            collective_bytes=self.collective_bytes,
            pod_collective_bytes=self.pod_collective_bytes,
            model_flops=self.model_flops,
            num_devices=self.num_devices,
        )

    @staticmethod
    def concat(*batches: "ProfileBatch") -> "ProfileBatch":
        """Concatenate suites along the app axis (micro-batch admission)."""
        cat = lambda get: np.concatenate([get(b) for b in batches])
        return ProfileBatch(
            names=[n for b in batches for n in b.names],
            flops=cat(lambda b: b.flops),
            mem_bytes=cat(lambda b: b.mem_bytes),
            collective_bytes=cat(lambda b: b.collective_bytes),
            pod_collective_bytes=cat(lambda b: b.pod_collective_bytes),
            model_flops=cat(lambda b: b.model_flops),
            num_devices=cat(lambda b: b.num_devices),
            profiles=[p for b in batches for p in b.profiles],
        )

    def take(self, indices) -> "ProfileBatch":
        """Sub-suite by app index (micro-batch scatter)."""
        idx = [int(i) for i in indices]
        return ProfileBatch(
            names=[self.names[i] for i in idx],
            flops=self.flops[idx],
            mem_bytes=self.mem_bytes[idx],
            collective_bytes=self.collective_bytes[idx],
            pod_collective_bytes=self.pod_collective_bytes[idx],
            model_flops=self.model_flops[idx],
            num_devices=self.num_devices[idx],
            profiles=[self.profiles[i] for i in idx],
        )


def _as_profile_batch(profiles) -> ProfileBatch:
    if isinstance(profiles, str):
        # Suite name ("gen:64", "zoo-smoke:train", ...): every entry point
        # that packs profiles accepts the suites by name.
        from repro_torch.core.suites import resolve_suite

        profiles = resolve_suite(profiles)
    if isinstance(profiles, ProfileBatch):
        return profiles
    return ProfileBatch.from_profiles(list(profiles))


def _as_machine_batch(machines) -> MachineBatch:
    if isinstance(machines, MachineBatch):
        return machines
    return MachineBatch.from_models(list(machines))


# --------------------------------------------------------------------------- #
# Batched timing + congruence -- thin wrappers over a kernels_xp backend
# --------------------------------------------------------------------------- #


def batched_step_time(
    profiles, machines, timing_model: str = "serial",
    backend: Optional[str] = None, device=K.DEFAULT_DEVICE,
) -> np.ndarray:
    """``(A, V)`` step-time matrix -- vectorized ``timing.step_time``
    (kernel K2 on the ``cuda`` backend)."""
    pb, mb = _as_profile_batch(profiles), _as_machine_batch(machines)
    be = K.get_backend(backend, device)
    return be.to_numpy(be.step_time(pb.arrays(), mb.arrays(), timing_model))


def default_beta_batched(
    profiles, machines, beta_ref: int = 0,
    backend: Optional[str] = None, device=K.DEFAULT_DEVICE,
) -> np.ndarray:
    """Vectorized ``congruence.default_beta`` against variant ``beta_ref``.

    The paper's beta is a per-application user target held constant across
    variants (Table I compares architectures against one target), so the
    default derives from a single reference variant -- by convention the
    first ("baseline") column, matching ``dse.evaluate``.  Kernel K3 on the
    ``cuda`` backend.
    """
    pb, mb = _as_profile_batch(profiles), _as_machine_batch(machines)
    be = K.get_backend(backend, device)
    return be.to_numpy(
        be.default_beta(pb.arrays(), mb.select(beta_ref).arrays()))


def _has_nan(*keys) -> bool:
    return any(np.isnan(k).any() for k in keys)


def pareto_front_indices(area, aggregate) -> List[int]:
    """Indices on the 2-D (area, aggregate) Pareto front, both minimized.

    Sorted by increasing area; a point is admitted only when it strictly
    improves the best aggregate seen so far, so no returned point is
    dominated by any input point.  Shared by ``SweepResult.pareto_front``
    and the per-shard pre-filter in ``shard_sweep``.
    """
    area = np.asarray(area)
    aggregate = np.asarray(aggregate)
    if _has_nan(area, aggregate):
        # sorted() on the key tuple, as the reference: with a NaN key it
        # is no total order, and lexsort would place the NaN elsewhere
        order = np.array(sorted(range(len(area)),
                                key=lambda i: (area[i], aggregate[i])),
                         dtype=np.int64)
    else:
        # stable lexicographic (area, aggregate) order, as sorted() with a key
        order = np.lexsort((aggregate, area))
    agg = aggregate[order]
    # admitted = strictly below the running minimum of everything before it
    prev_best = np.fmin.accumulate(np.concatenate(([np.inf], agg[:-1])))
    return [int(i) for i in order[agg < prev_best]]


def pareto_front_indices_3d(aggregate, area, power) -> List[int]:
    """Indices on the 3-D (aggregate, area, power) front, all minimized.

    The lexicographic (area, power, aggregate) sort guarantees every
    potential dominator of a point precedes it, so checking new points
    against accepted front members is sufficient.  Sorted by increasing
    area.
    """
    aggregate = np.asarray(aggregate)
    area = np.asarray(area)
    power = np.asarray(power)
    if _has_nan(area, power, aggregate):
        order = sorted(range(len(area)),
                       key=lambda i: (area[i], power[i], aggregate[i]))
    else:
        order = np.lexsort((aggregate, power, area))
    # the accepted front's coordinates, grown in place: one vectorized
    # dominance test per candidate instead of a Python loop over the front
    fa = np.empty(len(order))
    fp = np.empty(len(order))
    fg = np.empty(len(order))
    front: List[int] = []
    for i in order:
        k = len(front)
        a, p, g = area[i], power[i], aggregate[i]
        le = (fa[:k] <= a) & (fp[:k] <= p) & (fg[:k] <= g)
        lt = (fa[:k] < a) | (fp[:k] < p) | (fg[:k] < g)
        if not (le & lt).any():
            fa[k], fp[k], fg[k] = a, p, g
            front.append(int(i))
    return front


@dataclasses.dataclass
class SweepResult:
    """Full ``(A, V)`` score tensor plus the Table I / Pareto extractions."""

    profiles: ProfileBatch
    machines: MachineBatch
    timing_model: str
    eps: float
    clamp: bool
    beta: np.ndarray                 # (A,) per-app target
    gamma: np.ndarray                # (A, V) baseline step times
    alphas: Dict[str, np.ndarray]    # subsystem value -> (A, V)
    scores: Dict[str, np.ndarray]    # ICS/HRCS/LBCS -> (A, V)
    aggregate: np.ndarray            # (A, V) L2 magnitudes
    backend: str = "torch"           # kernel backend that produced the tensors

    # ------------------------------ lookups --------------------------- #

    @property
    def apps(self) -> List[str]:
        return list(self.profiles.names)

    @property
    def variant_names(self) -> List[str]:
        return list(self.machines.names)

    def app_index(self, app: str) -> int:
        return self.profiles.names.index(app)

    # --------------------------- extractions -------------------------- #

    def best_fit_indices(self) -> np.ndarray:
        """Per-app argmin over variants (lowest aggregate = best fit)."""
        return np.argmin(self.aggregate, axis=1)

    def best_fit(self, app: str) -> str:
        return self.machines.names[int(
            np.argmin(self.aggregate[self.app_index(app)]))]

    def aggregate_mean(self) -> np.ndarray:
        """Suite-mean aggregate per variant (Table I bottom row), shape (V,)."""
        return self.aggregate.mean(axis=0)

    def area(self, reference: MachineModel = TPU_V5E) -> np.ndarray:
        return self.machines.area(reference)

    def power(self, cost_model: CostModel = DEFAULT_COST_MODEL) -> np.ndarray:
        """Relative dynamic-power proxy per variant (``CostModel.power``)."""
        return cost_model.power(self.machines)

    def pareto_front(self, reference: MachineModel = TPU_V5E) -> List[int]:
        """Variant indices on the (area, mean aggregate) Pareto front.

        Both axes are minimized: cheaper silicon and better congruence fit.
        Returned sorted by increasing area; no returned point is dominated
        by any variant in the sweep.
        """
        return pareto_front_indices(self.area(reference),
                                    self.aggregate_mean())

    def pareto_front_3d(
        self, cost_model: CostModel = DEFAULT_COST_MODEL
    ) -> List[int]:
        """Variant indices on the (mean aggregate, area, power) Pareto front.

        All three objectives are minimized -- the full PPA trade-off of
        paper §I, with congruence standing in for "performance fit".
        Returned sorted by increasing area.
        """
        return pareto_front_indices_3d(self.aggregate_mean(),
                                       cost_model.area(self.machines),
                                       cost_model.power(self.machines))

    def top_variants(self, k: int = 10) -> List[int]:
        """Variant indices with the lowest suite-mean aggregate."""
        order = np.argsort(self.aggregate_mean(), kind="stable")
        return [int(i) for i in order[:k]]

    def seed_codesign(self, k: Optional[int] = None,
                      cost_model: CostModel = DEFAULT_COST_MODEL,
                      ) -> MachineBatch:
        """Pareto survivors as a warm-start seed for gradient co-design.

        The sweep answers "which sampled designs win?"; its winners are
        the natural SEEDS for the continuous co-design descents.  Returns the
        union of the 2-D and 3-D Pareto fronts (under ``cost_model``) plus
        every per-app best fit, deduplicated, ordered by suite-mean
        aggregate, optionally truncated to the best ``k``.

        >>> from repro_torch.core import WorkloadProfile, run_sweep
        >>> apps = [WorkloadProfile(name="app0", flops=2e14,
        ...                         hbm_bytes=1.5e11,
        ...                         collective_bytes={"all-reduce": 2e10},
        ...                         num_devices=256, model_flops=5e16)]
        >>> res = run_sweep(apps, n=64, seed=0, device="cpu")
        >>> seeds = res.seed_codesign(k=4)
        >>> 1 <= len(seeds) <= 4
        True
        >>> set(seeds.names) <= set(res.variant_names)
        True
        """
        agg = self.aggregate_mean()
        survivors = set(pareto_front_indices(cost_model.area(self.machines),
                                             agg))
        survivors.update(self.pareto_front_3d(cost_model))
        survivors.update(int(i) for i in self.best_fit_indices())
        order = sorted(survivors, key=lambda i: (agg[i], i))
        if k is not None:
            order = order[:k]
        return self.machines.take(order)

    def frontier(self, budgets, k: Optional[int] = None,
                 cost_model: CostModel = DEFAULT_COST_MODEL, **kwargs):
        """Trace the feasibility frontier J*(budget) from this sweep.

        The sweep's Pareto survivors (``seed_codesign``) warm-start
        ``repro_torch.core.frontier.frontier_codesign`` over the same
        profile suite -- global exploration hands its winners to the
        budget continuation.  ``kwargs`` forward to ``frontier_codesign``
        (``power_budget=``, ``area_envelope=``, ``steps=``, ``device=``,
        ...).
        """
        from repro_torch.core.frontier import frontier_codesign
        return frontier_codesign(
            self.profiles, self.seed_codesign(k=k, cost_model=cost_model),
            budgets, cost_model=cost_model, **kwargs)

    # ----------------------------- reports ---------------------------- #

    def markdown(self, top_k: Optional[int] = None,
                 cost_model: CostModel = DEFAULT_COST_MODEL) -> str:
        """Top-``top_k`` variants by suite-mean aggregate + both fronts.

        ``top_k=None`` means the default of 10 -- part of the uniform
        result protocol (every result type exposes ``markdown(top_k=...)``
        / ``to_json(top_k=...)``)."""
        top_k = 10 if top_k is None else top_k
        area = self.area()
        power = self.power(cost_model)
        agg = self.aggregate_mean()
        front = set(self.pareto_front())
        front3 = self.pareto_front_3d(cost_model)
        best_counts = np.bincount(self.best_fit_indices(),
                                  minlength=len(self.machines))
        lines = [
            f"sweep: {len(self.profiles)} apps x {len(self.machines)} "
            f"variants ({self.timing_model} timing, {self.backend} backend)",
            "",
            "| variant | mean aggregate | area | power | best-fit apps "
            "| pareto | peak_flops | hbm_bw | ici_bw x links "
            "| inter_pod_bw |",
            "|---" * 10 + "|",
        ]
        for i in self.top_variants(top_k):
            m = self.machines
            lines.append(
                f"| {m.names[i]} | {agg[i]:.4f} | {area[i]:.3f} "
                f"| {power[i]:.3f} "
                f"| {int(best_counts[i])} | {'*' if i in front else ''} "
                f"| {m.peak_flops[i]:.3e} | {m.hbm_bw[i]:.3e} "
                f"| {m.ici_bw[i]:.3e} x {int(m.ici_links[i])} "
                f"| {m.inter_pod_bw[i]:.3e} |")
        lines += ["", f"pareto front ({len(front)} variants, by area):", ""]
        for i in self.pareto_front():
            lines.append(
                f"- {self.machines.names[i]}: area={area[i]:.3f} "
                f"aggregate={agg[i]:.4f}")
        lines += ["", f"3-D pareto front (congruence x area x power, "
                      f"{len(front3)} variants, by area):", ""]
        for i in front3:
            lines.append(
                f"- {self.machines.names[i]}: area={area[i]:.3f} "
                f"power={power[i]:.3f} aggregate={agg[i]:.4f}")
        return "\n".join(lines)

    def to_json(self, top_k: Optional[int] = None,
                cost_model: CostModel = DEFAULT_COST_MODEL) -> dict:
        """JSON-serializable sweep summary (full score tensor omitted unless
        the sweep is small -- at 10k variants the matrix dwarfs the summary)."""
        area = self.area()
        power = self.power(cost_model)
        agg = self.aggregate_mean()
        front = self.pareto_front()
        best_idx = self.best_fit_indices()
        top = self.top_variants(top_k if top_k is not None
                                else min(len(self.machines), 32))
        out = {
            "num_apps": len(self.profiles),
            "num_variants": len(self.machines),
            "timing_model": self.timing_model,
            "backend": self.backend,
            "clamp": self.clamp,
            "apps": self.apps,
            "best_fit": {app: self.machines.names[int(best_idx[a])]
                         for a, app in enumerate(self.apps)},
            "beta_s": {app: float(self.beta[a])
                       for a, app in enumerate(self.apps)},
            "pareto_front": [
                {"variant": self.machines.names[i],
                 "area": float(area[i]),
                 "mean_aggregate": float(agg[i]),
                 "params": self.machines.params_row(i)}
                for i in front],
            "pareto_front_3d": [
                {"variant": self.machines.names[i],
                 "area": float(area[i]),
                 "power": float(power[i]),
                 "mean_aggregate": float(agg[i]),
                 "params": self.machines.params_row(i)}
                for i in self.pareto_front_3d(cost_model)],
            "top_variants": [
                {"variant": self.machines.names[i],
                 "area": float(area[i]),
                 "power": float(power[i]),
                 "mean_aggregate": float(agg[i]),
                 "best_fit_apps": [
                     app for a, app in enumerate(self.apps)
                     if int(best_idx[a]) == i],
                 "params": self.machines.params_row(i)}
                for i in top],
        }
        if len(self.machines) * len(self.profiles) <= 4096:
            out["aggregate"] = self.aggregate.tolist()
            out["scores"] = {k: v.tolist() for k, v in self.scores.items()}
        return out

    # --------------------------- micro-batching ----------------------- #

    def app_slice(self, indices) -> "SweepResult":
        """Sub-result over a subset of app rows.

        Every kernel quantity is app-rowwise independent (each row is one
        app's profile scored against every variant), so slicing rows of a
        merged multi-suite sweep is byte-identical to running the sweep on
        the sub-suite directly -- the invariant micro-batched serving
        rests on.
        """
        idx = [int(i) for i in indices]
        return SweepResult(
            profiles=self.profiles.take(idx),
            machines=self.machines,
            timing_model=self.timing_model,
            eps=self.eps,
            clamp=self.clamp,
            beta=self.beta[idx],
            gamma=self.gamma[idx],
            alphas={k: v[idx] for k, v in self.alphas.items()},
            scores={k: v[idx] for k, v in self.scores.items()},
            aggregate=self.aggregate[idx],
            backend=self.backend,
        )


def batched_congruence(
    profiles,
    machines,
    *,
    beta=None,
    beta_ref: int = 0,
    timing_model: str = "serial",
    eps: float = IDEAL_EPS,
    clamp: bool = False,
    backend: Optional[str] = None,
    device=K.DEFAULT_DEVICE,
) -> SweepResult:
    """Vectorized ``profile_congruence`` over the full (apps x variants) grid.

    One ``kernels_xp.congruence_kernel`` pass computes gamma, all three
    alphas, the Eq. 1 scores and the L2 aggregates as ``(A, V)`` arrays --
    the paper's per-subsystem idealization loop becomes three scale
    substitutions on precomputed raw terms.

    ``beta`` may be None (per-app default derived from variant ``beta_ref``,
    matching ``dse.evaluate``), a scalar applied to every app, or an ``(A,)``
    array of per-app targets.  ``backend`` selects the kernel backend
    (``"cuda"``/``"torch"``, default by ``device``: kernels K1 and K3 on
    the card); the result tensors are always NumPy.
    """
    pb, mb = _as_profile_batch(profiles), _as_machine_batch(machines)
    if len(mb) == 0:
        raise ValueError("batched_congruence needs at least one machine variant")
    be = K.get_backend(backend, device)

    if beta is None:
        beta_vec = be.to_numpy(
            be.default_beta(pb.arrays(), mb.select(beta_ref).arrays()))
    else:
        beta_vec = np.broadcast_to(
            np.asarray(beta, dtype=np.float64), (len(pb),)).copy()

    out = be.congruence(pb.arrays(), mb.arrays(), beta_vec,
                        timing_model=timing_model, eps=eps, clamp=clamp)

    alphas = {
        Subsystem.COMPUTE.value: be.to_numpy(out.alpha_compute),
        Subsystem.MEMORY.value: be.to_numpy(out.alpha_memory),
        Subsystem.INTERCONNECT.value: be.to_numpy(out.alpha_interconnect),
    }
    scores = {
        "LBCS": be.to_numpy(out.lbcs),
        "HRCS": be.to_numpy(out.hrcs),
        "ICS": be.to_numpy(out.ics),
    }

    return SweepResult(
        profiles=pb,
        machines=mb,
        timing_model=timing_model,
        eps=eps,
        clamp=clamp,
        beta=beta_vec,
        gamma=be.to_numpy(out.gamma),
        alphas=alphas,
        scores=scores,
        aggregate=be.to_numpy(out.aggregate),
        backend=be.name,
    )


def _population(space: ParamSpace, n: int, mode: str, seed: int,
                include_named: Sequence[MachineModel]) -> MachineBatch:
    """The population ``run_sweep`` and ``shard_sweep`` share.

    Kept in one place so a sharded sweep scores the exact same variants
    (names included) as the single-device sweep it replaces.
    """
    if mode == "random":
        pop = space.sample(n, seed=seed)
    elif mode == "grid":
        per_dim = max(2, int(np.ceil(n ** (1.0 / max(len(space.dims), 1)))))
        pop = space.grid(per_dim)
    else:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if include_named:
        pop = MachineBatch.concat(MachineBatch.from_models(include_named), pop)
    return pop


# --------------------------------------------------------------------------- #
# Streamed populations: V >> RAM without ever holding the full MachineBatch
# --------------------------------------------------------------------------- #


class PopulationStream:
    """Index-addressable population source for mega-sweeps.

    ``_population`` materializes all ``V`` variants up front -- fine to a
    few million, fatal at 100M+.  A stream instead REGENERATES any index
    range on demand: Halton rows are elementwise in the sample index
    (``ParamSpace.sample_at``) and grid rows unravel by mixed-radix
    division (``grid_at``), so ``batch(lo, hi)`` for any shard is
    byte-identical to ``_population(...)[lo:hi]`` while only that shard
    ever exists in memory.  Named models (the paper's baseline ladder) are
    prepended exactly as ``_population`` prepends them.

    ``load_population`` returns the second flavor: fields memory-mapped
    from a ``save_population`` directory, for populations generated
    elsewhere (or expensive spaces worth generating once).

    >>> from repro_torch.core import ParamSpace
    >>> from repro_torch.core.sweep import PopulationStream, _population
    >>> space = ParamSpace.default()
    >>> stream = PopulationStream(space, 1000, seed=3)
    >>> full = _population(space, 1000, "random", 3, [])
    >>> shard = stream.batch(400, 500)
    >>> shard.names == full.names[400:500]
    True
    >>> bool((shard.peak_flops == full.peak_flops[400:500]).all())
    True
    """

    def __init__(self, space: ParamSpace, n: int, mode: str = "random",
                 seed: int = 0,
                 include_named: Sequence[MachineModel] = ()):
        self.space = space
        self.mode = mode
        self.seed = seed
        self._n_request = n
        self._named_models = list(include_named)
        self.named = (MachineBatch.from_models(self._named_models)
                      if self._named_models else None)
        if mode == "random":
            self._grid_points = None
            self._gen_n = int(n)
        elif mode == "grid":
            per_dim = max(2, int(np.ceil(
                n ** (1.0 / max(len(space.dims), 1)))))
            self._grid_points = per_dim
            lens = [len(a) for a in space.grid_axes(per_dim).values()]
            self._gen_n = int(np.prod(lens)) if lens else 1
        else:
            raise ValueError(f"unknown sweep mode {mode!r}")
        self._fields = None  # set by _from_dir for the memory-mapped flavor
        self._names_arr = None

    @classmethod
    def _from_dir(cls, path: str) -> "PopulationStream":
        obj = cls.__new__(cls)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        obj.space = None
        obj.mode = "mmap"
        obj.seed = 0
        obj._n_request = int(meta["num_variants"])
        obj._named_models = []
        obj.named = None
        obj._grid_points = None
        obj._gen_n = int(meta["num_variants"])
        obj._fields = {
            name: np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
            for name in SWEEP_PARAMS}
        obj._names_arr = np.load(os.path.join(path, "names.npy"),
                                 mmap_mode="r")
        obj.path = path
        return obj

    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        k = len(self.named) if self.named is not None else 0
        return k + self._gen_n

    @property
    def num_named(self) -> int:
        return len(self.named) if self.named is not None else 0

    def _generated(self, idx: np.ndarray) -> MachineBatch:
        """Generated rows by 0-based GENERATED index (named rows excluded)."""
        if self._fields is not None:
            sel = {name: np.asarray(arr[idx], dtype=np.float64)
                   for name, arr in self._fields.items()}
            return MachineBatch(
                names=[str(n) for n in self._names_arr[idx]], **sel)
        if self.mode == "random":
            return self.space.sample_at(idx, seed=self.seed)
        return self.space.grid_at(idx, self._grid_points)

    def batch(self, lo: int, hi: int) -> MachineBatch:
        """Contiguous ``[lo, hi)`` slice -- one shard of a streamed sweep."""
        k = self.num_named
        parts = []
        if lo < k:
            parts.append(self.named.slice(lo, min(hi, k)))
        if hi > k:
            parts.append(self._generated(np.arange(max(lo - k, 0), hi - k)))
        return parts[0] if len(parts) == 1 else MachineBatch.concat(*parts)

    def take(self, indices) -> MachineBatch:
        """Arbitrary rows by global index (the survivor re-score gather)."""
        idx = np.asarray(indices, dtype=np.int64)
        k = self.num_named
        if k == 0:
            return self._generated(idx)
        named_mask = idx < k
        if named_mask.all():
            return self.named.take(idx)
        if not named_mask.any():
            return self._generated(idx - k)
        named_part = self.named.take(idx[named_mask])
        gen_part = self._generated(idx[~named_mask] - k)
        pos_named = np.nonzero(named_mask)[0]
        pos_gen = np.nonzero(~named_mask)[0]
        fields = {}
        for name in SWEEP_PARAMS:
            col = np.empty(idx.shape[0], dtype=np.float64)
            col[pos_named] = getattr(named_part, name)
            col[pos_gen] = getattr(gen_part, name)
            fields[name] = col
        names: List[str] = [""] * idx.shape[0]
        for j, nm in zip(pos_named, named_part.names):
            names[j] = nm
        for j, nm in zip(pos_gen, gen_part.names):
            names[j] = nm
        return MachineBatch(names=names, **fields)

    def materialize(self) -> MachineBatch:
        """The full batch (smoke-scale equality tests; do NOT call at 100M)."""
        if self._fields is not None:
            return self.batch(0, len(self))
        return _population(self.space, self._n_request, self.mode, self.seed,
                           self._named_models)

    # ------------------------------------------------------------------ #

    def _name_width(self) -> int:
        if self._names_arr is not None:
            return self._names_arr.dtype.itemsize // 4
        prefix = "sweep-" if self.mode == "random" else "grid-"
        digits = max(5, len(str(max(self._gen_n - 1, 0))))
        width = len(prefix) + digits
        if self.named is not None:
            width = max(width, max(len(n) for n in self.named.names))
        return width

    def signature(self) -> str:
        """Cheap identity for checkpoint-compatibility checks."""
        if self._fields is not None:
            return f"mmap:{os.path.abspath(self.path)}:{self._gen_n}"
        named = ",".join(m.name for m in self._named_models)
        return (f"gen:{self.mode}:{self.seed}:{self._n_request}:"
                f"[{named}]:{self.space!r}")


def save_population(path: str, population, shard_size: int = 1 << 16) -> str:
    """Write a population to ``path/`` as memory-mappable arrays.

    One float64 ``.npy`` per sweep parameter plus fixed-width unicode
    ``names.npy`` and a ``meta.json``; written shard-by-shard through
    ``np.lib.format.open_memmap`` so saving a ``PopulationStream`` never
    materializes it.  Float64 round-trips exactly, so a sweep over
    ``load_population(path)`` is byte-identical to one over the source.
    """
    if not isinstance(population, (MachineBatch, PopulationStream)):
        population = _as_machine_batch(population)
    os.makedirs(path, exist_ok=True)
    v = len(population)
    if isinstance(population, MachineBatch):
        width = max((len(n) for n in population.names), default=1)
        get = population.slice
    else:
        width = population._name_width()
        get = population.batch
    mm = {
        name: np.lib.format.open_memmap(
            os.path.join(path, f"{name}.npy"), mode="w+",
            dtype=np.float64, shape=(v,))
        for name in SWEEP_PARAMS}
    names_mm = np.lib.format.open_memmap(
        os.path.join(path, "names.npy"), mode="w+",
        dtype=f"<U{max(width, 1)}", shape=(v,))
    for lo in range(0, v, shard_size):
        hi = min(lo + shard_size, v)
        b = get(lo, hi)
        for name in SWEEP_PARAMS:
            mm[name][lo:hi] = getattr(b, name)
        names_mm[lo:hi] = b.names
    for arr in list(mm.values()) + [names_mm]:
        arr.flush()
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"version": 1, "num_variants": v,
                   "params": list(SWEEP_PARAMS)}, f)
    return path


def load_population(path: str) -> PopulationStream:
    """Memory-mapped ``PopulationStream`` over a ``save_population`` dir."""
    return PopulationStream._from_dir(path)


def _resolve_beta(profiles: ProfileBatch, beta, beta_machine,
                  include_named: Sequence[MachineModel],
                  space: ParamSpace, backend: K.Backend) -> np.ndarray:
    """Per-app target vector under the shared run_sweep/shard_sweep
    convention: explicit beta wins; otherwise derive against
    ``beta_machine``, the first named model, or the space's nominal chip --
    never an arbitrary sampled design, so scores stay comparable across
    seeds and shard counts."""
    if beta is None:
        ref = beta_machine or (include_named[0] if include_named
                               else space.nominal)
        return default_beta_batched(
            profiles, MachineBatch.from_models([ref]), backend=backend)
    return np.broadcast_to(
        np.asarray(beta, dtype=np.float64), (len(profiles),)).copy()


def run_sweep(
    profiles,
    *,
    space: Optional[ParamSpace] = None,
    n: int = 256,
    mode: str = "random",
    seed: int = 0,
    include_named: Sequence[MachineModel] = (),
    beta=None,
    beta_machine: Optional[MachineModel] = None,
    timing_model: str = "serial",
    clamp: bool = True,
    backend: Optional[str] = None,
    device=K.DEFAULT_DEVICE,
    population: Optional[MachineBatch] = None,
) -> SweepResult:
    """One-call sweep: generate a population and score it.

    ``mode="random"`` draws ``n`` Halton samples; ``mode="grid"`` builds a
    full grid with ``ceil(n ** (1/d))`` points per dimension.  Any
    ``include_named`` models (e.g. the paper's baseline/denser/densest) are
    prepended.  When ``beta`` is None the per-app default target is derived
    against ``beta_machine``, defaulting to the first named model or, with
    no named models, the space's nominal chip.  ``backend`` picks the
    kernel backend (``"cuda"``/``"torch"``, default by ``device``, which
    defaults to ``"cuda"``).  ``population`` bypasses generation entirely
    with a pre-built ``MachineBatch``.

    Example (synthetic single-app suite, plain version on the host):

    >>> from repro_torch.core import WorkloadProfile, run_sweep
    >>> apps = [WorkloadProfile(name="app0", flops=2e14, hbm_bytes=1.5e11,
    ...                         collective_bytes={"all-reduce": 2e10},
    ...                         num_devices=256, model_flops=5e16)]
    >>> res = run_sweep(apps, n=64, seed=0, device="cpu")
    >>> len(res.machines)
    64
    >>> res.best_fit("app0") in res.variant_names
    True
    >>> front = res.pareto_front()          # 2-D: aggregate vs area
    >>> front == sorted(front, key=lambda i: res.area()[i])
    True
    """
    profiles = _as_profile_batch(profiles)  # pack once; input may be a generator
    space = space or ParamSpace.default()
    be = K.get_backend(backend, device)
    pop = (population if population is not None
           else _population(space, n, mode, seed, include_named))
    beta = _resolve_beta(profiles, beta, beta_machine, include_named, space,
                         be)
    return batched_congruence(
        profiles, pop, beta=beta, timing_model=timing_model, clamp=clamp,
        backend=be)


# --------------------------------------------------------------------------- #
# Sharded mega-sweeps: walk the population shard by shard, reduce each on
# the device, pre-filter per shard, merge fronts on the host
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ShardedSweepResult:
    """Pareto-complete summary of a sharded sweep.

    A mega-sweep's full ``(A, V)`` tensor never exists in one place -- each
    shard's scores are reduced to per-variant statistics and a Pareto
    candidate set, then discarded.  ``result`` is a full ``SweepResult``
    over the surviving candidates only (their global sweep indices are in
    ``candidate_indices``), which is *front-complete*: every variant on the
    global 2-D or 3-D Pareto front survives pre-filtering, so
    ``pareto_front()`` here names exactly the variants a single-device
    ``run_sweep`` over the same population would name.

    Front-completeness only holds for the silicon axes the shards were
    pre-filtered with, so the extraction methods take NO cost-model
    override: they always use the ``cost_model`` the sweep ran with (to
    rank under different weights, re-run ``shard_sweep`` with that
    ``cost_model=``) -- pruned variants cannot be recovered post hoc.
    """

    result: SweepResult              # survivors only, fully scored
    candidate_indices: np.ndarray    # survivors' indices into the full sweep
    num_variants: int                # full population size V
    num_shards: int
    mesh_axis: str                   # where shards were reduced, e.g. "cuda:0"
    best_fit_map: Dict[str, str]     # app -> best variant over ALL V
    cost_model: CostModel            # the model the pre-filter ran with
    streamed: bool = False           # population generated/mapped per shard
    resumed_shards: int = 0          # shards skipped via checkpoint resume

    # ------------------------------ lookups --------------------------- #

    @property
    def apps(self) -> List[str]:
        return self.result.apps

    @property
    def backend(self) -> str:
        return self.result.backend

    def best_fit(self, app: str) -> str:
        """Best-fit variant over the FULL population (merged across shards)."""
        return self.best_fit_map[app]

    # --------------------------- extractions -------------------------- #

    def pareto_front(self) -> List[int]:
        """2-D (area, aggregate) front under the sweep's cost model.
        Indices are into ``result`` (the survivor set) -- use
        ``pareto_names`` for population-stable identifiers."""
        return pareto_front_indices(
            self.cost_model.area(self.result.machines),
            self.result.aggregate_mean())

    def pareto_front_3d(self) -> List[int]:
        """3-D (aggregate, area, power) front under the sweep's cost model."""
        return pareto_front_indices_3d(
            self.result.aggregate_mean(),
            self.cost_model.area(self.result.machines),
            self.cost_model.power(self.result.machines))

    def pareto_names(self) -> List[str]:
        return [self.result.machines.names[i] for i in self.pareto_front()]

    def seed_codesign(self, k: Optional[int] = None) -> MachineBatch:
        """Pareto survivors as a warm-start seed for gradient co-design.

        Delegates to ``SweepResult.seed_codesign`` over the survivor set
        under the cost model the shards were pre-filtered with (the only
        axes front-completeness holds for) -- so a mega-sweep's winners
        seed co-design exactly like a single-pass sweep's would.
        """
        return self.result.seed_codesign(k=k, cost_model=self.cost_model)

    def frontier(self, budgets, k: Optional[int] = None, **kwargs):
        """J*(budget) frontier from the mega-sweep's survivors, traced
        under the cost model the shards were pre-filtered with (see
        ``SweepResult.frontier``)."""
        return self.result.frontier(budgets, k=k,
                                    cost_model=self.cost_model, **kwargs)

    # ----------------------------- reports ---------------------------- #

    def markdown(self, top_k: Optional[int] = None) -> str:
        layout = self.mesh_axis + (", streamed" if self.streamed else "")
        header = (f"sharded sweep: {self.num_variants} variants across "
                  f"{self.num_shards} shards ({layout}); "
                  f"{len(self.result.machines)} Pareto candidates kept")
        return header + "\n\n" + self.result.markdown(top_k, self.cost_model)

    def to_json(self, top_k: Optional[int] = None) -> dict:
        out = self.result.to_json(top_k=top_k, cost_model=self.cost_model)
        out.update(
            num_variants=self.num_variants,
            num_candidates=len(self.result.machines),
            num_shards=self.num_shards,
            mesh_axis=self.mesh_axis,
            streamed=self.streamed,
            resumed_shards=self.resumed_shards,
            best_fit={app: self.best_fit_map[app] for app in self.apps},
        )
        return out


def _shard_bounds(v: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous, near-equal ``[lo, hi)`` shard ranges covering ``[0, v)``."""
    base, extra = divmod(v, num_shards)
    bounds, lo = [], 0
    for s in range(num_shards):
        hi = lo + base + (1 if s < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


#: Default shard width when streaming without an explicit ``num_shards`` --
#: bounds the regenerated chunk (and the sharded (A, chunk) score slice) to
#: a few MB regardless of V.
STREAM_SHARD_VARIANTS = 65536


def _sweep_signature(pop_tag: str, v: int, num_shards: int, backend_name: str,
                     timing_model: str, clamp: bool, keep_top: int,
                     cost_model: CostModel, beta_vec: np.ndarray) -> str:
    """Configuration fingerprint stored with every sweep checkpoint.

    ``resume=`` refuses to merge state produced under a different
    population, backend, shard layout or scoring config -- silently mixing
    those would produce plausible-looking wrong fronts.
    """
    h = hashlib.blake2b(digest_size=16)
    for part in (pop_tag, str(v), str(num_shards), backend_name,
                 timing_model, str(bool(clamp)), str(int(keep_top)),
                 repr(cost_model)):
        h.update(part.encode())
        h.update(b"\0")
    h.update(np.asarray(beta_vec, dtype=np.float64).tobytes())
    return h.hexdigest()


def _mesh_stats(be, pb: ProfileBatch, mb: MachineBatch, beta_vec, mesh,
                timing_model: str, clamp: bool):
    """``be.sharded_stats`` of one chunk split over the ranks of the 1-D
    ``mesh``: rank r reduces variants [r*w, (r+1)*w) of the chunk (w =
    ceil(V / ranks)) on its device, then the ranks' (mean, min, argmin)
    rows are all-gathered over the mesh and merged in rank order."""
    import torch
    import torch.distributed as dist

    n, r = mesh.size(), mesh.get_local_rank(0)
    v = len(mb)
    w = -(-v // n)
    lo, hi = min(r * w, v), min((r + 1) * w, v)
    a = len(pb)
    row = np.full(w + 2 * a, np.inf)
    row[w + a:] = 0.0
    if hi > lo:
        mean, mins, idx = be.sharded_stats(pb.arrays(), mb.slice(lo, hi).arrays(),
                                           beta_vec, timing_model=timing_model,
                                           clamp=clamp)
        row[:hi - lo] = mean
        row[w:w + a] = mins
        row[w + a:] = idx + lo
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    mine = torch.as_tensor(row, dtype=torch.float64, device=dev)
    rows = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(rows, mine, group=mesh.get_group(0))
    rows = np.stack([t.cpu().numpy() for t in rows])
    agg_mean = rows[:, :w].reshape(-1)[:v]
    app_min = np.full(a, np.inf)
    app_idx = np.zeros(a, dtype=np.int64)
    for k in range(n):       # rank order is variant order: strict < keeps
        better = rows[k, w:w + a] < app_min     # the first argmin
        app_min = np.where(better, rows[k, w:w + a], app_min)
        app_idx = np.where(better, rows[k, w + a:].astype(np.int64), app_idx)
    return agg_mean, app_min, app_idx


def shard_sweep(
    profiles,
    *,
    space: Optional[ParamSpace] = None,
    n: int = 1024,
    mode: str = "random",
    seed: int = 0,
    include_named: Sequence[MachineModel] = (),
    beta=None,
    beta_machine: Optional[MachineModel] = None,
    timing_model: str = "serial",
    clamp: bool = True,
    backend: Optional[str] = None,
    device=K.DEFAULT_DEVICE,
    num_shards: Optional[int] = None,
    keep_top: int = 16,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    progress=None,
    stream: bool = False,
    population=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    checkpoint_keep: int = 2,
    mesh=None,
) -> ShardedSweepResult:
    """Sharded ``run_sweep`` for populations that outgrow one pass.

    Same population, beta convention and scoring as ``run_sweep`` (same
    ``space``/``n``/``mode``/``seed`` give bitwise-identical variants), but
    the ``(A, V)`` score tensor is never materialized in one place.  The
    population is walked in ``num_shards`` contiguous chunks on one device;
    each chunk goes through the backend's ``sharded_stats`` (kernel K4 on
    the ``cuda`` backend: the fused pass reduced on the card to per-variant
    suite means and per-app min/argmin, so only O(V_chunk) + O(A) values
    come back to the host).  A backend without that pass is reduced on the
    host from a full ``congruence`` result.

    **Mesh** (``mesh=``, a 1-D ``DeviceMesh`` such as
    ``repro_torch.launch.mesh.make_variant_mesh()``, one card a rank): each
    chunk's variants are split over the mesh's ranks, each rank runs the
    backend's statistics pass (K4) on its slice on its own card, and the
    per-rank rows are all-gathered and merged in rank order, which is
    variant order (strict ``<``: the first argmin wins), as the JAX
    package's ``shard_map`` over its variant mesh; ``mesh_axis`` then reads
    ``"variants=N mesh"``.  Every rank gets the same result.

    The host then pre-filters each shard to its local Pareto candidates --
    every globally non-dominated point is locally non-dominated, so the
    union of local fronts contains the global front -- merges in the
    per-app argmins and per-shard top-``keep_top``, and re-scores only the
    survivors into the full ``SweepResult`` carried by the returned
    ``ShardedSweepResult``.

    Example (the front matches ``run_sweep`` exactly):

    >>> from repro_torch.core import WorkloadProfile, run_sweep, shard_sweep
    >>> apps = [WorkloadProfile(name="app0", flops=2e14, hbm_bytes=1.5e11,
    ...                         collective_bytes={"all-reduce": 2e10},
    ...                         num_devices=256, model_flops=5e16)]
    >>> sharded = shard_sweep(apps, n=128, num_shards=4, device="cpu")
    >>> single = run_sweep(apps, n=128, device="cpu")
    >>> sharded.pareto_names() == [single.machines.names[i]
    ...                            for i in single.pareto_front()]
    True
    >>> sharded.best_fit("app0") == single.best_fit("app0")
    True

    **Streaming** (``stream=True``, or passing a ``PopulationStream`` /
    ``load_population`` dir as ``population=``): each shard's variants are
    regenerated (or memory-mapped) on demand, so neither the ``(A, V)``
    tensor nor the full ``MachineBatch`` ever exists.  Streamed shards are
    byte-identical to slices of the materialized population, so results
    match exactly.

    **Resume** (``checkpoint_dir=``): after every shard the merged per-app
    minima + Pareto survivors are written atomically through
    ``repro_torch.checkpoint.store``; ``resume=True`` restores the latest
    checkpoint (refusing a config mismatch), skips completed shards and
    returns byte-identical fronts to an uninterrupted run.
    """
    pb = _as_profile_batch(profiles)
    space = space or ParamSpace.default()
    be = K.get_backend(backend, device)

    # ---- population source: materialized batch or per-shard stream
    src: Optional[PopulationStream] = None
    pop: Optional[MachineBatch] = None
    if population is not None:
        if isinstance(population, PopulationStream):
            src = population
            pop_tag = src.signature()
        else:
            pop = _as_machine_batch(population)
            h = hashlib.blake2b("\0".join(pop.names).encode(),
                                digest_size=16)
            pop_tag = f"batch:{len(pop)}:{h.hexdigest()}"
    elif stream:
        src = PopulationStream(space, n, mode=mode, seed=seed,
                               include_named=list(include_named))
        pop_tag = src.signature()
    else:
        pop = _population(space, n, mode, seed, include_named)
        named = ",".join(m.name for m in include_named)
        pop_tag = f"gen:{mode}:{seed}:{n}:[{named}]:{space!r}"
    v = len(src) if src is not None else len(pop)
    beta_vec = _resolve_beta(pb, beta, beta_machine, include_named, space, be)

    on_device = type(be).sharded_stats is not K.Backend.sharded_stats
    if mesh is not None and not on_device:
        raise ValueError(f"backend {be.name!r} has no statistics pass to split "
                         "over a mesh")
    if mesh is not None:
        mesh_axis = f"{mesh.mesh_dim_names[0]}={mesh.size()} mesh"
    else:
        mesh_axis = str(be.device) if on_device else "host-chunked"

    default_shards = mesh.size() if mesh is not None else 1
    if src is not None:
        # streaming exists to bound memory: never let one shard regrow to V
        default_shards = -(-v // STREAM_SHARD_VARIANTS)
    num_shards = max(1, min(num_shards or default_shards, v))
    bounds = _shard_bounds(v, num_shards)

    def shard_batch(lo: int, hi: int) -> MachineBatch:
        return src.batch(lo, hi) if src is not None else pop.slice(lo, hi)

    # ---- resumable state: merged per-app best fits + survivor indices
    app_min = np.full(len(pb), np.inf)
    app_idx = np.zeros(len(pb), dtype=np.int64)
    survivors: set = set()
    start_shard = 0
    config_sig = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import store as ckpt

        config_sig = _sweep_signature(pop_tag, v, num_shards, be.name,
                                      timing_model, clamp, keep_top,
                                      cost_model, beta_vec)
        if resume and ckpt.latest_step(checkpoint_dir) is not None:
            tree_like = {"app_idx": app_idx, "app_min": app_min,
                         "survivors": np.zeros(0, dtype=np.int64)}
            state, extra = ckpt.restore(checkpoint_dir, tree_like)
            if extra.get("config") != config_sig:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir!r} was written by a "
                    "different sweep configuration; refusing to resume "
                    "(pass resume=False or a fresh checkpoint_dir)")
            app_min = np.asarray(state["app_min"], dtype=np.float64)
            app_idx = np.asarray(state["app_idx"], dtype=np.int64)
            survivors = set(int(i) for i in state["survivors"])
            start_shard = int(extra["completed_shards"])
    elif resume:
        raise ValueError("resume=True requires checkpoint_dir=")

    # ---- statistics pass, shard by shard: each shard is reduced to
    # per-variant suite means + per-app minima (only O(V_shard) + O(A)
    # rows leave the device), pre-filtered to its local Pareto candidates,
    # then discarded.
    # ``progress(shard_index, num_shards, lo, hi)`` fires after each
    # shard's statistics land (a raising callback aborts the sweep -- the
    # cancellation hook; the just-saved checkpoint makes the abort
    # resumable).
    for s, (lo, hi) in enumerate(bounds):
        if s < start_shard:
            continue
        mb = shard_batch(lo, hi)
        if mesh is not None:
            stats = _mesh_stats(be, pb, mb, beta_vec, mesh, timing_model, clamp)
        else:
            stats = be.sharded_stats(pb.arrays(), mb.arrays(), beta_vec,
                                     timing_model=timing_model, clamp=clamp)
        if stats is None:
            out = be.congruence(pb.arrays(), mb.arrays(), beta_vec,
                                timing_model=timing_model, clamp=clamp)
            agg = be.to_numpy(out.aggregate)
            agg_mean_s = agg.mean(axis=0)
            local_idx = np.argmin(agg, axis=1)
            local_min = agg[np.arange(len(pb)), local_idx]
        else:
            agg_mean_s, local_min, local_idx = stats
        # strict < keeps the first-occurrence argmin across shards in
        # index order, matching a single global argmin
        better = local_min < app_min
        app_min = np.where(better, local_min, app_min)
        app_idx = np.where(better, local_idx + lo, app_idx)

        area_s = np.asarray(cost_model.area(mb))
        power_s = np.asarray(cost_model.power(mb))
        survivors.update(
            lo + i for i in pareto_front_indices(area_s, agg_mean_s))
        survivors.update(
            lo + i for i in pareto_front_indices_3d(agg_mean_s, area_s,
                                                    power_s))
        order = np.argsort(agg_mean_s, kind="stable")[:keep_top]
        survivors.update(int(lo + i) for i in order)

        if checkpoint_dir is not None:
            ckpt.save(
                checkpoint_dir, s + 1,
                {"app_idx": app_idx, "app_min": app_min,
                 "survivors": np.array(sorted(survivors), dtype=np.int64)},
                extra={"config": config_sig, "completed_shards": s + 1,
                       "num_shards": num_shards, "num_variants": v})
            ckpt.retain(checkpoint_dir, keep=checkpoint_keep)
        if progress is not None:
            progress(s, num_shards, lo, hi)

    # ---- re-score the survivor union into a full (front-complete) result
    candidate_set = set(survivors)
    candidate_set.update(int(i) for i in app_idx)
    candidates = np.array(sorted(candidate_set), dtype=np.int64)
    cand_batch = (src.take(candidates) if src is not None
                  else pop.take(candidates))
    result = batched_congruence(
        pb, cand_batch, beta=beta_vec, timing_model=timing_model,
        clamp=clamp, backend=be)
    cand_pos = {int(g): j for j, g in enumerate(candidates)}
    return ShardedSweepResult(
        result=result,
        candidate_indices=candidates,
        num_variants=v,
        num_shards=num_shards,
        mesh_axis=mesh_axis,
        best_fit_map={app: cand_batch.names[cand_pos[int(app_idx[i])]]
                      for i, app in enumerate(pb.names)},
        cost_model=cost_model,
        streamed=src is not None,
        resumed_shards=start_shard,
    )
