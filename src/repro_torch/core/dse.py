"""Design-space exploration over machine variants (paper §III, Table I).

Given a set of workload profiles (applications) and machine variants
(baseline / denser / densest, or thousands of generated designs), compute the
aggregate congruence score for every (application, variant) pair, pick each
application's best-fit variant (lowest aggregate = smallest radar area = best
alignment), and report suite means -- reproducing the structure of the
paper's Table I and Fig. 3 on our TPU workloads.

Two execution paths share one table interface:

  * ``method="batched"`` (default) delegates the whole cross-product to the
    batched passes in ``repro_torch.core.sweep`` and returns a
    ``LazyDseTable`` that materializes full ``DseCell`` reports only for
    the cells a caller actually asks for -- the fast path that makes
    1000-variant sweeps as cheap as the paper's 3-variant Table I.
  * ``method="scalar"`` is the original per-cell reference loop, kept as the
    equivalence oracle (tests assert batched == scalar to ~1e-9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.congruence import (
    CongruenceReport,
    SCORE_NAMES,
    default_beta,
    extended_decomposition,
    profile_congruence,
)
from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.kernels_xp import DEFAULT_DEVICE, resolve_device
from repro_torch.core.machine import ALL_SUBSYSTEMS, VARIANTS
from repro_torch.core.timing import subsystem_times


@dataclasses.dataclass
class DseCell:
    app: str
    variant: str
    report: CongruenceReport

    @property
    def aggregate(self) -> float:
        return self.report.aggregate


def _top_variants(table, top_k: Optional[int]) -> List[str]:
    """Variant columns to report: all, or the best ``top_k`` by suite mean."""
    variants = table.variants
    if top_k is None:
        return variants
    return sorted(variants, key=table.aggregate_mean)[:top_k]


def _table_json(table, top_k: Optional[int]) -> dict:
    """JSON rendering shared by the eager and lazy tables (uniform result
    protocol: every result type exposes ``to_json(top_k=...)``)."""
    variants = _top_variants(table, top_k)
    scores = {}
    for app in table.apps:
        scores[app] = {}
        for v in variants:
            trip = table._triplet(app, v)
            if trip is not None:
                scores[app][v] = {"ICS": trip[0], "HRCS": trip[1],
                                  "LBCS": trip[2]}
    return {
        "apps": table.apps,
        "variants": variants,
        "suites": {s: list(apps) for s, apps in table.suites.items()},
        "aggregate": {app: {v: table._aggregate(app, v) for v in variants}
                      for app in table.apps},
        "scores": scores,
        "best_fit": {app: table.best_fit(app) for app in table.apps},
        "suite_mean": {s: {v: table.suite_mean(s, v) for v in variants}
                       for s in table.suites},
        "aggregate_mean": {v: table.aggregate_mean(v) for v in variants},
        "overall_best_fit": table.overall_best_fit(),
    }


def _table_markdown(table, variants=None) -> str:
    """Table I rendering shared by the eager and lazy tables.

    ``table`` provides ``variants``, ``suites``, ``best_fit``,
    ``suite_mean``, ``suite_best_fit``, ``aggregate_mean``,
    ``overall_best_fit`` and ``_aggregate(app, variant) -> Optional[float]``.
    """
    variants = table.variants if variants is None else variants
    lines = ["| application | " + " | ".join(variants) + " | best fit |",
             "|---" * (len(variants) + 2) + "|"]
    for suite, suite_apps in table.suites.items():
        lines.append(f"| **{suite}** |" + " |" * (len(variants) + 1))
        for app in suite_apps:
            row = [f"| {app} "]
            for v in variants:
                agg = table._aggregate(app, v)
                row.append("| - " if agg is None else f"| {agg:.3f} ")
            row.append(f"| {table.best_fit(app)} |")
            lines.append("".join(row))
        means = " ".join(f"| {table.suite_mean(suite, v):.3f}"
                         for v in variants)
        lines.append(
            f"| *{suite} mean* {means} | {table.suite_best_fit(suite)} |"
        )
    means = " ".join(f"| {table.aggregate_mean(v):.3f}" for v in variants)
    lines.append(f"| **aggregate** {means} | {table.overall_best_fit()} |")
    return "\n".join(lines)


def _radar_markdown(table) -> str:
    """Fig. 3 rendering shared by the eager and lazy tables.

    ``table`` additionally provides ``apps`` and
    ``_triplet(app, variant) -> Optional[(ics, hrcs, lbcs)]``.
    """
    variants = table.variants
    header = "| application |" + "".join(
        f" {v} ICS | {v} HRCS | {v} LBCS |" for v in variants
    )
    lines = [header, "|---" * (1 + 3 * len(variants)) + "|"]
    for app in table.apps:
        row = [f"| {app} "]
        for v in variants:
            trip = table._triplet(app, v)
            if trip is None:
                row.append("| - | - | - ")
            else:
                ics, hrcs, lbcs = trip
                row.append(f"| {ics:.3f} | {hrcs:.3f} | {lbcs:.3f} ")
        lines.append("".join(row) + "|")
    return "\n".join(lines)


@dataclasses.dataclass
class DseTable:
    """Table I analogue: rows = applications, columns = machine variants."""

    cells: List[DseCell]
    suites: Mapping[str, Sequence[str]]  # suite name -> list of app names

    def cell(self, app: str, variant: str) -> DseCell:
        for c in self.cells:
            if c.app == app and c.variant == variant:
                return c
        raise KeyError((app, variant))

    @property
    def apps(self) -> List[str]:
        seen: Dict[str, None] = {}
        for c in self.cells:
            seen.setdefault(c.app, None)
        return list(seen)

    @property
    def variants(self) -> List[str]:
        seen: Dict[str, None] = {}
        for c in self.cells:
            seen.setdefault(c.variant, None)
        return list(seen)

    def best_fit(self, app: str) -> str:
        """Lowest aggregate congruence = best-fit architecture (paper §III-C)."""
        best, best_score = None, float("inf")
        for c in self.cells:
            if c.app == app and c.aggregate < best_score:
                best, best_score = c.variant, c.aggregate
        assert best is not None
        return best

    def suite_mean(self, suite: str, variant: str) -> float:
        apps = set(self.suites[suite])
        vals = [c.aggregate for c in self.cells if c.variant == variant and c.app in apps]
        return sum(vals) / len(vals) if vals else float("nan")

    def suite_best_fit(self, suite: str) -> str:
        return min(self.variants, key=lambda v: self.suite_mean(suite, v))

    def aggregate_mean(self, variant: str) -> float:
        vals = [c.aggregate for c in self.cells if c.variant == variant]
        return sum(vals) / len(vals) if vals else float("nan")

    def overall_best_fit(self) -> str:
        return min(self.variants, key=self.aggregate_mean)

    # ------------------------------------------------------------------ #

    def _aggregate(self, app: str, variant: str) -> Optional[float]:
        try:
            return self.cell(app, variant).aggregate
        except KeyError:
            return None

    def _triplet(self, app: str, variant: str) -> Optional[Tuple[float, float, float]]:
        try:
            r = self.cell(app, variant).report
        except KeyError:
            return None
        return (r.ics, r.hrcs, r.lbcs)

    def markdown(self, top_k: Optional[int] = None) -> str:
        """Table I markdown; ``top_k`` keeps only the best variant columns."""
        return _table_markdown(self, _top_variants(self, top_k))

    def to_json(self, top_k: Optional[int] = None) -> dict:
        """JSON-serializable table summary (uniform result protocol)."""
        return _table_json(self, top_k)

    def radar_markdown(self) -> str:
        """Fig. 3 analogue: per-app ICS/HRCS/LBCS triplets per variant."""
        return _radar_markdown(self)


class LazyDseTable:
    """``DseTable`` interface backed by a batched ``SweepResult``.

    All aggregate queries (best fits, suite means, markdown) read the score
    arrays directly; full ``CongruenceReport`` objects -- including the
    per-component extended decomposition, which is inherently per-cell --
    are materialized only when ``cell()`` is called, and cached.  This is
    what keeps 10k-variant sweeps cheap: the O(A*V) work is vectorized and
    the O(1) cells a caller inspects pay the scalar cost.
    """

    def __init__(self, result, suites: Mapping[str, Sequence[str]]):
        self.result = result
        self.suites: Dict[str, Sequence[str]] = dict(suites)
        self._cell_cache: Dict[Tuple[str, str], DseCell] = {}
        self._app_idx = {name: i for i, name in
                         reversed(list(enumerate(result.profiles.names)))}
        self._var_idx = {name: i for i, name in
                         reversed(list(enumerate(result.machines.names)))}

    # ------------------------------ lookups --------------------------- #

    @property
    def apps(self) -> List[str]:
        seen: Dict[str, None] = {}
        for name in self.result.profiles.names:
            seen.setdefault(name, None)
        return list(seen)

    @property
    def variants(self) -> List[str]:
        seen: Dict[str, None] = {}
        for name in self.result.machines.names:
            seen.setdefault(name, None)
        return list(seen)

    def _indices(self, app: str, variant: str) -> Tuple[int, int]:
        if app not in self._app_idx or variant not in self._var_idx:
            raise KeyError((app, variant))
        return self._app_idx[app], self._var_idx[variant]

    def cell(self, app: str, variant: str) -> DseCell:
        """Materialize one full cell (report + extended decomposition)."""
        key = (app, variant)
        if key not in self._cell_cache:
            a, v = self._indices(app, variant)
            self._cell_cache[key] = DseCell(
                app=app, variant=variant, report=self._report(a, v))
        return self._cell_cache[key]

    @property
    def cells(self) -> List[DseCell]:
        """Materialize the full cross-product (expensive for huge sweeps)."""
        return [self.cell(app, v)
                for app in self.result.profiles.names
                for v in self.result.machines.names]

    def _report(self, a: int, v: int) -> CongruenceReport:
        res = self.result
        profile = res.profiles.profiles[a]
        machine = res.machines.model(v)
        gamma = float(res.gamma[a, v])
        beta = float(res.beta[a])
        alphas = {s.value: float(res.alphas[s.value][a, v])
                  for s in ALL_SUBSYSTEMS}
        scores = {SCORE_NAMES[s]: float(res.scores[SCORE_NAMES[s]][a, v])
                  for s in ALL_SUBSYSTEMS}
        baseline = subsystem_times(profile, machine)
        extended = extended_decomposition(
            profile, machine, gamma=gamma, beta=beta,
            timing_model=res.timing_model, eps=res.eps, clamp=res.clamp,
            times=baseline)
        return CongruenceReport(
            name=profile.name,
            machine=machine.name,
            timing_model=res.timing_model,
            gamma=gamma,
            beta=beta,
            alphas=alphas,
            scores=scores,
            extended=extended,
            baseline=baseline,
        )

    # --------------------------- aggregates --------------------------- #

    def best_fit(self, app: str) -> str:
        return self.result.best_fit(app)

    def suite_mean(self, suite: str, variant: str) -> float:
        apps = set(self.suites[suite])
        rows = [i for i, name in enumerate(self.result.profiles.names)
                if name in apps]
        if not rows or variant not in self._var_idx:
            return float("nan")
        col = self._var_idx[variant]
        return float(self.result.aggregate[rows, col].mean())

    def suite_best_fit(self, suite: str) -> str:
        return min(self.variants, key=lambda v: self.suite_mean(suite, v))

    def aggregate_mean(self, variant: str) -> float:
        if variant not in self._var_idx:
            return float("nan")
        return float(self.result.aggregate[:, self._var_idx[variant]].mean())

    def overall_best_fit(self) -> str:
        return min(self.variants, key=self.aggregate_mean)

    # ----------------------------- reports ---------------------------- #

    def _aggregate(self, app: str, variant: str) -> Optional[float]:
        try:
            a, v = self._indices(app, variant)
        except KeyError:
            return None
        return float(self.result.aggregate[a, v])

    def _triplet(self, app: str, variant: str) -> Optional[Tuple[float, float, float]]:
        try:
            a, v = self._indices(app, variant)
        except KeyError:
            return None
        s = self.result.scores
        return (float(s["ICS"][a, v]), float(s["HRCS"][a, v]),
                float(s["LBCS"][a, v]))

    def markdown(self, top_k: Optional[int] = None) -> str:
        """Table I markdown; ``top_k`` keeps only the best variant columns."""
        return _table_markdown(self, _top_variants(self, top_k))

    def to_json(self, top_k: Optional[int] = None) -> dict:
        """JSON-serializable table summary (uniform result protocol)."""
        return _table_json(self, top_k)

    def radar_markdown(self) -> str:
        return _radar_markdown(self)


def evaluate(
    profiles: Iterable[WorkloadProfile],
    *,
    variants=VARIANTS,
    suites: Optional[Mapping[str, Sequence[str]]] = None,
    timing_model: str = "serial",
    beta: Optional[float] = None,
    clamp: bool = True,
    method: str = "auto",
    backend: Optional[str] = None,
    device=DEFAULT_DEVICE,
):
    """Score every (application x variant) cell.

    The expensive compile happened once per profile; this sweep is pure
    arithmetic -- the paper's lightweight DSE loop.

    ``variants`` accepts either a sequence of ``MachineModel`` or a packed
    ``sweep.MachineBatch`` (e.g. from ``ParamSpace.sample``).  ``method``
    selects the execution path: ``"batched"`` (vectorized, returns a
    ``LazyDseTable``), ``"scalar"`` (reference per-cell loop, returns an
    eager ``DseTable``), or ``"auto"`` (batched).  Both paths run the SAME
    ``kernels_xp`` math (scalar = batch of size 1) and expose the same
    table interface.  ``backend`` picks the kernel backend for the batched
    path (``"cuda"``/``"torch"``, default by ``device``, which defaults to
    ``"cuda"``).  The scalar path and the lazily materialized cells run
    the shared math on the host.

    Example (synthetic profile against the paper's three named variants):

    >>> from repro_torch.core import WorkloadProfile, evaluate
    >>> apps = [WorkloadProfile(name="app0", flops=2e14, hbm_bytes=1.5e11,
    ...                         collective_bytes={"all-reduce": 2e10},
    ...                         num_devices=256, model_flops=5e16)]
    >>> table = evaluate(apps, device="cpu")   # batched path, LazyDseTable
    >>> table.variants
    ['baseline', 'denser', 'densest']
    >>> table.best_fit("app0") in table.variants
    True
    >>> cell = table.cell("app0", "baseline")   # full report, lazily
    >>> cell.aggregate == table._aggregate("app0", "baseline")
    True
    """
    from repro_torch.core.sweep import MachineBatch, batched_congruence

    resolve_device(device)  # no quiet CPU run when the card is missing
    profiles = list(profiles)
    if suites is None:
        suites = {"all": [p.name for p in profiles]}
    if method == "auto":
        method = "batched"

    if method == "batched":
        machines = (variants if isinstance(variants, MachineBatch)
                    else MachineBatch.from_models(list(variants)))
        result = batched_congruence(
            profiles, machines, beta=beta, beta_ref=0,
            timing_model=timing_model, clamp=clamp, backend=backend,
            device=device)
        return LazyDseTable(result, dict(suites))

    if method != "scalar":
        raise ValueError(f"unknown evaluate method {method!r}")

    models = (variants.models() if isinstance(variants, MachineBatch)
              else list(variants))
    cells: List[DseCell] = []
    for p in profiles:
        # Paper semantics: beta is a USER-DEFINED target per application,
        # held constant across architecture variants (Table I compares
        # variants against the same target).  Default: derived once from the
        # baseline (first) variant.
        app_beta = beta if beta is not None else default_beta(p, models[0])
        for m in models:
            rep = profile_congruence(
                p, m, timing_model=timing_model, beta=app_beta, clamp=clamp
            )
            cells.append(DseCell(app=p.name, variant=m.name, report=rep))
    return DseTable(cells=cells, suites=dict(suites))
