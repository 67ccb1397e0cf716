"""Congruence profiling core, ported to PyTorch and CUDA.

Public API of this slice (the sweep path):
  MachineModel / Subsystem / VARIANTS      -- hardware models + idealization
  WorkloadProfile                          -- per-cell cost records (JSON)
  subsystem_times / step_time              -- scalar timing analysis
  congruence_score / profile_congruence    -- Eq. 1 + ICS/HRCS/LBCS reports
  dse.evaluate                             -- Table I-style variant sweeps
  sweep.ParamSpace / batched_congruence    -- vectorized population sweeps
  sweep.run_sweep / shard_sweep            -- one-call + sharded sweeps
  kernels_xp.get_backend                   -- "cuda" kernels / "torch" plain
  costmodel.CostModel                      -- area + power silicon proxies
  genload.AppSpace, suites.resolve_suite   -- "gen:<n>" / "zoo-smoke" suites
  codesign.grad_codesign                   -- autograd machine co-design
  constrained.constrained_codesign         -- budgeted descent (area/power
                                              budgets + per-subsystem
                                              area envelopes)
  constrained.joint_codesign               -- joint machine+sharding descent
  frontier.frontier_codesign               -- J*(budget) feasibility frontier
                                              by warm-started continuation
  implicit.implicit_sensitivities          -- KKT shadow prices and
                                              dJ*/d(budget) at an optimum
                                              (plus sensitivities_of for
                                              CodesignResults)
  implicit.bilevel_codesign                -- outer budget-split descent
                                              through the inner optimum
                                              (implicit autograd Function)
  packing.pack_codesign                    -- multi-tenant packing: A apps
                                              across M machine instances
                                              under fleet budgets
  spec.CodesignSpec                        -- one validated request object
                                              for the co-design entry points
                                              and the serving front door

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

from repro_torch.core.codesign import (
    CodesignResult,
    grad_codesign,
    scalarized_objective,
)
from repro_torch.core.constrained import (
    constrained_codesign,
    joint_codesign,
    project_to_budgets,
    validate_area_envelope,
)
from repro_torch.core.frontier import FrontierResult, frontier_codesign
from repro_torch.core.implicit import (
    BilevelResult,
    SensitivityReport,
    bilevel_codesign,
    implicit_jstar_fn,
    implicit_sensitivities,
    sensitivities_of,
    unrolled_jstar_fn,
)
from repro_torch.core.packing import PackingResult, fleet_objective, pack_codesign
from repro_torch.core.congruence import (
    CongruenceReport,
    SCORE_NAMES,
    congruence_score,
    default_beta,
    profile_congruence,
)
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.costs import COLLECTIVE_KINDS, WorkloadProfile
from repro_torch.core.dse import DseCell, DseTable, LazyDseTable, evaluate
from repro_torch.core.genload import (
    APP_PARAMS,
    AppSpace,
    is_gen_suite,
    parse_gen_suite,
    resolve_gen_suite,
)
from repro_torch.core.kernels_xp import (
    Backend,
    TorchBackend,
    available_backends,
    get_backend,
    register_backend,
    resolve_device,
    validate_backend_name,
)
from repro_torch.core.machine import (
    ALL_SUBSYSTEMS,
    IDEAL_EPS,
    MachineModel,
    Subsystem,
    TPU_DENSER,
    TPU_DENSEST,
    TPU_V5E,
    VARIANTS,
    VARIANTS_BY_NAME,
    get_variant,
)
from repro_torch.core.suites import resolve_suite, validate_suite_name
from repro_torch.core.sweep import (
    Dim,
    MachineBatch,
    ParamSpace,
    PopulationStream,
    ProfileBatch,
    ShardedSweepResult,
    SweepResult,
    batched_congruence,
    batched_step_time,
    default_beta_batched,
    load_population,
    run_sweep,
    save_population,
    shard_sweep,
)
from repro_torch.core.spec import CodesignSpec, resolve_spec
from repro_torch.core.timing import TimingBreakdown, step_time, subsystem_times
