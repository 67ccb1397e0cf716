"""PyTorch / CUDA port of the congruence-profiling system.

A second package beside the JAX package ``repro``; it imports nothing of
it.  This slice carries the sweep path: profile suites, per-app beta, the
fused congruence pass over A apps x V machine variants on hand-written
Hopper kernels, best fits and Pareto fronts (``run_sweep``, ``evaluate``,
``shard_sweep``).  See ``repro_torch.core`` for the public names.
"""

from repro_torch.core import (  # noqa: F401
    VARIANTS,
    CostModel,
    MachineBatch,
    MachineModel,
    ParamSpace,
    PopulationStream,
    ProfileBatch,
    ShardedSweepResult,
    SweepResult,
    WorkloadProfile,
    batched_congruence,
    batched_step_time,
    default_beta_batched,
    evaluate,
    get_backend,
    resolve_suite,
    run_sweep,
    shard_sweep,
)
from repro_torch.carry import machines_from_numpy, profiles_from_numpy  # noqa: F401
