"""Fault-tolerant training driver.

The JAX package's ``repro/training/trainer.py``, on one device or, with
``mesh`` (and ``sharding``, a ``distributed.sharding.ShardingConfig``), on
a ``DeviceMesh`` of the process group's ranks: the state is drawn (or
restored) whole on every rank and sharded by the rules
(``distributed.place.shard_state``), the batches split over the data
axes, and each step runs under the activation rules; checkpoints are
gathered whole and written by rank 0.
  * checkpoint/restart -- atomic checkpoints every N steps and of the last
    step (async writer; the JAX package's writes the last step's twice when
    N divides the step count, the port once);
    on (re)start the driver restores the latest valid checkpoint and resumes
    from its step (the data pipeline is step-indexed, so no data state is
    lost);
  * failure handling -- a ``FailureInjector`` (tests) or real exceptions
    trigger restart-from-checkpoint with bounded retries; a restart first
    waits for the checkpoint being written;
  * straggler mitigation -- per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged and counted, and a hook lets the
    launcher react;
  * elastic -- checkpoints hold host arrays in the JAX package's layout, so
    a state written on one device (or by the JAX package) resumes on
    another: the CPU, the card.

A step's time is taken on the host clock after its metrics are read back
(which waits for the device), as the JAX package's ``float(v)`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import place as PL
from repro_torch.distributed import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.training.step import (
    init_state,
    make_train_step,
    state_arrays,
    state_from_arrays,
)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    log_every: int = 10
    accum: int = 1


class FailureInjector:
    """Deterministic fault injection for tests: raises at given steps."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerStats:
    ewma: float = 0.0
    count: int = 0
    events: List[Dict[str, float]] = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainerConfig,
        dc: DataConfig,
        oc: Optional[adamw.OptimizerConfig] = None,
        *,
        seed: int = 0,
        device="cuda",
        failure_injector: Optional[FailureInjector] = None,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        mesh=None,
        sharding=None,
    ):
        self.cfg = cfg
        self.tc = tc
        self.dc = dc
        self.oc = oc or adamw.OptimizerConfig(total_steps=tc.total_steps)
        self.seed = seed
        self.device = resolve_device(device)
        self.failure_injector = failure_injector
        self.on_straggler = on_straggler
        self.stragglers = StragglerStats()
        self.data = SyntheticLM(cfg, dc)
        self.ckpt = store.AsyncCheckpointer(tc.checkpoint_dir,
                                            keep=tc.keep_checkpoints)
        self._step = make_train_step(cfg, self.oc, accum=tc.accum)
        self.metrics_log: List[Dict[str, float]] = []
        self.restarts = 0
        self.mesh = mesh
        self.sharding = sharding
        if mesh is not None and sharding is None:
            from repro_torch.distributed.sharding import ShardingConfig

            self.sharding = ShardingConfig()

    # ------------------------------------------------------------------ #

    def _fresh_state(self):
        gen = torch.Generator(self.device).manual_seed(self.seed)
        return self._place(init_state(self.cfg, self.oc, generator=gen,
                                      device=self.device))

    def _place(self, state):
        """``state`` sharded onto the trainer's mesh (every rank draws or
        restores the same whole state and keeps its shards)."""
        if self.mesh is not None:
            PL.shard_state(self.cfg, state["params"], self.mesh, self.sharding, state)
        return state

    def _sharded(self):
        """The step's context: the activation rules on a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(PL.sharded_step())
        stack.enter_context(CTX.use_rules(
            SH.activation_rules(self.mesh, self.sharding, kind="train")))
        return stack

    def _writes(self) -> bool:
        """True on the rank that writes checkpoints (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.get_rank() == 0

    def _restore_or_init(self):
        # a restart waits for the save in flight, so that it resumes from
        # the newest checkpoint taken (the JAX package's trainer restores
        # whichever had finished)
        self.ckpt.wait()
        latest = store.latest_step(self.tc.checkpoint_dir)
        if latest is None:
            return self._fresh_state(), 0
        arrays, extra = store.restore_tensors(self.tc.checkpoint_dir, step=latest)
        state = state_from_arrays(self.cfg, arrays, self.oc, self.device)
        return self._place(state), int(extra["step"])

    def _save(self, step: int, state, extra) -> None:
        arrays = state_arrays(state)   # every rank gathers; one writes
        if self._writes():
            self.ckpt.save(step, arrays, extra=extra)

    def _track_step_time(self, step: int, dt: float) -> None:
        st = self.stragglers
        if st.ewma == 0.0:
            st.ewma = dt
            return
        if dt > self.tc.straggler_factor * st.ewma:
            st.count += 1
            st.events.append({"step": step, "dt": dt, "ewma": st.ewma})
            if self.on_straggler:
                self.on_straggler(step, dt, st.ewma)
        st.ewma = (1 - self.tc.ewma_alpha) * st.ewma + self.tc.ewma_alpha * dt

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The data pipeline's batch ``step`` on the trainer's device (split
        over the mesh's data axes on a mesh)."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in self.data.batch(step).items()}
        if self.mesh is not None:
            batch = PL.shard_batch(batch, self.mesh, self.sharding)
        return batch

    # ------------------------------------------------------------------ #

    def run(self) -> Dict[str, Any]:
        """Train to total_steps with restart-on-failure.  Returns summary."""
        while True:
            try:
                return self._run_once()
            except Exception as exc:  # noqa: BLE001 - restart barrier
                self.restarts += 1
                if self.restarts > self.tc.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.tc.max_restarts}"
                    ) from exc
                print(f"[trainer] failure ({exc}); restart "
                      f"{self.restarts}/{self.tc.max_restarts} from latest "
                      f"checkpoint")

    def _run_once(self) -> Dict[str, Any]:
        state, start_step = self._restore_or_init()
        step = start_step
        saved = None
        while step < self.tc.total_steps:
            batch = self.batch(step)
            if self.failure_injector:
                self.failure_injector.maybe_fail(step)
            t0 = time.perf_counter()
            with self._sharded():
                state, metrics = self._step(state, batch)
                metrics = {k: float(PL.full(v)) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._track_step_time(step, dt)
            metrics["step"] = step
            metrics["step_time_s"] = dt
            self.metrics_log.append(metrics)
            step += 1
            if step % self.tc.log_every == 0:
                print(f"[trainer] step {step}: loss={metrics['loss']:.4f} "
                      f"acc={metrics['accuracy']:.3f} {dt*1e3:.0f}ms")
            if step % self.tc.checkpoint_every == 0:
                self._save(step, state, extra={"loss": metrics["loss"]})
                saved = step
        if saved != self.tc.total_steps:   # the last step's, unless just saved
            self._save(self.tc.total_steps, state, extra={})
        self.ckpt.wait()
        return {
            "final_state": state,
            "steps": step,
            "restarts": self.restarts,
            "straggler_events": self.stragglers.count,
            "metrics": self.metrics_log,
        }
