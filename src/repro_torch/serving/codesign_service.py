"""Co-design as a service: one micro-batched, cached front door.

Every consumer of the scoring/co-design entry points (CLIs, notebooks)
would otherwise call them directly, re-deriving populations per call.
``CodesignService`` is the serving front door over the SAME kernels:

  * **Micro-batching** -- concurrent score/sweep requests over different
    profile suites are admitted into ONE struct-of-arrays pass: the app
    axis of the batched kernels is already batched, so compatible
    requests' suites are concatenated (``ProfileBatch.concat``), scored
    by a single ``run_sweep`` call over the shared population, and
    scattered back per request (``SweepResult.app_slice``).  The kernels
    are app-rowwise independent, so each scattered result is
    byte-identical to a direct ``run_sweep`` for that request alone
    (pinned in tests/test_torch_service.py, and on the card by
    ``chip_smoke.py``).
  * **Population/artifact caching** -- populations are cached by
    (space, n, mode, seed, named-seed) signature in a byte-bounded LRU
    (``pop_cache_bytes``) so repeat queries skip generation without a
    mega-request pinning unbounded RAM; artifact keys
    ``(population shape, backend, constraint
    signature)`` are tracked (the accounting of repeat shapes);
    byte-identical repeat requests
    hit a result memo and skip everything.  Frontier queries warm-start
    from cached continuation state at the nearest already-solved budget
    (``frontier_codesign(warm_theta=...)``).
  * **Async job queue** -- bounded worker threads behind a thread-safe
    submit/poll/stream API.  Overload is a 429-style
    ``ServiceOverloadError`` at submit (never a hang); per-request
    timeouts expire jobs at dispatch and between mega-sweep shards;
    mega-sweep requests stream shard-by-shard progress events; responses
    render through the uniform result protocol (``markdown``/``to_json``)
    only.

The service runs requests exactly as the library would -- every cache is
an economy, never a semantic change, except the frontier warm start
(``CodesignRequest(warm=False)`` opts out) which seeds the descent from
solved state and is allowed to land at a better optimum.

The port of the JAX package's service.  ``CodesignService(device=...)``
passes its device (``"cuda"`` unless the caller asks for ``"cpu"``; it
raises without a card) to every library call: sweeps run kernels K3 and
K1, mega-sweeps K3 and K4 (backend ``"cuda"``, or the plain ``"torch"``
version when asked), and the co-design kinds descend in float64 torch on
the device.  CLI: ``python -m repro_torch.launch.serve_codesign``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import kernels_xp as K
from repro_torch.core.costmodel import DEFAULT_COST_MODEL
from repro_torch.core.machine import VARIANTS
from repro_torch.core.spec import CodesignSpec
from repro_torch.core.sweep import (
    MachineBatch,
    ParamSpace,
    ProfileBatch,
    _as_profile_batch,
    _population,
    _resolve_beta,
    run_sweep,
    shard_sweep,
)

#: Request kinds and the library entry point each one fronts.
KINDS = ("sweep", "mega_sweep", "constrained", "joint", "frontier", "pack",
         "bilevel")

#: Job lifecycle states (terminal: done/error/cancelled/timeout/rejected).
PENDING, RUNNING = "pending", "running"
DONE, ERROR, CANCELLED, TIMEOUT = "done", "error", "cancelled", "timeout"
TERMINAL = (DONE, ERROR, CANCELLED, TIMEOUT)


class ServiceOverloadError(RuntimeError):
    """Submit-time rejection when the pending queue is full (429-style:
    the caller sees an immediate, retryable error -- never a hang)."""

    status_code = 429


class JobCancelled(RuntimeError):
    pass


class JobTimeout(TimeoutError):
    pass


class _AbortRun(Exception):
    """Raised inside a progress callback to stop a sharded run early
    (cancellation or deadline) -- shard_sweep unwinds between shards."""

    def __init__(self, state: str):
        self.state = state


# --------------------------------------------------------------------------- #
# Request signatures (cache keys)
# --------------------------------------------------------------------------- #


def _canon(obj) -> Any:
    """Canonical, hash-stable structure for any request component."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, np.ndarray):
        return ("nd", obj.shape, str(obj.dtype),
                hashlib.blake2b(np.ascontiguousarray(obj).tobytes(),
                                digest_size=16).hexdigest())
    if isinstance(obj, Mapping):
        return tuple(sorted((str(k), _canon(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, _canon(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    return repr(obj)


def _sig(*parts) -> str:
    return hashlib.blake2b(repr(tuple(_canon(p) for p in parts)).encode(),
                           digest_size=16).hexdigest()


# --------------------------------------------------------------------------- #
# Requests and jobs
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class CodesignRequest:
    """One unified request: a profile suite plus a ``CodesignSpec``.

    ``kind`` picks the entry point; the spec carries budgets, envelopes,
    the frontier schedule, descent knobs and the backend.  ``machines``
    (co-design kinds) defaults to the paper's named variants; ``space``
    (sweep kinds) defaults to ``ParamSpace.default()``.

    ``profiles`` may be a model-zoo suite name (``"zoo"``,
    ``"zoo-smoke:train"``, ...) -- or ``None``, in which case
    ``spec.suite`` must name the suite (validated by the ONE
    ``CodesignSpec.validate`` path); either way the name is resolved
    against the zoo cache at execution time by ``_as_profile_batch``.
    """

    kind: str
    profiles: Any                       # suite, ProfileBatch, or joint groups
    spec: CodesignSpec = dataclasses.field(default_factory=CodesignSpec)
    machines: Any = None                # co-design seeds
    space: Optional[ParamSpace] = None  # sweep design space
    include_named: Sequence = ()
    beta_machine: Any = None
    num_shards: Optional[int] = None    # mega_sweep
    keep_top: int = 16                  # mega_sweep pre-filter width
    timeout: Optional[float] = None     # seconds, queue wait included
    warm: bool = True                   # frontier: allow cache warm start
    stream: bool = False                # mega_sweep: regenerate per shard
    checkpoint_dir: Optional[str] = None  # mega_sweep: resumable state
    resume: bool = False                # mega_sweep: skip completed shards

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown request kind {self.kind!r}; "
                             f"have {KINDS}")
        self.spec.validate()
        if self.profiles is None:
            if self.spec.suite is None:
                raise ValueError(
                    "profiles is required unless spec.suite names a "
                    "model-zoo suite (e.g. CodesignSpec(suite='zoo-smoke'))")
            self.profiles = self.spec.suite

    # -- resolved sweep parameters (spec field > historical default) ----- #

    def _sweep_params(self) -> Dict[str, Any]:
        s = self.spec
        return dict(
            n=(1024 if self.kind == "mega_sweep" else 256)
              if s.n is None else s.n,
            mode="random" if s.sweep_mode is None else s.sweep_mode,
            seed=0 if s.seed is None else s.seed,
            timing_model="serial" if s.timing_model is None
                         else s.timing_model,
            clamp=True if s.clamp is None else s.clamp,
            backend=s.backend,
        )

    def batch_key(self) -> Optional[str]:
        """Micro-batch compatibility: requests sharing this key score the
        same population under the same kernel configuration, so their
        suites may ride one SoA pass.  Per-request beta targets are
        resolved into per-app vectors and concatenated, so they do NOT
        constrain compatibility."""
        if self.kind != "sweep":
            return None
        p = self._sweep_params()
        return _sig("batch", self.space, p["n"], p["mode"], p["seed"],
                    self.include_named, self.beta_machine,
                    p["timing_model"], p["clamp"], p["backend"])

    def memo_key(self) -> str:
        """Exact-request identity: byte-identical repeats share a result."""
        return _sig("memo", self.kind, self.profiles, self.spec,
                    self.machines, self.space, self.include_named,
                    self.beta_machine, self.num_shards, self.keep_top,
                    self.warm, self.stream, self.checkpoint_dir,
                    self.resume)


@dataclasses.dataclass
class Job:
    jid: str
    request: CodesignRequest
    state: str = PENDING
    result: Any = None
    error: Optional[BaseException] = None
    events: List[dict] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    cancel_requested: bool = False
    cache: Optional[str] = None        # None | "memo" | "warm"

    @property
    def deadline(self) -> Optional[float]:
        t = self.request.timeout
        return None if t is None else self.submitted_at + t

    def snapshot(self) -> dict:
        """poll() view: plain data, no live references."""
        return {
            "jid": self.jid,
            "kind": self.request.kind,
            "state": self.state,
            "events": len(self.events),
            "cache": self.cache,
            "queued_s": ((self.started_at or time.monotonic())
                         - self.submitted_at),
            "run_s": (None if self.started_at is None else
                      (self.finished_at or time.monotonic())
                      - self.started_at),
        }


# --------------------------------------------------------------------------- #
# The service
# --------------------------------------------------------------------------- #


class CodesignService:
    """Thread-safe scoring/co-design front door (see module docstring).

    ``workers=0`` (or ``auto_start=False``) runs no threads: callers
    drive the queue synchronously with ``process_once()``/``drain()`` --
    the exact worker code path, used by the deterministic tests.
    ``device`` (``"cuda"`` by default) is where every request runs.
    """

    def __init__(self, *, workers: int = 2, max_pending: int = 64,
                 auto_start: bool = True,
                 pop_cache_bytes: int = 256 << 20,
                 device=K.DEFAULT_DEVICE):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.device = K.resolve_device(device)
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._jobs: Dict[str, Job] = {}
        self._next_id = 0
        self._stop = False
        self.max_pending = max_pending
        # caches -----------------------------------------------------------
        # population cache: LRU bounded by ``pop_cache_bytes`` (a 100M-
        # variant request must never pin ~7 GB of arrays forever; entries
        # larger than the whole budget are served but not cached)
        self._populations: "collections.OrderedDict[str, MachineBatch]" = \
            collections.OrderedDict()
        self.pop_cache_bytes = int(pop_cache_bytes)
        self._pop_bytes = 0
        self._memo: Dict[str, Any] = {}
        self._frontier_state: Dict[str, dict] = {}
        self._artifacts: Dict[str, int] = {}
        # accounting -------------------------------------------------------
        self.stats = collections.Counter()
        # workers ----------------------------------------------------------
        self._threads: List[threading.Thread] = []
        if auto_start and workers > 0:
            for i in range(workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"codesign-worker-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    # ------------------------------ client API ------------------------- #

    def submit(self, request: CodesignRequest) -> str:
        """Enqueue a request; returns a job id.

        Raises ``ServiceOverloadError`` (``status_code == 429``) when the
        pending queue is at ``max_pending`` -- overload is an immediate,
        retryable rejection, never a hang."""
        with self._cond:
            if self._stop:
                raise RuntimeError("service is shut down")
            if len(self._queue) >= self.max_pending:
                self.stats["rejected"] += 1
                raise ServiceOverloadError(
                    f"pending queue full ({self.max_pending}); retry later")
            self._next_id += 1
            job = Job(jid=f"job-{self._next_id}", request=request,
                      submitted_at=time.monotonic())
            self._jobs[job.jid] = job
            self._queue.append(job)
            self.stats["submitted"] += 1
            self._cond.notify_all()
            return job.jid

    def poll(self, jid: str) -> dict:
        with self._cond:
            return self._jobs[jid].snapshot()

    def result(self, jid: str, timeout: Optional[float] = None):
        """Block until the job is terminal and return its result.

        Raises the job's own error, ``JobCancelled``, ``JobTimeout`` (job
        expired), or ``TimeoutError`` (this wait expired -- the job keeps
        running)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            job = self._jobs[jid]
            while job.state not in TERMINAL:
                wait = (None if deadline is None
                        else max(deadline - time.monotonic(), 0.0))
                if wait == 0.0:
                    raise TimeoutError(f"result({jid!r}) wait expired")
                self._cond.wait(timeout=wait if wait is None else
                                min(wait, 0.1))
            if job.state == DONE:
                return job.result
            if job.state == CANCELLED:
                raise JobCancelled(jid)
            if job.state == TIMEOUT:
                raise JobTimeout(jid)
            raise job.error

    def cancel(self, jid: str) -> bool:
        """Cancel a job.  Pending jobs die immediately; a running
        mega-sweep aborts at its next shard boundary; other running kinds
        finish their compute but report ``cancelled`` and discard the
        result."""
        with self._cond:
            job = self._jobs[jid]
            if job.state in TERMINAL:
                return False
            job.cancel_requested = True
            if job.state == PENDING:
                try:
                    self._queue.remove(job)
                except ValueError:
                    pass
                self._finish(job, CANCELLED)
            return True

    def stream(self, jid: str, poll_s: float = 0.02) -> Iterator[dict]:
        """Yield a job's progress events as they arrive, ending with one
        terminal event (``done``/``error``/``cancelled``/``timeout``) --
        the generator always terminates once the job does."""
        seen = 0
        while True:
            with self._cond:
                job = self._jobs[jid]
                while seen >= len(job.events) and job.state not in TERMINAL:
                    self._cond.wait(timeout=poll_s)
                fresh = list(job.events[seen:])
                state = job.state
            seen += len(fresh)
            for ev in fresh:
                yield ev
            if state in TERMINAL and seen >= len(self._jobs[jid].events):
                yield {"event": state, "jid": jid}
                return

    def render(self, jid: str, fmt: str = "markdown",
               top_k: Optional[int] = None,
               timeout: Optional[float] = None):
        """Render a finished job through the uniform result protocol.

        Dispatches ONLY on ``markdown(top_k=...)`` / ``to_json(top_k=...)``
        -- every sweep/co-design result type implements both, so the
        service needs exactly one renderer per format."""
        result = self.result(jid, timeout=timeout)
        return render_result(result, fmt=fmt, top_k=top_k)

    def shutdown(self, wait: bool = True) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=5.0)

    # ------------------------- synchronous driving ---------------------- #

    def process_once(self) -> bool:
        """Dequeue and run one job (plus any micro-batch riders) on the
        calling thread; returns False when the queue is empty.  This is
        the worker loop body -- tests drive it for determinism."""
        with self._cond:
            job = self._dequeue()
        if job is None:
            return False
        self._execute(job)
        return True

    def drain(self) -> None:
        while self.process_once():
            pass

    # ----------------------------- internals ---------------------------- #

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop and not self._queue:
                    return
                job = self._dequeue()
            if job is not None:
                self._execute(job)

    def _dequeue(self) -> Optional[Job]:
        """Pop the oldest pending job; expire it instead if its deadline
        already passed (graceful degradation: late jobs cost nothing)."""
        while self._queue:
            job = self._queue.popleft()
            if job.deadline is not None and time.monotonic() > job.deadline:
                self._finish(job, TIMEOUT)
                continue
            job.state = RUNNING
            job.started_at = time.monotonic()
            return job
        return None

    def _finish(self, job: Job, state: str, result=None, error=None) -> None:
        """Caller must hold (or not need) consistency: always locks."""
        job.state = state
        job.result = result
        job.error = error
        job.finished_at = time.monotonic()
        self.stats[state] += 1
        self._cond.notify_all()

    def _complete(self, job: Job, result) -> None:
        with self._cond:
            if job.cancel_requested:
                self._finish(job, CANCELLED)
            elif (job.deadline is not None
                  and time.monotonic() > job.deadline):
                self._finish(job, TIMEOUT)
            else:
                self._finish(job, DONE, result=result)

    def _fail(self, job: Job, exc: BaseException) -> None:
        with self._cond:
            if isinstance(exc, _AbortRun):
                self._finish(job, exc.state)
            else:
                self._finish(job, ERROR, error=exc)

    # -- execution -------------------------------------------------------- #

    def _execute(self, job: Job) -> None:
        req = job.request
        memo_key = req.memo_key()
        with self._cond:
            if memo_key in self._memo:
                self.stats["memo_hits"] += 1
                job.cache = "memo"
                job.events.append({"event": "cached", "jid": job.jid})
                self._finish(job, DONE, result=self._memo[memo_key])
                return
            self.stats["memo_misses"] += 1
            riders = (self._claim_riders(job)
                      if req.kind == "sweep" else [])
        group = [job] + riders
        try:
            if req.kind == "sweep":
                self._run_sweep_group(group)
                return
            runner = {
                "mega_sweep": self._run_mega_sweep,
                "constrained": self._run_constrained,
                "joint": self._run_joint,
                "frontier": self._run_frontier,
                "pack": self._run_pack,
                "bilevel": self._run_bilevel,
            }[req.kind]
            result = runner(job)
        except BaseException as exc:      # noqa: BLE001 -- jobs never crash workers
            self._fail(job, exc)
            return
        with self._cond:
            self._memo.setdefault(memo_key, result)
        self._complete(job, result)

    def _claim_riders(self, job: Job) -> List[Job]:
        """Pull every still-pending sweep job compatible with ``job`` out
        of the queue (micro-batch admission).  Lock held by caller."""
        key = job.request.batch_key()
        riders = []
        for other in list(self._queue):
            if other.request.kind != "sweep":
                continue
            if other.request.batch_key() != key:
                continue
            if (other.deadline is not None
                    and time.monotonic() > other.deadline):
                continue
            self._queue.remove(other)
            other.state = RUNNING
            other.started_at = time.monotonic()
            riders.append(other)
        return riders

    # -- sweeps ----------------------------------------------------------- #

    @staticmethod
    def _pop_nbytes(pop: MachineBatch) -> int:
        from repro_torch.core.sweep import SWEEP_PARAMS

        return (sum(getattr(pop, f).nbytes for f in SWEEP_PARAMS)
                + sum(len(n) for n in pop.names))

    def _population_for(self, space: ParamSpace, n: int, mode: str,
                        seed: int, include_named) -> MachineBatch:
        key = _sig("pop", space, n, mode, seed, include_named)
        with self._cond:
            pop = self._populations.get(key)
            if pop is not None:
                self._populations.move_to_end(key)
                self.stats["pop_hits"] += 1
                return pop
            self.stats["pop_misses"] += 1
        pop = _population(space, n, mode, seed, list(include_named))
        with self._cond:
            cached = self._populations.get(key)
            if cached is not None:  # another worker raced us to it
                self._populations.move_to_end(key)
                return cached
            size = self._pop_nbytes(pop)
            if size <= self.pop_cache_bytes:
                self._populations[key] = pop
                self._pop_bytes += size
                while (self._pop_bytes > self.pop_cache_bytes
                       and len(self._populations) > 1):
                    _, old = self._populations.popitem(last=False)
                    self._pop_bytes -= self._pop_nbytes(old)
                    self.stats["pop_evictions"] += 1
            else:
                self.stats["pop_uncacheable"] += 1
            return pop

    def _backend_name(self, name) -> str:
        """The backend a sweep request actually runs on this device
        (``None`` resolves to ``"cuda"`` on a card, ``"torch"`` on the
        host)."""
        return K.get_backend(name, self.device).name

    def _note_artifact(self, kind: str, shape, backend, constraint_sig) -> None:
        """Track the (population shape, backend, constraint signature)
        artifact key of each request: repeat keys count as hits."""
        key = _sig("artifact", kind, tuple(shape), str(backend),
                   constraint_sig)
        with self._cond:
            seen = self._artifacts.get(key, 0)
            self._artifacts[key] = seen + 1
            self.stats["artifact_hits" if seen else "artifact_misses"] += 1

    def _run_sweep_group(self, group: List[Job]) -> None:
        """ONE SoA pass for every job in ``group``: concatenate suites,
        score once over the shared (cached) population, scatter rows back.
        Kernel rows are per-app independent, so each slice is
        byte-identical to that request run alone (pinned in tests)."""
        lead = group[0].request
        p = lead._sweep_params()
        space = lead.space or ParamSpace.default()
        include_named = list(lead.include_named)
        try:
            pop = self._population_for(space, p["n"], p["mode"], p["seed"],
                                       include_named)
            be = K.get_backend(p["backend"], self.device)
            pbs = [_as_profile_batch(j.request.profiles) for j in group]
            betas = [
                _resolve_beta(pb, j.request.spec.beta, lead.beta_machine,
                              include_named, space, be)
                for pb, j in zip(pbs, group)]
            suite = ProfileBatch.concat(*pbs) if len(pbs) > 1 else pbs[0]
            self._note_artifact(
                "sweep", (len(suite), len(pop)), be.name,
                _sig(p["timing_model"], p["clamp"]))
            full = run_sweep(
                suite, space=space, n=p["n"], mode=p["mode"], seed=p["seed"],
                include_named=include_named, beta=np.concatenate(betas),
                beta_machine=lead.beta_machine,
                timing_model=p["timing_model"], clamp=p["clamp"],
                backend=be, population=pop)
        except BaseException as exc:      # noqa: BLE001
            for job in group:
                self._fail(job, exc)
            return
        if len(group) > 1:
            self.stats["batched_groups"] += 1
            self.stats["batched_requests"] += len(group)
        lo = 0
        for job, pb in zip(group, pbs):
            hi = lo + len(pb)
            res = full.app_slice(range(lo, hi)) if len(group) > 1 else full
            lo = hi
            with self._cond:
                self._memo.setdefault(job.request.memo_key(), res)
            self._complete(job, res)

    def _run_mega_sweep(self, job: Job):
        req = job.request
        p = req._sweep_params()
        space = req.space or ParamSpace.default()
        spec = req.spec

        def progress(s, num_shards, lo, hi):
            with self._cond:
                if job.cancel_requested:
                    raise _AbortRun(CANCELLED)
                if (job.deadline is not None
                        and time.monotonic() > job.deadline):
                    raise _AbortRun(TIMEOUT)
                job.events.append({"event": "shard", "jid": job.jid,
                                   "shard": int(s),
                                   "num_shards": int(num_shards),
                                   "lo": int(lo), "hi": int(hi)})
                self._cond.notify_all()

        pb = _as_profile_batch(req.profiles)
        self._note_artifact("mega_sweep", (len(pb), p["n"]),
                            self._backend_name(p["backend"]),
                            _sig(p["timing_model"], p["clamp"],
                                 req.num_shards, req.keep_top, req.stream))
        return shard_sweep(
            pb, space=space, n=p["n"], mode=p["mode"], seed=p["seed"],
            include_named=list(req.include_named), beta=spec.beta,
            beta_machine=req.beta_machine, timing_model=p["timing_model"],
            clamp=p["clamp"], backend=p["backend"], device=self.device,
            num_shards=req.num_shards, keep_top=req.keep_top,
            cost_model=spec.cost_model or DEFAULT_COST_MODEL,
            progress=progress, stream=req.stream,
            checkpoint_dir=req.checkpoint_dir, resume=req.resume)

    # -- co-design -------------------------------------------------------- #

    def _seeds(self, req: CodesignRequest):
        if req.machines is not None:
            return req.machines
        return MachineBatch.from_models(VARIANTS)

    def _constraint_sig(self, spec: CodesignSpec) -> str:
        return _sig(spec.area_budget, spec.power_budget, spec.area_envelope,
                    spec.mode, spec.projection, spec.optimize_links)

    # The co-design kinds descend through the plain float64 torch math
    # (autograd needs it; the kernels have no backward), on the device.
    DESCENT_BACKEND = "torch"

    def _run_constrained(self, job: Job):
        from repro_torch.core.constrained import constrained_codesign

        req = job.request
        seeds = self._seeds(req)
        self._note_artifact("constrained", (len(seeds),),
                            self.DESCENT_BACKEND,
                            self._constraint_sig(req.spec))
        return constrained_codesign(req.profiles, seeds, spec=req.spec,
                                    device=self.device)

    def _run_joint(self, job: Job):
        from repro_torch.core.constrained import joint_codesign

        req = job.request
        seeds = self._seeds(req)
        self._note_artifact("joint", (len(seeds),), self.DESCENT_BACKEND,
                            self._constraint_sig(req.spec))
        return joint_codesign(req.profiles, seeds, spec=req.spec,
                              device=self.device)

    def _run_pack(self, job: Job):
        from repro_torch.core.packing import pack_codesign

        req = job.request
        seeds = self._seeds(req)
        spec = req.spec
        self._note_artifact(
            "pack", (len(seeds), spec.num_machines or 4),
            self.DESCENT_BACKEND, self._constraint_sig(spec))
        # ``PackingResult`` joins the response path purely through the
        # uniform markdown/to_json protocol -- render_result needs no
        # isinstance knowledge of it.
        return pack_codesign(req.profiles, seeds, spec=spec,
                             device=self.device)

    def _run_bilevel(self, job: Job):
        from repro_torch.core.implicit import bilevel_codesign

        req = job.request
        seeds = self._seeds(req)
        spec = req.spec
        if spec.total_budget is None:
            raise ValueError("kind='bilevel' needs spec.total_budget "
                             "(the budget split across area and power)")
        self._note_artifact(
            "bilevel", (len(seeds),), self.DESCENT_BACKEND,
            _sig(spec.total_budget, spec.split0, spec.outer_steps,
                 spec.area_envelope, spec.projection))
        # ``BilevelResult`` joins the response path purely through the
        # uniform markdown/to_json protocol, like pack does.
        return bilevel_codesign(req.profiles, seeds, spec=spec,
                                device=self.device)

    def _run_frontier(self, job: Job):
        from repro_torch.core.frontier import frontier_codesign

        req = job.request
        seeds = self._seeds(req)
        spec = req.spec
        if spec.budgets is None:
            raise ValueError("frontier requests need spec.budgets")
        # Continuation cache: keyed by everything EXCEPT the schedule, so
        # a new schedule over the same suite/seeds/constraints can resume
        # from the nearest already-solved budget instead of cold seeds.
        state_key = _sig("frontier", req.profiles, req.machines,
                         dataclasses.replace(spec, budgets=None),
                         req.include_named)
        warm_theta = warm_lr = None
        with self._cond:
            entry = self._frontier_state.get(state_key)
            warm_enabled = req.warm and (spec.warm_start is None
                                         or spec.warm_start)
            if entry and warm_enabled:
                loosest = max(float(b) for b in spec.budgets)
                solved = sorted(entry["thetas"])
                # nearest solved budget, preferring the tightest >= loosest
                ge = [b for b in solved if b >= loosest]
                pick = min(ge) if ge else max(solved)
                warm_theta = entry["thetas"][pick]
                warm_lr = entry["lr"]
                self.stats["frontier_warm_hits"] += 1
                job.cache = "warm"
            else:
                self.stats["frontier_warm_misses"] += 1
        self._note_artifact("frontier", (len(seeds),), self.DESCENT_BACKEND,
                            self._constraint_sig(spec))
        res = frontier_codesign(req.profiles, seeds, spec=spec,
                                warm_theta=warm_theta, warm_lr=warm_lr,
                                keep_state=True, device=self.device)
        with self._cond:
            entry = self._frontier_state.setdefault(
                state_key, {"thetas": {}, "lr": None})
            entry["thetas"].update(res.continuation or {})
            entry["lr"] = res.final_lr
        return res


# --------------------------------------------------------------------------- #
# Response renderers (uniform result protocol)
# --------------------------------------------------------------------------- #


def render_result(result, fmt: str = "markdown",
                  top_k: Optional[int] = None):
    """Render ANY sweep/co-design result: dispatches exclusively on the
    uniform protocol -- ``markdown(top_k=...)`` for fmt="markdown",
    ``to_json(top_k=...)`` for fmt="json".  No isinstance checks: a new
    result type joins the service by implementing the two methods.

    >>> class Fake:
    ...     def markdown(self, top_k=None): return f"md top_k={top_k}"
    ...     def to_json(self, top_k=None): return {"top_k": top_k}
    >>> render_result(Fake(), "markdown", top_k=3)
    'md top_k=3'
    >>> render_result(Fake(), "json")["top_k"] is None
    True
    >>> render_result(object())
    Traceback (most recent call last):
        ...
    TypeError: result type 'object' does not implement the result protocol (markdown/to_json)
    """
    if not (callable(getattr(result, "markdown", None))
            and callable(getattr(result, "to_json", None))):
        raise TypeError(
            f"result type {type(result).__name__!r} does not implement "
            "the result protocol (markdown/to_json)")
    if fmt == "markdown":
        return result.markdown(top_k=top_k)
    if fmt == "json":
        return result.to_json(top_k=top_k)
    raise ValueError(f"unknown render format {fmt!r}; have "
                     "('markdown', 'json')")
