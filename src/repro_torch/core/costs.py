"""Workload profiles -- the per-cell cost record every congruence pass reads.

A ``WorkloadProfile`` is the analogue of VPR's post-route netlist: the
expensive step (running one architecture x shape cell under the op
counter) runs once, and every scoring pass afterwards re-times the same
recorded costs.  The JSON format is the JAX package's, field for field, so
profiles written there load here unchanged.

Extraction: the JAX package parses the compiled XLA program
(``parse_hlo_stats``, ``profile_from_compiled``); the port runs the step
eagerly under ``OpCounter``, a ``TorchDispatchMode`` that sees every ATen
operation the step runs (forward, backward and optimizer), and
``profile_from_counts`` fills the same fields from its ``OpStats``.  The
eager program is not the XLA program: XLA fuses elementwise chains into
kernels and removes dead code, where each eager operation is a kernel of
its own.  What the counter reports is what the port runs, op by op, with
these rules (an operation with a ``CompositeImplicitAutograd`` kernel --
``matmul``, ``einsum``, ``softmax``, ``reshape`` -- is counted as the
operations it decomposes into, in any autograd mode):

==================  ======================================================
``dot_flops``       2 M N K of every mm / bmm / addmm / baddbmm /
                    convolution (``torch.utils.flop_counter``'s formulas);
                    ``dot_count`` counts them
``flops``           ``dot_flops`` + one per output element of each
                    pointwise operation (and of softmax, sort, top-k) + one
                    per input element of each reduction; copies, casts,
                    gathers, scatters and fills count none
``transcendentals`` one per output element of exp, log, tanh, sigmoid,
                    rsqrt, sqrt, pow, sin, cos, erf, gelu, silu, softplus,
                    softmax (and their backward formulas that evaluate one);
                    logsumexp one per input element
``bytes_accessed``  input + output bytes of every operation that is not a
                    view, a bare allocation or a copy to another device (a
                    host transfer, such as the MoE's ``tolist()`` of its
                    expert sizes on the card)
``hbm_bytes``       the JAX package's kernel-boundary rule
                    (``repro/core/costs.py:319-335``) with every eager
                    operation a kernel: dots and other computing operations
                    read their operands and write their results, a reduction
                    reads its operands, a gather / scatter / index / sort
                    writes its result, and each argument is read once
``argument_bytes``  the step's arguments (distinct storages); ``output_bytes``
                    its results
``peak_memory_``    the allocator's peak over the step on the card
``bytes``           (``torch.cuda.max_memory_allocated`` above what was
                    allocated before it, plus the arguments); elsewhere
                    (``meta``, the CPU) a tracker of live storages: the
                    arguments plus the largest total of the storages the
                    step had created and not yet freed
collectives         per kind (all-gather, all-reduce, reduce-scatter,
                    all-to-all), the bytes of each collective's first
                    operand on this device (the JAX package's convention),
                    also into ``hbm_bytes`` (the payload passes HBM) and,
                    when its group's ranks span more than one pod
                    (``rank // devices_per_pod``), into
                    ``pod_collective_bytes``; zero on one device
==================  ======================================================

Sharded steps (``launch.extract.run_cell`` with a mesh): the arguments are
DTensors (``torch.distributed.tensor``).  The counter lets DTensor run each
DTensor operation and counts what DTensor then issues on this device --
the local operations at local shapes and the functional collectives
(``_c10d_functional.*``, DTensor's ``shard_dim_alltoall``) -- so every
count is per device (``num_devices`` the mesh's size).  The operations
DTensor's sharding propagation runs on fake tensors at the global shapes
to learn output shapes are not the step's work and are not counted.  The
collectives' group names resolve to global ranks through the process
group, a fake one in the dry run (``launch.mesh.fake_world``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class WorkloadProfile:
    """Everything the timing/congruence/roofline passes need for one cell.

    FLOPs/bytes are PER DEVICE (the per-device SPMD program's work).
    Roofline terms therefore divide by per-chip rates; multiply by
    ``num_devices`` for global totals.
    """

    name: str
    arch: str = ""
    shape: str = ""
    mesh: str = ""
    step_kind: str = "train"      # train | prefill | decode
    num_devices: int = 1
    flops: float = 0.0            # per-device HLO FLOPs
    bytes_accessed: float = 0.0   # per-device HLO bytes
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS}
    )
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    pod_collective_bytes: float = 0.0   # share of traffic crossing the pod axis
    dot_flops: float = 0.0
    dot_count: int = 0
    hbm_bytes: float = 0.0              # per-device HBM-traffic estimate
    peak_memory_bytes: float = 0.0      # per-device
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    model_flops: float = 0.0            # analytic 6*N*D (train) / 2*N*D (infer), GLOBAL
    tokens: int = 0
    params: float = 0.0                 # total parameter count
    params_active: float = 0.0          # active (MoE-aware) parameter count
    compile_seconds: float = 0.0
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    @property
    def global_flops(self) -> float:
        return self.flops * self.num_devices

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs -- catches remat/redundancy waste."""
        if self.global_flops <= 0:
            return math.nan
        return self.model_flops / self.global_flops

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "WorkloadProfile":
        known = {f.name for f in dataclasses.fields(WorkloadProfile)}
        return WorkloadProfile(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @staticmethod
    def load(path: str) -> "WorkloadProfile":
        with open(path) as f:
            return WorkloadProfile.from_json(json.load(f))


# --------------------------------------------------------------------------- #
# Extraction: an op counter over the eager step
# --------------------------------------------------------------------------- #

_aten = torch.ops.aten

#: Allocations that write nothing, and host reads: not counted.  The MoE's
#: ``bincount`` of its experts' row counts, read by the host, is left out
#: too: a ``meta`` run has no routing to count (``models.layers``).
_ALLOCATIONS = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._local_scalar_dense, _aten.bincount})
#: Views that the schema does not mark as views.
_VIEWS = frozenset({_aten._unsafe_view, _aten.detach_, _aten.lift_fresh})
#: Copies, which count unless they move a tensor to another device.
_COPIES = frozenset({_aten._to_copy, _aten.copy_})
#: Computing operations that are neither pointwise nor reductions: one
#: flop per output element.
_OTHER_COMPUTE = frozenset({
    _aten._softmax, _aten._log_softmax, _aten._softmax_backward_data,
    _aten._log_softmax_backward_data, _aten.sort, _aten.argsort, _aten.topk,
    _aten.cumsum, _aten.floor_divide})
#: Operations whose traffic the kernel-boundary rule charges to their
#: result alone (the HLO rule's gather / scatter / dynamic-slice / sort).
_RESULT_ONLY = frozenset({
    _aten.index, _aten.index_select, _aten._unsafe_index, _aten.gather,
    _aten.index_put, _aten.index_put_, _aten._index_put_impl_, _aten.scatter,
    _aten.scatter_, _aten.scatter_add, _aten.scatter_add_, _aten.scatter_reduce,
    _aten.slice_scatter, _aten.select_scatter, _aten.embedding,
    _aten.embedding_dense_backward, _aten.sort, _aten.argsort, _aten.topk})
#: Operations whose output elements each take one transcendental.
_TRANSCENDENTAL = frozenset({
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2,
    _aten.log10, _aten.tanh, _aten.sigmoid, _aten.rsqrt, _aten.sqrt, _aten.pow,
    _aten.sin, _aten.cos, _aten.erf, _aten.erfc, _aten.gelu, _aten.gelu_backward,
    _aten.silu, _aten.silu_backward, _aten.softplus, _aten.softplus_backward,
    _aten._softmax, _aten._log_softmax})


#: Collective operations (``torch.distributed``'s functional collectives,
#: which DTensor issues, and DTensor's own all-to-all) by kind.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
#: Their bookkeeping, which moves nothing.
_COLLECTIVE_PLUMBING = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
_COLLECTIVE_NAMESPACES = frozenset({"_c10d_functional", "c10d_functional", "_dtensor"})


def _group_ranks(name: str):
    """The global ranks of the process group ``name`` (a functional
    collective's group argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


@dataclasses.dataclass
class OpStats:
    """What ``OpCounter`` counted (the module docstring's rules)."""

    flops: float = 0.0
    dot_flops: float = 0.0
    dot_count: int = 0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    hbm_bytes: float = 0.0
    ops: int = 0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    peak_memory_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVE_KINDS})
    pod_collective_bytes: float = 0.0


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (this device's tensor); any other tensor."""
    local = getattr(t, "_local_tensor", None)
    return local if isinstance(local, torch.Tensor) else t


def _tensors(tree):
    """The tensors of a tree, DTensors as their local shards; a module
    stands for its parameters and buffers."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append(_local(leaf))
        elif isinstance(leaf, torch.nn.Module):
            out.extend(_local(t) for t in leaf.parameters())
            out.extend(_local(t) for t in leaf.buffers())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _crosses_devices(args, outs) -> bool:
    devices = {t.device for t in _tensors(args)} | {t.device for t in outs}
    return len(devices) > 1


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (a module's
    parameters count through ``parameters()``)."""
    seen = {}
    for t in _tensors(tree):
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


class _LiveStorages:
    """The storages a step creates, added when an operation returns one and
    taken off when the storage is freed (its Python object is finalised
    with it, so a weak reference follows the storage, not the tensor)."""

    def __init__(self, known):
        self.known = set(known)
        self.live = 0
        self.peak = 0

    def see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known:
            return
        self.known.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.known.discard(key)
        self.live -= n


class OpCounter(TorchDispatchMode):
    """Count the ATen operations run inside ``with OpCounter(args) as c:``
    into ``c.stats`` (``OpStats``).  ``args`` are the step's arguments:
    their storages are the step's inputs (``argument_bytes``) and are not
    counted as created.  ``track_memory`` follows live storages (off on the
    card, where the allocator's peak is read instead)."""

    def __init__(self, args=(), *, track_memory: bool = True,
                 devices_per_pod: int = 0):
        super().__init__()
        self.stats = OpStats()
        keys = {_storage_key(t) for t in _tensors(args)}
        self.stats.argument_bytes = float(storage_bytes(args))
        self._live = _LiveStorages(keys) if track_memory else None
        self.devices_per_pod = int(devices_per_pod)
        self._ranks: Dict[str, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if types and any(_is_wrapper(t) for t in types):
            # a DTensor operation: let DTensor run it, and count the local
            # operations and collectives it issues as they come back here
            return NotImplemented
        if any(_is_fake(t) for t in tree_flatten((args, kwargs))[0]):
            # sharding propagation's shadow of an op at its global shape
            return func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            out = func(*args, **kwargs)
            self._collective(func, args, out)
            return out
        packet = func.overloadpacket
        if packet not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        return out

    def _collective(self, func, args, out) -> None:
        """A collective: its first operand's bytes (this device's), by kind,
        into ``hbm_bytes`` too, and into ``pod_collective_bytes`` when its
        group spans pods."""
        name = func.overloadpacket.__name__
        if name in _COLLECTIVE_PLUMBING:
            return
        kind = _COLLECTIVES.get(name)
        if kind is None:
            raise NotImplementedError(f"op counter: unknown collective {func}")
        if self._live is not None:
            for t in _tensors(out):
                self._live.see(t)
        ins = [t for t in tree_flatten(args[0])[0] if isinstance(t, torch.Tensor)]
        nbytes = float(sum(_nbytes(t) for t in ins))
        st = self.stats
        st.ops += 1
        st.collective_bytes[kind] += nbytes
        st.collective_counts[kind] += 1
        st.hbm_bytes += nbytes
        st.bytes_accessed += nbytes + sum(_nbytes(t) for t in _tensors(out))
        if self.devices_per_pod > 0:
            group = next(a for a in reversed(args) if isinstance(a, str))
            if group not in self._ranks:
                self._ranks[group] = _group_ranks(group)
            if len({r // self.devices_per_pod for r in self._ranks[group]}) > 1:
                st.pod_collective_bytes += nbytes

    def _count(self, func, packet, args, kwargs, out) -> None:
        outs = _tensors(out)
        if self._live is not None:
            for t in outs:
                self._live.see(t)
        if func.is_view or packet in _VIEWS or packet in _ALLOCATIONS:
            return
        if packet in _COPIES and _crosses_devices(args, outs):
            return   # a host transfer (``tolist()`` of a card tensor), not device work
        st = self.stats
        st.ops += 1
        ins = _tensors((args, kwargs))
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        out_elems = sum(t.numel() for t in outs)
        st.bytes_accessed += in_bytes + out_bytes
        tags = func.tags
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            st.dot_flops += f
            st.dot_count += 1
            st.flops += f
            st.hbm_bytes += in_bytes + out_bytes
        elif torch.Tag.reduction in tags:
            in_elems = ins[0].numel() if ins else 0
            st.flops += in_elems
            st.hbm_bytes += in_bytes
            if packet is _aten.logsumexp:
                st.transcendentals += in_elems
        elif packet in _RESULT_ONLY:
            st.hbm_bytes += out_bytes
            if packet in _OTHER_COMPUTE:
                st.flops += out_elems
        else:
            if torch.Tag.pointwise in tags and packet is not _aten.clone:
                st.flops += out_elems
            elif packet in _OTHER_COMPUTE:
                st.flops += out_elems
            st.hbm_bytes += in_bytes + out_bytes
        if packet in _TRANSCENDENTAL:
            st.transcendentals += out_elems

    def finish(self, result, *, peak_memory_bytes: Optional[float] = None) -> OpStats:
        """Close the count with the step's ``result``: its bytes, the
        arguments read once into ``hbm_bytes``, and the peak (the tracker's
        unless ``peak_memory_bytes`` is given)."""
        st = self.stats
        st.output_bytes = float(storage_bytes(result))
        st.hbm_bytes += st.argument_bytes
        if peak_memory_bytes is not None:
            st.peak_memory_bytes = float(peak_memory_bytes)
        elif self._live is not None:
            st.peak_memory_bytes = st.argument_bytes + float(self._live.peak)
        return st


def _is_wrapper(t) -> bool:
    """True for the DTensor class (a dispatch ``types`` entry)."""
    return t.__name__ == "DTensor" and t.__module__.startswith("torch.distributed.tensor")


def _is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def profile_from_counts(name: str, stats: OpStats, *, arch: str = "",
                        shape: str = "", mesh: str = "",
                        step_kind: str = "train", num_devices: int = 1,
                        devices_per_pod: int = 0, model_flops: float = 0.0,
                        tokens: int = 0, params: float = 0.0,
                        params_active: float = 0.0,
                        compile_seconds: float = 0.0,
                        meta: Optional[dict] = None) -> WorkloadProfile:
    """A ``WorkloadProfile`` from an ``OpCounter``'s counts, per device on
    ``num_devices`` (the counterpart of the JAX package's
    ``profile_from_compiled``); ``devices_per_pod`` is recorded in
    ``meta`` as the counter applied it to ``pod_collective_bytes``."""
    meta = dict(meta or {})
    if devices_per_pod:
        meta.setdefault("devices_per_pod", int(devices_per_pod))
    return WorkloadProfile(
        name=name, arch=arch, shape=shape, mesh=mesh, step_kind=step_kind,
        num_devices=int(num_devices),
        flops=float(stats.flops),
        bytes_accessed=float(stats.bytes_accessed),
        transcendentals=float(stats.transcendentals),
        collective_bytes={k: float(stats.collective_bytes.get(k, 0.0))
                          for k in COLLECTIVE_KINDS},
        collective_counts={k: int(stats.collective_counts.get(k, 0))
                           for k in COLLECTIVE_KINDS},
        pod_collective_bytes=float(stats.pod_collective_bytes),
        dot_flops=float(stats.dot_flops),
        dot_count=int(stats.dot_count),
        hbm_bytes=float(stats.hbm_bytes),
        peak_memory_bytes=float(stats.peak_memory_bytes),
        argument_bytes=float(stats.argument_bytes),
        output_bytes=float(stats.output_bytes),
        temp_bytes=max(0.0, float(stats.peak_memory_bytes - stats.argument_bytes)),
        model_flops=model_flops,
        tokens=tokens,
        params=params,
        params_active=params_active,
        compile_seconds=compile_seconds,
        meta=meta,
    )
