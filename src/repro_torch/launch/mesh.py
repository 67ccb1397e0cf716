"""Production meshes, and the process group they live in.

The JAX package's ``repro/launch/mesh.py`` and ``launch/xla_flags.py``.
JAX builds a mesh over the devices it sees, and its dry run asks XLA for
512 placeholder host devices before JAX starts; here a mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, and the dry run's 512 placeholder devices are a *fake* process
group (``fake_world``): collectives are recorded and not run, so one
process stands for rank 0 of the production mesh.  A process has one
default group, so the fake world owns its process, as the JAX dry run owns
its ``XLA_FLAGS``.  ``ensure_world_size`` fails loudly when the group is
smaller than a mesh needs, as ``ensure_host_device_count`` does: a mesh
larger than the world is an error, never a smaller mesh.

``fake_world`` imports the fake group from ``torch.testing._internal``,
which is PyTorch's internal API; it is imported here and nowhere else.
There is no ``use_mesh``: a DTensor carries its mesh, and the activation
rules (``distributed.ctx.use_rules``) carry it for the model.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEVICES_PER_POD = 256  # 16 x 16

#: The fake world's size: the JAX dry run's 512 host devices.
FAKE_WORLD = 512


def fake_world(n: int = FAKE_WORLD) -> int:
    """Start a fake default process group of ``max(n, FAKE_WORLD)`` ranks
    (this process is rank 0) unless one is running; return its size.
    Refuses when a real group is running."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is running in this "
                "process; the fake world of the dry run needs a process of "
                "its own (run it in a child process)")
        ensure_world_size(n)
        return dist.get_world_size()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = max(int(n), FAKE_WORLD)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    return size


def init_world(backend: Optional[str] = None, *, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
    """Join a real process group unless one is running: from the standard
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) or from ``init_method`` (a ``file://`` store needs no
    network).  ``backend`` defaults to NCCL when the card is there, else
    Gloo."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise RuntimeError("no process group to join: set RANK / WORLD_SIZE / "
                           "MASTER_ADDR / MASTER_PORT (torchrun does) or give "
                           "init_method")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_world_size(n: int) -> None:
    """Fail loudly unless the default process group has at least ``n``
    ranks."""
    have = world_size()
    if have < int(n):
        what = (f"the {dist.get_backend()!r} process group has {have} ranks"
                if dist.is_initialized() else "no process group is running")
        raise RuntimeError(
            f"this mesh needs {n} devices but {what}: start the fake world "
            f"(launch.mesh.fake_world({n})) for a dry run, or join a group of "
            f"{n} ranks, before building the mesh")


def _device_type() -> str:
    """The meshes' device type: "cuda" for NCCL, and for the fake world,
    whose meshes stand for the card's (DTensor then issues the all-to-all
    NCCL would run, where a CPU mesh falls back to an all-gather)."""
    return ("cuda" if dist.is_initialized() and dist.get_backend() in ("nccl", "fake")
            else "cpu")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ranks 0..prod(shape)-1 (row-major),
    its dims named ``axes``."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    ensure_world_size(n)
    ranks = torch.arange(n, dtype=torch.int64).reshape(tuple(int(s) for s in shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_variant_mesh(num_devices: Optional[int] = None):
    """1-D ``("variants",)`` mesh over every rank of the world (one a card).

    The mega-sweep data layout: the machine-variant axis is embarrassingly
    parallel (profiles replicated, variants split), so ``shard_sweep``
    wants all devices on one axis regardless of the production 2-D/3-D
    topology."""
    return make_mesh((int(num_devices or world_size()),), ("variants",))


def mesh_name(mesh) -> str:
    return "x".join(str(int(s)) for s in mesh.mesh.shape)
