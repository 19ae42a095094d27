"""Multi-process scale-out for the batched filter over ``torch.distributed``
(port of ``msckf_tpu/parallel/multihost.py``).

PyTorch's idiom is one process per card: each rank filters its own rows of
the trajectory batch on its own device with ``batched_run_sequence``. The
filter needs no collectives (trajectories are independent), so a rank
never waits on another while it filters; the ranks meet only where a
caller gathers results (``gather_global``, an explicit all-gather along the
batch axis, which is how every rank sees the whole batch, as the JAX
package's global arrays let it).

A launch by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) is joined by ``init_distributed()`` with
no arguments; without that environment and without arguments the process
stays single, and every function here works on a one-rank mesh without
``torch.distributed`` being initialised, as the JAX module degrades to the
local mesh.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_map

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.ops.device import resolve_device
from msckf_tpu_torch.parallel.batched import batched_run_sequence

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> bool:
    """Join a multi-process group; returns True when there is more than one
    process.

    With no address and no process count, it joins a launch started by
    ``torchrun`` (its environment variables), and without them it stays
    single-process and returns False. With them it calls
    ``init_process_group`` on ``tcp://{coordinator_address}``. A second
    call in the same process is tolerated.

    ``backend`` is NCCL for ``device`` on CUDA (the default) and gloo for
    ``device="cpu"`` unless given. NCCL refuses two ranks on one card, so
    ranks that share a card pass ``backend="gloo"``, which also carries
    CUDA tensors."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    from_env = coordinator_address is None and num_processes is None
    if from_env and not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    if from_env:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def _local_rank() -> int:
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: the CPU, or ``cuda:LOCAL_RANK``
    modulo the visible cards (ranks that share a card share its index)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def _one_rank_mesh(device_type: str, names: tuple[str, ...]) -> DeviceMesh:
    """A mesh of this one process, with every dimension of size 1, made
    without a process group."""
    return DeviceMesh(device_type, torch.zeros((1,) * len(names), dtype=torch.int),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def mesh_for(device, shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over every rank of the process group
    (one-rank without one) on ``device``'s type (the GPU unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks, the group has {world}")
    if not dist.is_initialized():
        return _one_rank_mesh(dev.type, names)
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def global_data_mesh(device=None) -> DeviceMesh:
    """The ``("data",)`` mesh over every rank, each on ``rank_device``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return mesh_for(device, (world,), ("data",))


def mesh_coordinate(mesh: DeviceMesh, dim: str) -> int:
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(dim)]


def mesh_group(mesh: DeviceMesh, dim: str):
    """The process group along ``dim``; None without a process group."""
    return mesh.get_group(dim) if dist.is_initialized() else None


def shard_global_batch(tree, mesh: DeviceMesh):
    """This rank's rows of a global batch, placed on its device: each rank
    passes its LOCAL slice of the leading axis (the same shapes on every
    rank); 0-d leaves are the same on every rank. The result is the local
    shard itself: ranks meet only in ``gather_global``."""
    dev = rank_device(mesh)
    return tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim`` in rank
    order (a collective even in a group of one); ``x`` itself without a
    group."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_global(tree, mesh: DeviceMesh):
    """Every leaf with a leading batch axis all-gathered along it over the
    ``"data"`` dimension: each rank gets the whole batch in rank order.
    0-d leaves stay as they are."""
    group = mesh_group(mesh, "data")
    return tree_map(lambda x: x if x.ndim == 0 else all_gather_rows(x, group), tree)


def multihost_run_sequence(cfg: MSCKFConfig, mesh: DeviceMesh, assume_camera: bool = False):
    """``run(states, prefix, frames)``: ``batched_run_sequence`` (with
    ``batched_dispatch``) of this rank's rows on its device, the program
    every rank runs."""
    dev = rank_device(mesh)

    def run(states, prefix, frames):
        return batched_run_sequence(cfg, states, prefix, frames, assume_camera=assume_camera,
                                    device=dev)

    return run


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of a global trajectory batch;
    (0, global_batch) without a process group."""
    if not dist.is_initialized():
        return 0, global_batch
    n = dist.get_world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide process count {n}")
    per = global_batch // n
    return dist.get_rank() * per, per
