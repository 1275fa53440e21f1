"""Process groups for node-sharded runs on ``torch.distributed``.

Counterpart of ``sgp_tpu/parallel/mesh.py``. JAX holds one global array
sharded over a device mesh; here every rank is one process that holds only
its own shard, and a :class:`Mesh` is a rank grid, ``(data, model)``
(:func:`make_mesh`) or ``(host, chip)`` (:func:`make_hier_mesh`, the
two-level halo exchange's), with one process group for each axis that
spans more than one rank. NCCL is the backend on CUDA devices and gloo on
the CPU; the caller names it, nothing picks it. A one-rank axis has no
group and needs no collective, as in JAX.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from sgp_tpu_torch.utils.device import resolve_device


Axis = Union[str, Tuple[str, ...]]


@dataclasses.dataclass
class Mesh:
    """This rank's place on a rank grid: ``shape`` the size of each axis,
    ``index`` this rank's coordinate on it, ``groups`` the process group of
    each axis over more than one rank (None otherwise). A two-level mesh
    also keys the tuple axis ``("host", "chip")``: every rank, in shard
    order (``shard = host * C + chip``), as JAX ravels a mesh axis
    tuple."""
    shape: Dict[Axis, int]
    index: Dict[Axis, int]
    groups: Dict[Axis, Optional[dist.ProcessGroup]]

    def size(self, axis: Axis) -> int:
        return self.shape[_key(axis)]

    def group(self, axis: Axis) -> Optional[dist.ProcessGroup]:
        return self.groups[_key(axis)]

    def world_group(self) -> Optional[dist.ProcessGroup]:
        """Every rank of the mesh (None for one rank)."""
        return dist.group.WORLD if dist.is_initialized() and \
            dist.get_world_size() > 1 else None


def _key(axis: Axis) -> Axis:
    return tuple(axis) if isinstance(axis, list) else axis


def init_distributed(backend: str, coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     device=None) -> int:
    """Join the process group: from the coordinator ``host:port``, the
    process count and this process's id, or, when ``num_processes`` is
    None, from ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` as ``torchrun`` sets
    them. ``backend`` is ``"nccl"`` (one CUDA card a rank) or ``"gloo"``.
    For a CUDA ``device`` the rank's card, ``cuda:LOCAL_RANK`` (or the
    process id modulo the card count), becomes the current device.
    Returns the world size; a single process (no count, no environment)
    joins nothing and returns 1, like the JAX package; a process already
    in a group returns its world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = "WORLD_SIZE" in os.environ and num_processes is None
    world = int(os.environ["WORLD_SIZE"]) if env else (num_processes or 1)
    if world <= 1:
        return 1
    rank = int(os.environ["RANK"]) if env else process_id
    if rank is None:
        raise ValueError("--process-id is required with --num-processes")
    if device is not None and torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init = "env://" if env else f"tcp://{coordinator_address}"
    if not env and not coordinator_address:
        raise ValueError("--coordinator-address (host:port) is required "
                         "with --num-processes")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return world


def process_rank() -> int:
    """This process's rank in the process group (0 outside one): the rank
    that logs and writes a run's files."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device of this rank for a ``--device`` flag: as
    ``resolve_device`` gives it, except that in a process group a CUDA
    device named without an index (or none named) is the current card,
    the rank's after :func:`init_distributed`."""
    resolved = resolve_device(device)
    if resolved.type == "cuda" and dist.is_initialized() and (
            device is None or torch.device(device).index is None):
        return torch.device("cuda", torch.cuda.current_device())
    return resolved


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The ``(data, model)`` grid over the world's ranks (``data * model``
    must equal the world size; rank ``r`` sits at ``(r // model, r %
    model)``). Every rank builds every group, in one order, as
    ``dist.new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data * model != world:
        raise ValueError(f"mesh {data} x {model} needs {data * model} "
                         f"ranks, the world has {world}")
    index = {"data": rank // model, "model": rank % model}
    groups = {"data": None, "model": None}
    if data > 1:
        for j in range(model):
            g = dist.group.WORLD if model == 1 else dist.new_group(
                [i * model + j for i in range(data)])
            if j == index["model"]:
                groups["data"] = g
    if model > 1:
        for i in range(data):
            g = dist.group.WORLD if data == 1 else dist.new_group(
                [i * model + j for j in range(model)])
            if i == index["data"]:
                groups["model"] = g
    return Mesh({"data": data, "model": model}, index, groups)


def make_hier_mesh(hosts: int, chips: int) -> Mesh:
    """The ``(host, chip)`` grid of the two-level halo exchange (``hosts *
    chips`` must equal the world size; rank ``r`` sits at ``(r // chips, r
    % chips)``): the ``"chip"`` group holds the ranks of one host, the
    ``"host"`` group the ranks that share a chip index, and the tuple axis
    ``("host", "chip")`` every rank in shard order. Every rank builds every
    group, in one order (the chip groups, then the host groups), as
    ``dist.new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if hosts * chips != world:
        raise ValueError(f"mesh {hosts} hosts x {chips} chips needs "
                         f"{hosts * chips} ranks, the world has {world}")
    both = ("host", "chip")
    index = {"host": rank // chips, "chip": rank % chips, both: rank}
    groups = {"host": None, "chip": None,
              both: dist.group.WORLD if world > 1 else None}
    if chips > 1:
        for h in range(hosts):
            g = dist.group.WORLD if hosts == 1 else dist.new_group(
                [h * chips + c for c in range(chips)])
            if h == index["host"]:
                groups["chip"] = g
    if hosts > 1:
        for c in range(chips):
            g = dist.group.WORLD if chips == 1 else dist.new_group(
                [h * chips + c for h in range(hosts)])
            if c == index["chip"]:
                groups["host"] = g
    return Mesh({"host": hosts, "chip": chips, both: world}, index, groups)


def local_mesh(model_axis: int = 1) -> Mesh:
    """All ranks: a model axis of the given size, the rest data."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    return make_mesh(world // model_axis, model_axis)
