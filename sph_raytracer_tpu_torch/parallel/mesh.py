"""Process groups for the sharded operators, on ``torch.distributed``.

Port of ``sph_raytracer_tpu/parallel/mesh.py``.  The JAX package's mesh is
a 1-D device mesh over the ray axis; here it is a process group with one
rank a device: NCCL on the card, one process a GPU (``torchrun
--nproc-per-node=N``), and gloo only when the caller asks for the CPU.
The sharded operators need one collective a forward and one a backward,
each an ``all_reduce`` (:meth:`Mesh.all_reduce`).

Usage, one process a GPU::

    distributed_init()            # under torchrun: NCCL, cuda:LOCAL_RANK
    mesh = make_mesh()            # every rank of the default group
    op = ShardedOperator(grid, geom, mesh=mesh)
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..operator import resolve_device

__all__ = ["Mesh", "make_mesh", "distributed_init"]

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the group that shares an operator's work.

    Attributes:
        group: the ``torch.distributed`` process group (``None``: the
            default group).
        rank: this rank's place in the group, 0 .. size-1 (-1: not in it).
        size: the number of ranks.
        device: this rank's device, where its share of the tables lives.
        axis: the name of the mesh's one axis, the ray axis (the JAX
            package's mesh axis name; ``shard_rays`` checks it).
    """

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = RAY_AXIS

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place, and return it (a one-rank
        group's sum is ``t`` itself)."""
        dist.all_reduce(t, group=self.group)
        return t


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     **kwargs) -> None:
    """Join the default process group (``init_process_group``); a no-op
    when it exists already.

    Under ``torchrun`` every argument comes from its environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``).
    Otherwise pass ``coordinator_address`` (an init method:
    ``"tcp://localhost:29500"`` or ``"file:///path/to/store"``),
    ``num_processes`` and ``process_id``.  ``device=None`` means the card:
    the group is NCCL and this process's GPU is ``LOCAL_RANK`` (the
    device's index if one is given); with no card that raises.  Only
    ``device="cpu"`` gives a gloo group.  ``kwargs`` go to
    ``init_process_group`` (``timeout=``)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dev.index or 0)))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=coordinator_address or "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def make_mesh(devices: Union[None, int, Sequence[int]] = None,
              axis: str = RAY_AXIS, *, device=None) -> Mesh:
    """This rank's :class:`Mesh` over ranks of the default group.

    Args:
        devices: the ranks to include, a sequence of ranks or an int to
            take the first N (default all).  More than the world size
            raises ``ValueError``, as the JAX package's ``make_mesh(n)``
            does for devices.
        axis: the mesh axis name, as in the JAX package.
        device: keyword only, after the JAX package's parameters; this
            rank's device, as :func:`..operator.resolve_device` takes it:
            ``None`` means the card (the current GPU; with no card that
            raises), and the CPU only when ``"cpu"`` is passed, whatever
            the group's backend.  A group whose backend does not carry
            tensors of that device type raises ``ValueError``.

    A group other than the whole world comes from ``new_group``, which
    every rank of the default group must call; a rank outside it gets a
    mesh with ``rank=-1``, which the operators refuse."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "distributed_init() first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if devices is None:
        ranks = list(range(world))
    elif isinstance(devices, int):
        ranks = list(range(devices))
    else:
        ranks = [int(r) for r in devices]
    if len(ranks) > world or not all(0 <= r < world for r in ranks):
        raise ValueError(f"make_mesh({devices}) but only {world} ranks")
    group = None if ranks == list(range(world)) else dist.new_group(ranks)
    me = dist.get_rank()
    if me in ranks:
        # "cpu:gloo,cuda:nccl": the device types the group's backends carry
        config = dist.get_backend_config(group)
        carried = {part.split(":")[0] for part in config.split(",")}
        if dev.type not in carried:
            raise ValueError(f"the process group's backend ({config}) "
                             f"carries no {dev.type} tensors")
    return Mesh(group, ranks.index(me) if me in ranks else -1, len(ranks),
                dev, axis)
