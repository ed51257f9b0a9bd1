"""This process's place in a data-parallel run, and the collectives the
training loop needs.

The counterpart of ``gcpnet_tpu/parallel/mesh.py``.  The JAX package lays
a 1-D ``dp`` mesh over its devices and hands device ``i`` shard ``i`` of
each batch; the port runs one process a GPU (NCCL; gloo on the CPU), each
process reading its own shard (``data.batching.Shards``).  The process
group comes from the launcher's environment: ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` (``torchrun``'s, or ``parallel.launch``'s), and the
rendezvous from ``GCPNET_INIT_METHOD`` (``launch`` sets a ``file://``
store), else ``env://`` (``MASTER_ADDR`` and ``MASTER_PORT``).  Rank ``r``
of a machine uses ``cuda:<LOCAL_RANK>``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from gcpnet_torch.data.batching import Shards

INIT_METHOD_ENV = "GCPNET_INIT_METHOD"


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group of ``world`` processes over ``nodes`` machines, as
    seen by ``rank``."""

    rank: int
    world: int
    local_rank: int = 0
    nodes: int = 1
    pg: Any = None  # the torch.distributed ProcessGroup

    @property
    def backend(self) -> str:
        return dist.get_backend(self.pg)

    @property
    def shards(self) -> Shards:
        """The batch layout of this process: shard ``rank`` of ``world``."""
        return Shards(count=self.world, index=self.rank, nodes=self.nodes)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def launched() -> bool:
    """Whether a launcher started this process (``WORLD_SIZE`` is set)."""
    return "WORLD_SIZE" in os.environ


def init_from_env(device_type: str, nodes: int = 1, backend: Optional[str] = None) -> Group:
    """Join the process group of the launcher's environment on NCCL
    (``device_type`` ``"cuda"``: this process then uses
    ``cuda:<LOCAL_RANK>``) or gloo (``"cpu"``, or ``backend="gloo"``, whose
    collectives also take CUDA tensors, eagerly); once a process, later
    calls return the same group."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if world % nodes:
        raise ValueError(f"WORLD_SIZE={world} does not split over trainer.num_nodes={nodes}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(
            backend, init_method=os.environ.get(INIT_METHOD_ENV, "env://"), rank=rank, world_size=world,
        )
    return Group(rank=rank, world=world, local_rank=local_rank, nodes=nodes, pg=dist.group.WORLD)


def check_capturable(group: Optional[Group]) -> None:
    """A CUDA graph can hold NCCL's collectives, not gloo's: a captured step
    on another backend raises (it would otherwise have to run eagerly)."""
    if group is not None and group.backend != "nccl":
        raise RuntimeError(
            f"a captured training step needs NCCL collectives; the process group's backend is "
            f"{group.backend}, whose collectives a CUDA graph cannot hold (run the step eagerly: train_step)"
        )


def mean_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` replaced in place by its mean over the group's processes (one
    all-reduce), the JAX step's ``pmean``."""
    dist.all_reduce(t, group=group.pg)
    return t.div_(group.world)


def all_gather(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every process's ``t`` (equal shapes), in rank order."""
    out = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(out, t.contiguous(), group=group.pg)
    return out


def all_gather_objects(obj, group: Group) -> list:
    """Every process's picklable ``obj``, in rank order."""
    out: list = [None] * group.world
    dist.all_gather_object(out, obj, group=group.pg)
    return out


def barrier(group: Optional[Group]) -> None:
    if group is not None:
        dist.barrier(group=group.pg)
