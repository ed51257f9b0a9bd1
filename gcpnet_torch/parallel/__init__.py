"""Data parallelism: one process a GPU, each stepping on its own shard of
every global batch, gradients averaged inside the step (see
``parallel.group`` and ``parallel.launch``)."""

from gcpnet_torch.parallel.group import (
    Group,
    all_gather,
    all_gather_objects,
    barrier,
    check_capturable,
    init_from_env,
    launched,
    mean_,
)
from gcpnet_torch.parallel.launch import launch

__all__ = [
    "Group",
    "all_gather",
    "all_gather_objects",
    "barrier",
    "check_capturable",
    "init_from_env",
    "launch",
    "launched",
    "mean_",
]
