"""Training state: the optimizer, a step counter and the ring of recent
gradient norms behind the adaptive clip.

Port of ``gcpnet_tpu/train/state.py``.  The ring lives on the device as
torch tensors and is updated in place (the JAX package's is an immutable
pytree); the reference's rule is "max_norm = 1.5 * mean + 2 * std of the
last 1000 gradient norms".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import Tensor


class GradNormRing:
    """Fixed-size ring buffer of recent gradient norms, on ``device``."""

    def __init__(self, capacity: int = 1000, device=None):
        self.buffer = torch.zeros((capacity,), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)  # pushes, saturating
        self.head = torch.zeros((), dtype=torch.int32, device=device)  # next write position

    @property
    def capacity(self) -> int:
        return self.buffer.shape[0]

    def push(self, value: Tensor) -> None:
        self.buffer.index_put_((self.head.long().reshape(1),), value.float().reshape(1))
        self.count = torch.clamp(self.count + 1, max=self.capacity)
        self.head = (self.head + 1) % self.capacity

    def clip_threshold(self, std_multiplier: float = 2.0) -> Tensor:
        """``1.5 * mean + k * std`` over the filled part; ``inf`` while empty,
        so that the first steps are not clipped."""
        mask = (torch.arange(self.capacity, device=self.buffer.device) < self.count).float()
        n = torch.clamp(self.count.float(), min=1.0)
        mean = (self.buffer * mask).sum() / n
        var = (mask * (self.buffer - mean) ** 2).sum() / n
        thr = 1.5 * mean + std_multiplier * torch.sqrt(var)
        return torch.where(self.count > 0, thr, torch.full_like(thr, float("inf")))


@dataclasses.dataclass
class TrainState:
    """What a train step carries from one step to the next besides the
    model's parameters (the float32 masters).

    ``compute_dtype`` is the dtype the forward and backward run in
    (bfloat16: bf16 copies of the masters, the JAX package's
    ``precision=16`` policy); ``ring`` is ``None`` without the adaptive
    clip; ``scheduler`` an optional LR schedule stepped per update."""

    optimizer: Any
    step: int = 0
    ring: Optional[GradNormRing] = None
    compute_dtype: torch.dtype = torch.float32
    clip_std_multiplier: float = 2.0
    scheduler: Any = None
