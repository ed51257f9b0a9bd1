"""Training state: the optimizer, a step counter and the ring of recent
gradient norms behind the adaptive clip.

Port of ``gcpnet_tpu/train/state.py``.  The ring lives on the device as
torch tensors and is updated in place (the JAX package's is an immutable
pytree), so that a captured training step keeps writing the tensors it was
captured with; the reference's rule is "max_norm = 1.5 * mean + 2 * std of
the last 1000 gradient norms".
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

    @torch.no_grad()
    def push(self, value: Tensor, ok: Optional[Tensor] = None) -> None:
        """Write ``value`` at the head and move on, where the boolean device
        flag ``ok`` holds (always when ``None``); otherwise the slot, the
        count and the head keep their values."""
        slot = self.head.long().reshape(1)
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=self.buffer.device)
        self.buffer.index_put_((slot,), torch.where(ok, value.float(), self.buffer[slot]).reshape(1))
        self.count.add_(ok.int()).clamp_(max=self.capacity)
        self.head.add_(ok.int()).remainder_(self.capacity)

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
    clip; ``scheduler`` an optional LR schedule stepped per update;
    ``lr_scale`` an optional float64 0-d device tensor that scales the
    rate (the plateau schedule's scale, written between epochs); ``group``
    the data-parallel ``parallel.Group`` whose processes average their
    loss and gradients each step (``None``: this process alone)."""

    optimizer: Any
    step: int = 0
    ring: Optional[GradNormRing] = None
    compute_dtype: torch.dtype = torch.float32
    clip_std_multiplier: float = 2.0
    scheduler: Any = None
    lr_scale: Optional[Tensor] = None
    group: Any = None
