"""The direct-shot CPD head.

Port of ``gcpnet_tpu/nn/decoder.py:GCPMLPDecoder``: ``num_layers - 1``
hidden dense layers (added to their input with ``residual_updates``), then
one dense layer to the vocabulary; returns the logits and their
log-softmax.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.nn.gcp import Dense


class GCPMLPDecoder(nn.Module):
    def __init__(
        self,
        hidden_dim: int,
        vocab_size: int = 20,
        num_layers: int = 1,
        residual_updates: bool = False,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.num_layers = num_layers
        self.residual_updates = residual_updates
        for i in range(num_layers - 1):
            self.add_module(f"readout_{i}", Dense(hidden_dim, hidden_dim, **kw))
        self.add_module(f"readout_{num_layers - 1}", Dense(hidden_dim, vocab_size, **kw))

    def forward(self, h: Tensor) -> Tuple[Tensor, Tensor]:
        x = h
        for i in range(self.num_layers - 1):
            layer = getattr(self, f"readout_{i}")
            x = x + layer(x) if self.residual_updates else layer(x)
        logits = getattr(self, f"readout_{self.num_layers - 1}")(x)
        return logits, torch.log_softmax(logits, dim=-1)
