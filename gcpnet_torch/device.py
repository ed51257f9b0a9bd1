"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  The CPU is used only when asked for by
    name; a CUDA request without a card raises instead of quietly running
    on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gcpnet_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain-PyTorch path"
        )
    return dev
