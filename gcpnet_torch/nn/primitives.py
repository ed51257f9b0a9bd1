"""Geometric feature primitives.

Port of ``gcpnet_tpu/nn/primitives.py``.  Layout convention, kept from the
JAX package so both compare like with like: a ``c``-channel 3-vector
feature is PACKED as ``[..., 3*c]`` with axis-major blocks ``[x-block |
y-block | z-block]`` (each block ``c`` wide).  ``pack_vector`` converts from
the public ``[..., c, 3]`` layout of ``GraphBatch.chi`` / ``xi``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn


def pack_vector(v: Tensor) -> Tensor:
    """``[..., c, 3] -> [..., 3c]`` with x/y/z axis-major blocks."""
    return v.movedim(-1, -2).reshape(*v.shape[:-2], 3 * v.shape[-2])


def vec_components(vp: Tensor):
    """The three ``[..., c]`` axis blocks."""
    c = vp.shape[-1] // 3
    return vp[..., :c], vp[..., c : 2 * c], vp[..., 2 * c :]


def vec_at(vp: Tensor, channel: int) -> Tensor:
    """One channel's 3-vector ``[..., 3]`` (for position heads)."""
    c = vp.shape[-1] // 3
    return torch.stack([vp[..., channel], vp[..., c + channel], vp[..., 2 * c + channel]], dim=-1)


def vec_sq_norm(vp: Tensor) -> Tensor:
    """Per-channel squared L2 over xyz: ``[..., 3c] -> [..., c]``."""
    x, y, z = vec_components(vp)
    return x * x + y * y + z * z


class ScalarVector(NamedTuple):
    """Paired invariant scalar ``[..., ds]`` and equivariant PACKED vector
    ``[..., 3*dv]`` channels."""

    scalar: Tensor
    vector: Tensor

    def __add__(self, other):  # type: ignore[override]
        return ScalarVector(self.scalar + other[0], self.vector + other[1])

    def concat(self, others) -> "ScalarVector":
        """Channel concat; the packed vectors are concatenated per axis
        block, so the result stays ``[x | y | z]``."""
        items = (self, *others)
        comps = [vec_components(it[1]) for it in items]
        return ScalarVector(
            torch.cat([it[0] for it in items], dim=-1),
            torch.cat([c[a] for a in range(3) for c in comps], dim=-1),
        )

    def flatten(self) -> Tensor:
        """``[..., ds] ++ [..., 3*dv] -> [..., ds + 3*dv]``."""
        return torch.cat([self.scalar, self.vector], dim=-1)

    @staticmethod
    def recover(x: Tensor, vector_dim: int) -> "ScalarVector":
        """Inverse of :meth:`flatten`."""
        if vector_dim == 0:
            return ScalarVector(x, x.new_zeros(x.shape[:-1] + (0,)))
        return ScalarVector(x[..., : -3 * vector_dim], x[..., -3 * vector_dim :])

    @property
    def dims(self):
        return self.scalar.shape[-1], self.vector.shape[-1] // 3


def safe_norm(
    x: Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-8, sqrt: bool = True
) -> Tensor:
    """``sqrt(sum(x^2) + eps) + eps``."""
    norm = (x * x).sum(dim=dim, keepdim=keepdim)
    if sqrt:
        norm = torch.sqrt(norm + eps)
    return norm + eps


def safe_vec_norm(vp: Tensor, eps: float = 1e-8) -> Tensor:
    """Packed per-channel safe norm: ``[..., 3c] -> [..., c]``."""
    return torch.sqrt(vec_sq_norm(vp) + eps) + eps


def is_identity(name: Optional[str]) -> bool:
    return name is None or name == "" or name == "none"


def leaky_relu(x: Tensor, slope: float = 0.01) -> Tensor:
    """``jax.nn.leaky_relu``: ``x`` where ``x >= 0``, else ``slope * x``, so
    the gradient at exactly 0 is 1 (``F.leaky_relu``'s is ``slope``); a
    NaN stays a NaN."""
    return torch.where(x >= 0, x, slope * x)


def get_nonlinearity(name: Optional[str], slope: float = 0.01) -> Callable[[Tensor], Tensor]:
    """Name -> activation function (the JAX package's table)."""
    if is_identity(name):
        return lambda x: x
    table = {
        "relu": F.relu,
        "leakyrelu": lambda x: leaky_relu(x, slope),
        "selu": F.selu,
        "silu": F.silu,
        "swish": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
    }
    if name not in table:
        raise NotImplementedError(f"nonlinearity '{name}' is not supported")
    return table[name]


def norm_vector_channels(vp: Tensor, eps: float = 1e-8) -> Tensor:
    """Divide packed vectors by the RMS over channels of each channel's
    clamped squared norm."""
    sq = torch.clamp(vec_sq_norm(vp), min=eps)
    return vp / torch.sqrt(sq.mean(dim=-1, keepdim=True))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: parameters ``scale`` and
    ``bias``, epsilon 1e-6, statistics in float32."""

    def __init__(self, dim: int, *, device: torch.device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: Tensor) -> Tensor:
        y = F.layer_norm(
            x.float(), (x.shape[-1],), self.scale.float(), self.bias.float(), self.eps
        )
        return y.to(x.dtype)


class GCPLayerNorm(nn.Module):
    """Scalar LayerNorm (learned affine) + nonparametric vector norm."""

    def __init__(self, scalar_dim: int, *, device: torch.device, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.scalar_norm = LayerNorm(scalar_dim, device=device)

    def forward(self, x: Union[Tensor, ScalarVector]) -> Union[Tensor, ScalarVector]:
        if isinstance(x, ScalarVector):
            s = self.scalar_norm(x.scalar)
            if x.vector.shape[-1] == 0:
                return ScalarVector(s, x.vector)
            return ScalarVector(s, norm_vector_channels(x.vector, eps=self.eps))
        return self.scalar_norm(x)


class MaskTape:
    """The dropout generator of one rematerialized layer, handed to the
    layer in the generator's place: its first run draws the masks from
    ``generator`` and records them, in order; each recompute (``replay``
    set to 0 before it) reads them back in that order instead of drawing
    again.  So the recompute applies the masks the forward applied, and
    the generator advances once, as without remat, whatever its state (a
    CUDA graph's registered generator included): the JAX package gets the
    same from its explicit dropout keys."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.masks: List[Tensor] = []
        self.replay: Optional[int] = None  # the next mask to read while replaying

    def keep_mask(self, shape, keep: float, device) -> Tensor:
        if self.replay is not None:
            mask = self.masks[self.replay]
            self.replay += 1
            return mask
        mask = torch.rand(shape, generator=self.generator, device=device) < keep
        self.masks.append(mask)
        return mask


def keep_mask(shape, keep: float, generator: Union[torch.Generator, MaskTape], device) -> Tensor:
    """``rand(shape) < keep`` from ``generator``, or from its tape where
    it is a :class:`MaskTape`."""
    if isinstance(generator, MaskTape):
        return generator.keep_mask(shape, keep, device)
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: Tensor, rate: float, generator: torch.Generator) -> Tensor:
    """Elementwise dropout: keep each value with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)`` (flax ``nn.Dropout``)."""
    keep = 1.0 - rate
    mask = keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class GCPDropout(nn.Module):
    """Paired scalar dropout and vector-channel dropout: whole 3-vectors are
    dropped together, one mask per vector channel tiled over the x/y/z
    blocks (JAX ``nn/primitives.py:208-232``).  The identity when
    ``deterministic``; otherwise the masks are drawn from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or deterministic:
            return x
        if generator is None:
            raise ValueError("GCPDropout: training-mode dropout needs a torch.Generator")
        if not isinstance(x, ScalarVector):
            return dropout(x, self.rate, generator)
        keep = 1.0 - self.rate
        v = x.vector
        c = v.shape[-1] // 3
        mask = keep_mask(v.shape[:-1] + (c,), keep, generator, v.device)
        mask = mask.to(v.dtype).repeat(*([1] * (v.dim() - 1)), 3)
        return ScalarVector(dropout(x.scalar, self.rate, generator), v * mask / keep)
