"""K2: the GCP2 message stack, fused over edge rows.

``edge_map(message, frames, stack)`` computes, for every edge row, the
whole (Res)GCP2 message stack of ``GCPMessagePassing``: ``message`` is the
flattened ``[src ‖ edge ‖ dst]`` input ``[E, s_in + 3 v_in]``, ``frames``
the edge frames already multiplied by the frame mask ``[E, 9]``, and the
result the flattened stack output ``[E, s_out + 3 v_out]``.  It replaces the
forward kernel of ``gcpnet_tpu/ops/pallas_fused.py`` (``edge_map`` over
``apply_stack``); on CUDA tensors the wrapper launches the hand-written
kernel ``csrc/edge_map.cu``, on CPU tensors it runs
:func:`edge_map_plain`.

The stack's weights are packed once into the kernel's layout
(:func:`pack_stack`): per layer ``[vector_down | vector_down_frames]``
``[v_in, h + 3]``, ``scalar_out`` ``[s_in + h + 9, s_out]`` and its bias,
``vector_up`` ``[h, v_out]``, and ``vector_out_scale`` ``[s_out, v_out]``
with its bias, all float32 and back to back in one buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from gcpnet_torch.nn.primitives import get_nonlinearity, is_identity
from gcpnet_torch.ops.build import library
from gcpnet_torch.ops.segment_sorted import DTYPE_CODES

EPS = 1e-8
MAX_LAYERS = 16  # csrc/edge_map.cu kMaxLayers
KERNEL_ACTIVATIONS = {None: 0, "relu": 1}


@dataclasses.dataclass(frozen=True)
class StackLayer:
    """One GCP2 layer of a message stack, weights in float32."""

    w_down: Tensor  # [v_in, h + 3]: vector_down ‖ vector_down_frames
    w_so: Tensor  # [s_in + h + 9, s_out]: scalar_out
    b_so: Tensor  # [s_out]
    w_up: Tensor  # [h, v_out]: vector_up
    w_gate: Optional[Tensor]  # [s_out, v_out]: vector_out_scale (vector gate only)
    b_gate: Optional[Tensor]  # [v_out]
    act_s: Optional[str]
    act_v: Optional[str]
    slope: float
    vector_residual: bool

    @property
    def dims(self) -> Tuple[int, int, int, int, int]:
        """``(s_in, v_in, hidden, s_out, v_out)``."""
        v_in, hp3 = self.w_down.shape
        h = hp3 - 3
        return self.w_so.shape[0] - h - 9, v_in, h, self.w_so.shape[1], self.w_up.shape[1]


@dataclasses.dataclass(frozen=True)
class PackedStack:
    layers: Tuple[StackLayer, ...]
    residual: bool  # ResGCP: sum the layers' outputs
    weights: Tensor  # all layers' weights back to back, float32, on the device
    meta: np.ndarray  # int32 layer table for the kernel (csrc/edge_map.cu)

    @property
    def in_dim(self) -> int:
        s_in, v_in = self.layers[0].dims[:2]
        return s_in + 3 * v_in

    @property
    def out_dim(self) -> int:
        s_out, v_out = self.layers[-1].dims[3:]
        return s_out + 3 * v_out


def _act_name(name: Optional[str]) -> Optional[str]:
    return None if is_identity(name) else name


def pack_stack(layers: Sequence[StackLayer], residual: bool) -> PackedStack:
    """Check that consecutive layers chain and pack their weights once."""
    if not layers:
        raise ValueError("pack_stack: empty stack")
    meta = [len(layers), int(residual)]
    chunks, offset = [], 0
    prev = None
    for i, layer in enumerate(layers):
        s_in, v_in, h, s_out, v_out = layer.dims
        if prev is not None and (s_in, v_in) != prev:
            raise ValueError(f"pack_stack: layer {i} takes {(s_in, v_in)}, gets {prev}")
        if residual and i > 0 and (s_in, v_in) != (s_out, v_out):
            raise ValueError("pack_stack: residual layers must keep their dims")
        if layer.vector_residual and v_in != v_out:
            raise ValueError("pack_stack: the vector residual needs v_in == v_out")
        prev = (s_out, v_out)
        offs = []
        for w in (layer.w_down, layer.w_so, layer.b_so, layer.w_up, layer.w_gate, layer.b_gate):
            offs.append(offset)
            if w is not None:
                chunks.append(w.detach().float().reshape(-1))
                offset += w.numel()
        meta += [
            s_in, v_in, h, s_out, v_out,
            KERNEL_ACTIVATIONS.get(_act_name(layer.act_s), -1),
            KERNEL_ACTIVATIONS.get(_act_name(layer.act_v), -1),
            int(layer.vector_residual), int(layer.w_gate is not None), *offs,
        ]
    return PackedStack(
        layers=tuple(layers),
        residual=residual,
        weights=torch.cat(chunks).contiguous(),
        meta=np.asarray(meta, np.int32),
    )


def _layer_plain(layer: StackLayer, s: Tensor, v: Tensor, frames: Tensor):
    """One GCP2 layer in the input dtype, each matmul rounded to it; square
    roots, sigmoids and activations in float32 (the JAX MM form's
    numerics)."""
    s_in, v_in, h, s_out, v_out = layer.dims
    dt = s.dtype
    e = s.shape[0]

    def f32(fn, x):
        return fn(x.float()).to(dt)

    act_s = get_nonlinearity(layer.act_s, layer.slope)
    act_v = get_nonlinearity(layer.act_v, layer.slope)
    vc = v.reshape(e, 3, v_in)
    d = vc @ layer.w_down.to(dt)  # [E, 3, h + 3]
    vh, df = d[..., :h], d[..., h:]
    vnorm = f32(lambda x: torch.sqrt(x + EPS), (vh * vh).sum(dim=1)) + EPS
    # scal9[:, ch*3 + f] = sum_a df[:, a, ch] * frames[:, 3f + a]
    scal9 = torch.einsum("eac,efa->ecf", df, frames.reshape(e, 3, 3)).reshape(e, 9)
    s_new = torch.cat([s, vnorm, scal9], dim=-1) @ layer.w_so.to(dt) + layer.b_so.to(dt)
    vu = vh @ layer.w_up.to(dt)  # [E, 3, v_out]
    if layer.vector_residual:
        vu = vu + vc
    if layer.w_gate is not None:
        gate = f32(act_v, s_new) @ layer.w_gate.to(dt) + layer.b_gate.to(dt)
        vu = vu * f32(torch.sigmoid, gate)[:, None, :]
    elif _act_name(layer.act_v) is not None:
        norm = f32(lambda x: torch.sqrt(x + EPS), (vu * vu).sum(dim=1)) + EPS
        vu = vu * f32(act_v, norm)[:, None, :]
    return f32(act_s, s_new), vu.reshape(e, 3 * v_out)


def edge_map_plain(message: Tensor, frames: Tensor, stack: PackedStack) -> Tensor:
    """Plain PyTorch version of K2 (the torch port of the JAX package's
    ``apply_stack`` over ``_fast_gcp2_layer_mm``)."""
    s_in = stack.layers[0].dims[0]
    state = (message[:, :s_in], message[:, s_in:])
    for i, layer in enumerate(stack.layers):
        new = _layer_plain(layer, state[0], state[1], frames)
        if stack.residual and i > 0:
            new = (state[0] + new[0], state[1] + new[1])
        state = new
    return torch.cat(state, dim=-1)


def _check(message: Tensor, frames: Tensor, stack: PackedStack) -> None:
    if message.dim() != 2 or message.shape[1] != stack.in_dim:
        raise ValueError(
            f"edge_map: message must be [E, {stack.in_dim}], got {tuple(message.shape)}"
        )
    if frames.shape != (message.shape[0], 9):
        raise ValueError(f"edge_map: frames must be [E, 9], got {tuple(frames.shape)}")
    if message.dtype not in DTYPE_CODES or frames.dtype != message.dtype:
        raise TypeError(
            f"edge_map: message and frames must share float32 or bfloat16, "
            f"got {message.dtype} and {frames.dtype}"
        )
    if frames.device != message.device or stack.weights.device != message.device:
        raise ValueError("edge_map: message, frames and stack weights on different devices")
    if not (message.is_contiguous() and frames.is_contiguous()):
        raise ValueError("edge_map: message and frames must be contiguous")


def _check_kernel_supported(stack: PackedStack) -> None:
    if len(stack.layers) > MAX_LAYERS:
        raise NotImplementedError(f"edge_map kernel: at most {MAX_LAYERS} layers")
    for i, layer in enumerate(stack.layers):
        for name in (layer.act_s, layer.act_v):
            if _act_name(name) not in KERNEL_ACTIVATIONS:
                raise NotImplementedError(
                    f"edge_map kernel: layer {i} uses activation {name!r}; the CUDA "
                    "kernel implements the identity and relu only"
                )


def edge_map(message: Tensor, frames: Tensor, stack: PackedStack) -> Tensor:
    """K2.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (and count the launch in ``edge_map.launches``)."""
    _check(message, frames, stack)
    if message.device.type == "cpu":
        return edge_map_plain(message, frames, stack)
    if message.device.type != "cuda":
        raise ValueError(f"edge_map: unsupported device {message.device}")
    _check_kernel_supported(stack)
    out = torch.empty(
        (message.shape[0], stack.out_dim), dtype=message.dtype, device=message.device
    )
    err = library("edge_map").gcp_edge_map(
        message.data_ptr(), frames.data_ptr(), stack.weights.data_ptr(),
        stack.meta.ctypes.data, stack.meta.size, out.data_ptr(),
        message.shape[0], DTYPE_CODES[message.dtype],
        torch.cuda.current_stream(message.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"edge_map: CUDA launch failed with error {err}")
    edge_map.launches += 1
    return out


edge_map.launches = 0
