"""K2 and K3: the GCP2 message stack fused over edge rows, and its backward.

``edge_map(message, frames, stack)`` computes, for every edge row, the
whole (Res)GCP2 message stack of ``GCPMessagePassing``: ``message`` is the
flattened ``[src ‖ edge ‖ dst]`` input ``[E, s_in + 3 v_in]``, ``frames``
the edge frames already multiplied by the frame mask ``[E, 9]``, and the
result the flattened stack output ``[E, s_out + 3 v_out]``.  It is a
``torch.autograd.Function`` (:class:`EdgeMap`) with gradients for
``message`` and the stack's weights; the frames get none (in LBA they
depend on no parameter), and it raises if they require one.

It replaces the two kernels of ``gcpnet_tpu/ops/pallas_fused.py``: the
forward (``_map_impl``) on CUDA tensors launches ``csrc/edge_map_tc.cu``
(K2: every product on the tensor cores, bf16 operands with float32
accumulators as the JAX kernel computes, or float32 as split TF32; every
activation ``get_nonlinearity`` names, in float32), the
backward (``_map_bwd``) launches ``csrc/edge_map_bwd_tc.cu`` (K3, both
dtypes), which recomputes the stack per tile of rows on the same
tensor-core layer body as K2, so it rebuilds K2's state exactly.  On CPU
tensors the forward runs :func:`edge_map_plain` and the backward
:func:`edge_map_backward_plain`.

The stack's weights are packed into the kernels' layout (:func:`pack_stack`):
per layer ``[vector_down | vector_down_frames]`` ``[v_in, h + 3]``,
``scalar_out`` ``[s_in + h + 9, s_out]`` and its bias, ``vector_up``
``[h, v_out]``, and ``vector_out_scale`` ``[s_out, v_out]`` with its bias,
all float32 and back to back in one buffer, built from the live weight
tensors, so that autograd carries the buffer's gradient back to each of them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from gcpnet_torch.nn.primitives import get_nonlinearity, is_identity
from gcpnet_torch.ops.build import library
from gcpnet_torch.ops.segment_sorted import DTYPE_CODES

EPS = 1e-8
MAX_LAYERS = 32  # csrc/edge_stack.cuh kMaxLayers
CUDA_ERROR_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration
# the activations the kernels implement, by their code in the layer table
# (csrc/edge_stack.cuh ActCode): every name of nn.primitives.get_nonlinearity,
# as the JAX package defines it ("swish" is silu's other name, gelu its tanh
# form); codes 3-7 are the transcendental ones
KERNEL_ACTIVATIONS = {
    None: 0, "relu": 1, "leakyrelu": 2, "silu": 3, "swish": 3, "selu": 4, "gelu": 5, "sigmoid": 6, "tanh": 7,
}
# K3's kernels for stacks with a code from selu's on (csrc/edge_stack.cuh
# kActSelu) are a library of their own, built beside the others
K3_EVERY_CODE_FROM = 4
# a kink at 0, where the gradient steps: relu 0 -> 1, leaky relu slope -> 1,
# selu 1.7581 (at and below 0) -> 1.0507
KINKED_ACTIVATIONS = ("relu", "leakyrelu", "selu")
WEIGHT_NAMES = ("w_down", "w_so", "b_so", "w_up", "w_gate", "b_gate")


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
    # the layer's GCP settings that the kernels' table lacks
    # (nn.message_passing.kernel_outside); _check_kernel_supported raises on them
    outside: Tuple[str, ...] = ()

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
    meta: np.ndarray  # int32 layer table for the kernels (csrc/edge_stack.cuh parse_stack)
    # K2's weight images by activation dtype, built at the first launch: a
    # stack cached under inference mode builds them once
    images: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def in_dim(self) -> int:
        s_in, v_in = self.layers[0].dims[:2]
        return s_in + 3 * v_in

    @property
    def out_dim(self) -> int:
        s_out, v_out = self.layers[-1].dims[3:]
        return s_out + 3 * v_out

    def layer_weights(self, weights: Tensor):
        """Per layer, the dict of ``WEIGHT_NAMES`` -> views into the flat
        ``weights`` buffer (``None`` for an absent gate)."""
        out = []
        for i, layer in enumerate(self.layers):
            offs = self.meta[2 + 15 * i + 9 : 2 + 15 * i + 15]
            views = {}  # in WEIGHT_NAMES order
            for name, off in zip(WEIGHT_NAMES, offs):
                w = getattr(layer, name)
                views[name] = None if w is None else weights[off : off + w.numel()].view(w.shape)
            out.append(views)
        return out


def _act_name(name: Optional[str]) -> Optional[str]:
    return None if is_identity(name) else name


def _pad4(chunks: list, offset: int, device) -> int:
    """Zeros up to the next multiple of 4 floats: every matrix starts
    16-byte aligned, for the kernels' vector loads."""
    pad = -offset % 4
    if pad:
        chunks.append(torch.zeros(pad, device=device))
    return offset + pad


def pack_stack(layers: Sequence[StackLayer], residual: bool) -> PackedStack:
    """Check that consecutive layers chain and pack their weights, each at
    an offset that is a multiple of 4.  The buffer is a ``torch.cat`` of the
    given tensors: in grad mode it stays on the autograd graph.  The layer
    table is ``{n_layers, residual}``, 15 words a layer, then each layer's
    leaky slope as float32 bits."""
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
        for name in WEIGHT_NAMES:
            w = getattr(layer, name)
            offs.append(offset)
            if w is not None:
                chunks.append(w.float().reshape(-1))
                offset += w.numel()
                offset = _pad4(chunks, offset, w.device)
        meta += [
            s_in, v_in, h, s_out, v_out,
            KERNEL_ACTIVATIONS.get(_act_name(layer.act_s), -1),
            KERNEL_ACTIVATIONS.get(_act_name(layer.act_v), -1),
            int(layer.vector_residual), int(layer.w_gate is not None), *offs,
        ]
    slopes = np.asarray([layer.slope for layer in layers], np.float32).view(np.int32)
    return PackedStack(
        layers=tuple(layers),
        residual=residual,
        weights=torch.cat(chunks).contiguous(),
        meta=np.concatenate([np.asarray(meta, np.int32), slopes]),
    )


def _layer_plain(
    layer: StackLayer, w: dict, s: Tensor, v: Tensor, frames: Tensor, margins: Optional[list] = None
):
    """One GCP2 layer in the input dtype, each matmul rounded to it; square
    roots, sigmoids and activations in float32 (the JAX MM form's
    numerics).  ``w`` holds the layer's weights (``PackedStack.layer_weights``).
    Where the layer's scalar pre-activation goes through a kinked
    activation, a list ``margins`` gets each row's margin to the kink (see
    :func:`kink_margins`)."""
    s_in, v_in, h, s_out, v_out = layer.dims
    dt = s.dtype
    e = s.shape[0]

    def f32(fn, x):
        return fn(x.float()).to(dt)

    act_s = get_nonlinearity(layer.act_s, layer.slope)
    act_v = get_nonlinearity(layer.act_v, layer.slope)
    vc = v.reshape(e, 3, v_in)
    d = vc @ w["w_down"].to(dt)  # [E, 3, h + 3]
    vh, df = d[..., :h], d[..., h:]
    vnorm = f32(lambda x: torch.sqrt(x + EPS), (vh * vh).sum(dim=1)) + EPS
    # scal9[:, ch*3 + f] = sum_a df[:, a, ch] * frames[:, 3f + a]
    scal9 = torch.einsum("eac,efa->ecf", df, frames.reshape(e, 3, 3)).reshape(e, 9)
    merged = torch.cat([s, vnorm, scal9], dim=-1)
    s_new = merged @ w["w_so"].to(dt) + w["b_so"].to(dt)
    gated_kink = w["w_gate"] is not None and _act_name(layer.act_v) in KINKED_ACTIVATIONS
    if margins is not None and (_act_name(layer.act_s) in KINKED_ACTIVATIONS or gated_kink):
        terms = merged.abs() @ w["w_so"].to(dt).abs() + w["b_so"].to(dt).abs()
        margins.append((s_new.abs() / terms.clamp_min(torch.finfo(dt).tiny)).amin(dim=1))
    vu = vh @ w["w_up"].to(dt)  # [E, 3, v_out]
    if layer.vector_residual:
        vu = vu + vc
    if w["w_gate"] is not None:
        gate = f32(act_v, s_new) @ w["w_gate"].to(dt) + w["b_gate"].to(dt)
        vu = vu * f32(torch.sigmoid, gate)[:, None, :]
    elif _act_name(layer.act_v) is not None:
        norm = f32(lambda x: torch.sqrt(x + EPS), (vu * vu).sum(dim=1)) + EPS
        vu = vu * f32(act_v, norm)[:, None, :]
    return f32(act_s, s_new), vu.reshape(e, 3 * v_out)


def edge_map_plain(
    message: Tensor,
    frames: Tensor,
    stack: PackedStack,
    weights: Optional[Tensor] = None,
    margins: Optional[list] = None,
) -> Tensor:
    """Plain PyTorch version of K2 (the torch port of the JAX package's
    ``apply_stack`` over ``_fast_gcp2_layer_mm``), reading the weights from
    the flat buffer ``weights`` (default ``stack.weights``); ``margins`` as
    in :func:`_layer_plain`."""
    weights = stack.weights if weights is None else weights
    s_in = stack.layers[0].dims[0]
    state = (message[:, :s_in], message[:, s_in:])
    for i, (layer, w) in enumerate(zip(stack.layers, stack.layer_weights(weights))):
        new = _layer_plain(layer, w, state[0], state[1], frames, margins)
        if stack.residual and i > 0:
            new = (state[0] + new[0], state[1] + new[1])
        state = new
    return torch.cat(state, dim=-1)


def edge_map_backward_plain(
    message: Tensor, frames: Tensor, stack: PackedStack, grad_out: Tensor
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K3: ``(d message, d weights)`` for the
    cotangent ``grad_out``, by autograd through :func:`edge_map_plain`
    recomputed from detached inputs."""
    with torch.enable_grad():
        m = message.detach().requires_grad_()
        w = stack.weights.detach().requires_grad_()
        out = edge_map_plain(m, frames.detach(), stack, w)
        d_message, d_weights = torch.autograd.grad(out, (m, w), grad_out)
    return d_message, d_weights


# Kinks at 0 (relu, leaky relu, whose gradient steps by 1 - slope there,
# and selu, whose gradient steps from scale alpha to scale).  K3 in float32
# and its plain version compute each pre-activation in a different order
# (split TF32 against float32 FMAs), so one within
# their rounding of 0 can fall on different sides of the kink in the two,
# and the row's gradient then differs by O(1).  Their rounding leaves
# the other rows ~1e-6 of scale apart, so a pre-activation whose kink margin
# exceeds KINK_MARGIN (1.5e-5, 128 float32 ulps of its terms' magnitude)
# does not flip, and a row that parts from the plain version with no margin
# under it is a fault.  (Of random rows at the LBA and NMS stacks' widths,
# 3-6% have a margin under KINK_MARGIN, ~500 pre-activations each.)  On the
# H100 2 rows of 38,000 flipped at the NMS shape; at most MAX_KINK_ROW_SHARE
# of the rows (rounded up), ~20 times that rate, may.
KINK_MARGIN = 2.0**-16
MAX_KINK_ROW_SHARE = 2.0**-10


def max_kink_rows(rows: int) -> int:
    """The most rows of ``rows`` that may flip at a kink."""
    return math.ceil(rows * MAX_KINK_ROW_SHARE)


def kink_margins(message: Tensor, frames: Tensor, stack: PackedStack) -> Tensor:
    """Each row's kink margin ``[E]``: the least, over every relu, leaky
    relu or selu of the stack (KINKED_ACTIVATIONS), of ``|pre-activation| / (the sum of its terms'
    magnitudes)``, from the plain version recomputed in float64 (its
    activations, square roots and sigmoids in float32).  How near the row
    lies to a kink (``inf`` where the stack has no kinked activation)."""
    found: list = []
    with torch.no_grad():
        edge_map_plain(message.double(), frames.double(), stack, margins=found)
    if not found:
        return torch.full((message.shape[0],), float("inf"), dtype=torch.float64, device=message.device)
    return torch.stack(found).amin(dim=0)


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
        if layer.outside:
            raise NotImplementedError(
                f"edge_map kernel: layer {i} has {list(layer.outside)}, which the kernels' layer table lacks; "
                "such stacks run module by module (nn.message_passing.kernel_outside)"
            )
        for name in (layer.act_s, layer.act_v):
            if _act_name(name) not in KERNEL_ACTIVATIONS:
                raise NotImplementedError(
                    f"edge_map kernel: layer {i} uses activation {name!r}; the CUDA kernels "
                    f"implement {sorted(k for k in KERNEL_ACTIVATIONS if k)} and the identity "
                    "(ops.edge_map.KERNEL_ACTIVATIONS)"
                )


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _k2_images(lib, stack: PackedStack, dtype: torch.dtype) -> Tensor:
    """K2's per-layer weight images for activations of ``dtype`` (bf16, or
    float32 transposed for split TF32), built by the kernel library ``lib``
    on the first call and kept on the stack."""
    if dtype not in stack.images:
        code = DTYPE_CODES[dtype]
        nbytes = lib.gcp_edge_map_tc_image_bytes(stack.meta.ctypes.data, stack.meta.size, code)
        if nbytes < 0:
            raise ValueError("edge_map: malformed layer table")
        images = torch.empty(nbytes, dtype=torch.uint8, device=stack.weights.device)
        err = lib.gcp_edge_map_tc_images(
            stack.weights.data_ptr(), stack.meta.ctypes.data, stack.meta.size, images.data_ptr(), code,
            _stream(stack.weights),
        )
        if err != 0:
            raise RuntimeError(f"edge_map: building the weight images failed with error {err}")
        stack.images[dtype] = images
    return stack.images[dtype]


def launch_forward(message: Tensor, frames: Tensor, stack: PackedStack, lib=None) -> Tensor:
    """Launch K2 (``csrc/edge_map_tc.cu``, or the build ``lib`` of it) on
    checked CUDA tensors."""
    lib = lib or library("edge_map_tc")
    images = _k2_images(lib, stack, message.dtype)
    out = torch.empty((message.shape[0], stack.out_dim), dtype=message.dtype, device=message.device)
    err = lib.gcp_edge_map_tc(
        message.data_ptr(), frames.data_ptr(), images.data_ptr(), stack.meta.ctypes.data, stack.meta.size,
        out.data_ptr(), message.shape[0], DTYPE_CODES[message.dtype], _stream(message),
    )
    if err == CUDA_ERROR_INVALID_CONFIGURATION:
        raise NotImplementedError(
            "edge_map: the stack's widths need more shared memory than the kernel's tile has"
        )
    if err != 0:
        raise RuntimeError(f"edge_map: CUDA launch failed with error {err}")
    return out


def _edge_map_forward(message: Tensor, frames: Tensor, stack: PackedStack) -> Tensor:
    """K2.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (and count the launch in ``edge_map.launches``)."""
    if message.device.type == "cpu":
        return edge_map_plain(message, frames, stack)
    if message.device.type != "cuda":
        raise ValueError(f"edge_map: unsupported device {message.device}")
    _check_kernel_supported(stack)
    out = launch_forward(message, frames, stack)
    edge_map.launches += 1
    return out


def _persistent_grid(rows: int, tile: int, dev) -> int:
    """One persistent block per SM (fewer for a short input)."""
    return min(-(-rows // tile), torch.cuda.get_device_properties(dev).multi_processor_count)


def k2_layout(stack: PackedStack, dtype: torch.dtype, lib=None) -> Tuple[int, int, int]:
    """K2's ``(tile rows, weight buffers, shared-memory bytes)`` for
    ``stack`` in ``dtype``: 64 rows, or 32 for a stack too wide for them
    (AR's in float32); 2 buffers where they fit, else 1; rows 0 for a stack
    too wide for either."""
    lib = lib or library("edge_map_tc")
    out = (ctypes.c_longlong * 3)()
    if lib.gcp_edge_map_tc_layout(stack.meta.ctypes.data, stack.meta.size, DTYPE_CODES[dtype], out) != 0:
        raise ValueError("edge_map: malformed layer table")
    return out[0], out[1], out[2]


def k3_library(stack: PackedStack) -> str:
    """The kernel library K3 runs ``stack`` in: ``edge_map_bwd_tc``, or for
    a stack with selu, gelu, sigmoid or tanh ``edge_map_bwd_tc_all`` (the
    same source built for every code, csrc/edge_map_bwd_tc_all.cu)."""
    codes = [KERNEL_ACTIVATIONS.get(_act_name(name), -1) for layer in stack.layers for name in (layer.act_s, layer.act_v)]
    return "edge_map_bwd_tc_all" if max(codes) >= K3_EVERY_CODE_FROM else "edge_map_bwd_tc"


def k3_tile(stack: PackedStack, dtype: torch.dtype, lib=None) -> Tuple[int, int]:
    """K3's ``(tile rows, shared-memory bytes)`` for ``stack`` in ``dtype``:
    64 bf16 or 32 float32 rows, half as many for a stack too wide for them
    (AR's); raises for a stack too wide for either."""
    lib = lib or library(k3_library(stack))
    smem = ctypes.c_longlong(0)
    rows = lib.gcp_edge_map_bwd_tc_tile(stack.meta.ctypes.data, stack.meta.size, DTYPE_CODES[dtype], ctypes.byref(smem))
    if rows < 0:
        raise ValueError("edge_map_backward: malformed layer table")
    if rows == 0:
        raise NotImplementedError(
            "edge_map_backward: the stack's widths need more shared memory than the kernel's tile has"
        )
    return rows, smem.value


def launch_backward(message: Tensor, frames: Tensor, stack: PackedStack, grad_out: Tensor, lib=None):
    """Launch K3 (``csrc/edge_map_bwd_tc.cu``, its build for ``stack``'s
    codes, :func:`k3_library`, or the build ``lib``) on checked CUDA
    tensors: ``(d message, d weights)``.  Each persistent
    block has its own float32 weight-gradient partial and a scratch, in the
    input dtype, for each layer's input state; the weights go to the kernel
    once per call as per-layer images (bf16, or float32 transposed); the tile
height is :func:`k3_tile`'s."""
    e = message.shape[0]
    dev = message.device
    d_message = torch.empty_like(message)
    if e == 0:
        return d_message, torch.zeros_like(stack.weights)
    lib = lib or library(k3_library(stack))
    d_weights = torch.empty(stack.weights.shape, dtype=torch.float32, device=dev)
    code = DTYPE_CODES[message.dtype]
    tile, _ = k3_tile(stack, message.dtype, lib)
    grid = _persistent_grid(e, tile, dev)
    w_len = stack.weights.numel()
    stash_len = tile * sum(s_in + 3 * v_in for s_in, v_in, *_ in (layer.dims for layer in stack.layers[1:]))
    image_bytes = lib.gcp_edge_map_bwd_tc_image_bytes(stack.meta.ctypes.data, stack.meta.size, code)
    if image_bytes < 0:
        raise ValueError("edge_map_backward: malformed layer table")
    images = torch.empty(image_bytes, dtype=torch.uint8, device=dev)
    partials = torch.empty(grid * w_len, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(grid * stash_len, 1), dtype=message.dtype, device=dev)
    err = lib.gcp_edge_map_bwd_tc(
        message.data_ptr(), frames.data_ptr(), grad_out.data_ptr(), stack.weights.data_ptr(),
        stack.meta.ctypes.data, stack.meta.size, d_message.data_ptr(), d_weights.data_ptr(),
        images.data_ptr(), partials.data_ptr(), scratch.data_ptr(), w_len, stash_len, e, grid, code,
        _stream(message),
    )
    if err == CUDA_ERROR_INVALID_CONFIGURATION:
        raise NotImplementedError(
            "edge_map_backward: the stack's widths need more shared memory than the kernel's tile has"
        )
    if err != 0:
        raise RuntimeError(f"edge_map_backward: CUDA launch failed with error {err}")
    return d_message, d_weights


def edge_map_backward(
    message: Tensor, frames: Tensor, stack: PackedStack, grad_out: Tensor
) -> Tuple[Tensor, Tensor]:
    """K3: ``(d message, d weights)`` for the cotangent ``grad_out`` of
    ``edge_map(message, frames, stack)``; ``d message`` in the input dtype,
    ``d weights`` float32 in the flat layout.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (and count the launch in
    ``edge_map_backward.launches`` and, by dtype, in
    ``edge_map_backward.dtype_launches``)."""
    _check(message, frames, stack)
    if grad_out.shape != (message.shape[0], stack.out_dim) or grad_out.dtype != message.dtype:
        raise ValueError(
            f"edge_map_backward: grad_out must be {message.dtype} "
            f"[{message.shape[0]}, {stack.out_dim}], got {grad_out.dtype} {tuple(grad_out.shape)}"
        )
    if message.device.type == "cpu":
        return edge_map_backward_plain(message, frames, stack, grad_out)
    if message.device.type != "cuda":
        raise ValueError(f"edge_map_backward: unsupported device {message.device}")
    _check_kernel_supported(stack)
    d_message, d_weights = launch_backward(message, frames, stack, grad_out.contiguous())
    edge_map_backward.launches += 1
    edge_map_backward.dtype_launches[message.dtype] += 1
    return d_message, d_weights


class EdgeMap(torch.autograd.Function):
    """K2 forward, K3 backward.  Inputs ``(message, frames, weights,
    stack)`` with ``weights is stack.weights``; gradients for ``message``
    and ``weights``."""

    @staticmethod
    def forward(ctx, message: Tensor, frames: Tensor, weights: Tensor, stack: PackedStack):
        if frames.requires_grad:
            raise NotImplementedError(
                "edge_map: no gradient for the frames (tasks that move positions need it)"
            )
        ctx.stack = stack
        ctx.save_for_backward(message, frames)
        return _edge_map_forward(message, frames, stack)

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        message, frames = ctx.saved_tensors
        d_message, d_weights = edge_map_backward(message, frames, ctx.stack, grad_out.contiguous())
        return (
            d_message if ctx.needs_input_grad[0] else None,
            None,
            d_weights if ctx.needs_input_grad[2] else None,
            None,
        )


def edge_map(message: Tensor, frames: Tensor, stack: PackedStack) -> Tensor:
    """The fused stack over edge rows, differentiable in ``message`` and
    the stack's weights (see :class:`EdgeMap`)."""
    _check(message, frames, stack)
    return EdgeMap.apply(message, frames, stack.weights, stack)


edge_map.launches = 0
edge_map_backward.launches = 0
edge_map_backward.dtype_launches = {torch.bfloat16: 0, torch.float32: 0}
