"""K1: segment sum over receiver-sorted edge rows.

``segment_sum_sorted(data, row_splits, num_nodes)`` computes ``out[n] =
sum(data[row_splits[n]:row_splits[n+1]])`` with float32 accumulation,
returned in the input dtype.  Rows outside ``[row_splits[0],
row_splits[-1])`` belong to no node.  It replaces the TPU kernel
``gcpnet_tpu/ops/pallas_segment.py:_seg_sum_kernel``; on CUDA tensors the
wrapper launches the hand-written kernel ``csrc/segment_sorted.cu``, on CPU
tensors it runs :func:`segment_sum_sorted_plain`.  Its gradient is the
gather of ``_seg_sum_bwd`` (``pallas_segment.py:175-183``), plain torch on
both devices, as it is an XLA gather in the JAX package.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gcpnet_torch.ops.build import library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def segment_sum_sorted_plain(data: Tensor, row_splits: Tensor, num_nodes: int) -> Tensor:
    """Plain PyTorch version: an ``index_add_`` over the node ids that the
    splits give each row, accumulated in float32."""
    rows = torch.arange(data.shape[0], device=data.device)
    splits = row_splits.to(torch.int64)
    seg = torch.searchsorted(splits[1:], rows, right=True)
    valid = (rows >= splits[0]) & (rows < splits[-1])
    out = torch.zeros((num_nodes, data.shape[1]), dtype=torch.float32, device=data.device)
    out.index_add_(0, seg[valid], data[valid].float())
    return out.to(data.dtype)


def _check(data: Tensor, row_splits: Tensor, num_nodes: int) -> None:
    if data.dim() != 2:
        raise ValueError(f"segment_sum_sorted: data must be [E, D], got {tuple(data.shape)}")
    if data.dtype not in DTYPE_CODES:
        raise TypeError(f"segment_sum_sorted: dtype {data.dtype} not in float32/bfloat16")
    if row_splits.dtype != torch.int32 or row_splits.shape != (num_nodes + 1,):
        raise ValueError(
            f"segment_sum_sorted: row_splits must be int32 [{num_nodes + 1}], "
            f"got {row_splits.dtype} {tuple(row_splits.shape)}"
        )
    if row_splits.device != data.device:
        raise ValueError("segment_sum_sorted: data and row_splits on different devices")
    if not (data.is_contiguous() and row_splits.is_contiguous()):
        raise ValueError("segment_sum_sorted: data and row_splits must be contiguous")


def _segment_sum_sorted_forward(data: Tensor, row_splits: Tensor, num_nodes: int) -> Tensor:
    """K1.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (and count the launch in ``segment_sum_sorted.launches``)."""
    if data.device.type == "cpu":
        return segment_sum_sorted_plain(data, row_splits, num_nodes)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {data.device}")
    out = torch.empty((num_nodes, data.shape[1]), dtype=data.dtype, device=data.device)
    err = library("segment_sorted").gcp_segment_sum_sorted(
        data.data_ptr(), row_splits.data_ptr(), out.data_ptr(),
        data.shape[0], num_nodes, data.shape[1], DTYPE_CODES[data.dtype],
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segment_sum_sorted: CUDA launch failed with error {err}")
    segment_sum_sorted.launches += 1
    return out


def segment_sum_sorted_backward(grad: Tensor, row_splits: Tensor, num_rows: int) -> Tensor:
    """``d data``: each row in ``[row_splits[0], row_splits[-1])`` takes the
    gradient of its node, the other rows 0."""
    rows = torch.arange(num_rows, device=grad.device)
    splits = row_splits.to(torch.int64)
    seg = torch.searchsorted(splits[1:], rows, right=True)
    valid = (rows >= splits[0]) & (rows < splits[-1])
    picked = grad[seg.clamp(max=max(grad.shape[0] - 1, 0))]
    return torch.where(valid[:, None], picked, torch.zeros((), dtype=grad.dtype, device=grad.device))


class SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data: Tensor, row_splits: Tensor, num_nodes: int) -> Tensor:
        ctx.save_for_backward(row_splits)
        ctx.num_rows = data.shape[0]
        return _segment_sum_sorted_forward(data, row_splits, num_nodes)

    @staticmethod
    def backward(ctx, grad: Tensor):
        (row_splits,) = ctx.saved_tensors
        return segment_sum_sorted_backward(grad, row_splits, ctx.num_rows), None, None


def segment_sum_sorted(data: Tensor, row_splits: Tensor, num_nodes: int) -> Tensor:
    """The sorted segment sum, differentiable in ``data`` (see
    :class:`SegmentSumSorted`)."""
    _check(data, row_splits, num_nodes)
    return SegmentSumSorted.apply(data, row_splits, num_nodes)


segment_sum_sorted.launches = 0
