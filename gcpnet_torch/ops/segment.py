"""Masked segment reductions over statically padded index arrays.

Port of ``gcpnet_tpu/ops/segment.py`` (edge-list and receiver-sorted
layouts).  Semantics follow ``torch_scatter.scatter``:

- ``sum``: masked entries contribute zero.
- ``mean``: sum divided by a per-segment count clamped to >= 1, so empty
  segments give exactly 0.  The numerator ``mask`` and the denominator
  ``count_mask`` can differ (scalarize with a node mask zeroes rows but
  still counts them).

Sums and counts accumulate in float32 and are returned in the input dtype.
(A bfloat16 scatter-add, which the JAX package runs on XLA:CPU, stops
counting at 256 and drifts on long sums: the LBA pool averages 448 atoms.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from gcpnet_torch.ops.segment_sorted import segment_sum_sorted


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data: Tensor, index: Tensor) -> Tensor:
        ctx.save_for_backward(index)
        ctx.num_rows = data.shape[0]
        return data[index]

    @staticmethod
    def backward(ctx, grad: Tensor):
        (index,) = ctx.saved_tensors
        out = torch.zeros((ctx.num_rows,) + tuple(grad.shape[1:]), dtype=torch.float32, device=grad.device)
        return out.index_add_(0, index, grad.float()).to(grad.dtype), None


def gather_rows(data: Tensor, index: Tensor) -> Tensor:
    """``data[index]`` for an int64 row index, whose gradient is an
    ``index_add_`` accumulated in float32 and rounded once (the gradient of
    plain indexing sorts the index on the card first, which costs more than
    the rest of the message passing's glue)."""
    return _GatherRows.apply(data, index)


def _apply_mask(data: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return data
    mask = mask.to(data.dtype)
    return data * mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))


def segment_sum(
    data: Tensor,
    segment_ids: Tensor,
    num_segments: int,
    mask: Optional[Tensor] = None,
    row_splits: Optional[Tensor] = None,
) -> Tensor:
    """Masked sum of ``data`` rows into ``num_segments`` buckets.

    ``row_splits`` (``[num_segments+1]`` int32, rows sorted by segment)
    routes the sum through the sorted segment-sum kernel
    (``ops.segment_sorted``); it then needs ``mask``, because the sorted
    layout's alignment-hole rows fall inside the range of the last node of
    each tile.  Otherwise the sum is an ``index_add_`` over
    ``segment_ids``.
    """
    data = _apply_mask(data, mask)
    if row_splits is not None and data.dim() == 2:
        if mask is None:
            raise ValueError(
                "segment_sum: row_splits (sorted path) requires a mask "
                "zeroing the padding/alignment rows"
            )
        return segment_sum_sorted(data, row_splits, num_segments)
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=torch.float32, device=data.device
    )
    return out.index_add_(0, segment_ids, data.float()).to(data.dtype)


def segment_count(
    segment_ids: Tensor, num_segments: int, mask: Optional[Tensor] = None
) -> Tensor:
    """Masked float32 count of rows per segment."""
    ones = _apply_mask(torch.ones(segment_ids.shape, device=segment_ids.device), mask)
    out = torch.zeros((num_segments,), device=segment_ids.device)
    return out.index_add_(0, segment_ids, ones)


def segment_mean(
    data: Tensor,
    segment_ids: Tensor,
    num_segments: int,
    mask: Optional[Tensor] = None,
    count_mask: Optional[Tensor] = None,
    row_splits: Optional[Tensor] = None,
) -> Tensor:
    """Masked mean: ``mask`` gates the numerator, ``count_mask`` (default
    ``mask``) the denominator; counts are clamped to >= 1.  Counts always
    come from the masked scatter of ones, never from split widths, which
    include the sorted layout's alignment holes."""
    if count_mask is None:
        count_mask = mask
    total = segment_sum(data, segment_ids, num_segments, mask=mask, row_splits=row_splits)
    count = torch.clamp(segment_count(segment_ids, num_segments, mask=count_mask), min=1.0)
    mean = total.float() / count.reshape(count.shape + (1,) * (total.dim() - 1))
    return mean.to(total.dtype)


def sender_mean(
    data: Tensor,
    senders: Tensor,
    num_nodes: int,
    mask: Optional[Tensor] = None,
    count_mask: Optional[Tensor] = None,
) -> Tensor:
    """Per-node masked mean of outgoing-edge rows (the scatter form; the
    sender-dense permutation of the JAX package is not ported)."""
    return segment_mean(data, senders, num_nodes, mask=mask, count_mask=count_mask)


def masked_mean(
    data: Tensor, mask: Optional[Tensor], dim=None, keepdim: bool = False
) -> Tensor:
    """Mean over ``dim`` counting only elements where the broadcast
    ``mask`` is set."""
    if mask is None:
        return data.mean() if dim is None else data.mean(dim=dim, keepdim=keepdim)
    m = mask.to(data.dtype)
    m = m.reshape(m.shape + (1,) * (data.dim() - m.dim())).expand(data.shape)
    if dim is None:
        total, count = (data * m).sum(), m.sum()
    else:
        total = (data * m).sum(dim=dim, keepdim=keepdim)
        count = m.sum(dim=dim, keepdim=keepdim)
    return total / torch.clamp(count, min=1.0)
