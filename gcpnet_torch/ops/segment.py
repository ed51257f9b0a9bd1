"""Masked segment reductions over statically padded index arrays.

Port of ``gcpnet_tpu/ops/segment.py`` (the edge-list, receiver-sorted and
dense layouts).  Semantics follow ``torch_scatter.scatter``:

- ``sum``: masked entries contribute zero.
- ``mean``: sum divided by a per-segment count clamped to >= 1, so empty
  segments give exactly 0.  The numerator ``mask`` and the denominator
  ``count_mask`` can differ (scalarize with a node mask zeroes rows but
  still counts them).

Sums and counts accumulate in float32 and are returned in the input dtype.
(A bfloat16 scatter-add, which the JAX package runs on XLA:CPU, stops
counting at 256 and drifts on long sums: the LBA pool averages 448 atoms.)

An index may come with its sorted form (:class:`SortedIndex`, built on the
host by ``data.batching.sorted_index``).  A sum over it is then the sorted
segment sum (``ops.segment_sorted``, kernel K1) over its rows taken in
segment order, its backward a gather; a gather over it
(:func:`gather_rows`) has K1 over the cotangent rows as its backward; a
count is a difference of prefix sums at the splits.  None of them scatters,
so on the card each gives the same bits from run to run.  Rows outside
every segment (the batch's padding) are left out of a sorted sum and of a
gather's backward: every consumer of gathered rows masks the padding rows
before it reduces them (the JAX ``gather_by_senders`` contract,
``gcpnet_tpu/ops/segment.py:227-233``), so their cotangents are zero.
Without a sorted form a sum, a count and a gather's backward are an
``index_add_``, on the CPU only: on the card each needs the index's sorted
form and raises without it.

The dense fixed-degree layout's receivers come as a :class:`DenseIndex`:
rows ``[K*N, ...]`` are slot-major (row ``k*N+n`` belongs to node ``n``),
so a sum is the ``[K, N, ...]`` slot sum (:func:`dense_slot_reduce`, the
JAX ``_dense_slot_reduce``: a plain torch reduction, accumulated in
float32 as K1 accumulates, which needs the mask that zeroes the padding
slots) and a gather is a broadcast (its backward the same slot sum).  The
JAX package reaches its sender-side sums and gathers' backward in that
layout through the slot-major sender permutation
(``gather_by_senders``, ``sender_sum``, ``sender_mean``); the port keeps
the senders' sorted form, that permutation's CSR form, so that they are
:func:`gather_rows`, :func:`segment_sum` and :func:`sender_mean` over a
:class:`SortedIndex` and run through K1 as in the sorted layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import Tensor

from gcpnet_torch.ops.segment_sorted import _check, _segment_sum_sorted_forward, segment_sum_sorted


class SortedIndex(NamedTuple):
    """A row index into segments with its sorted form.  ``perm`` lists the
    rows segment by segment, stably, with the rows of no segment (padding)
    after the others; ``inv`` is its inverse; segment ``s`` holds the sorted
    positions ``[splits[s], splits[s+1])`` (``[S+1]`` int32).  ``perm`` and
    ``inv`` are ``None`` where the rows are in segment order already (the
    receivers of a receiver-sorted batch, the graph ids of nodes)."""

    index: Tensor
    splits: Tensor
    perm: Optional[Tensor] = None
    inv: Optional[Tensor] = None

    def sorted_rows(self, data: Tensor) -> Tensor:
        """``data``'s rows in segment order (no autograd)."""
        return data if self.perm is None else data[self.perm]

    def unsorted_rows(self, data: Tensor) -> Tensor:
        """The inverse of :meth:`sorted_rows` (no autograd)."""
        return data if self.inv is None else data[self.inv]


class DenseIndex(NamedTuple):
    """The receivers of the dense slot-major layout: ``index[k*N+n] = n``
    for real and padding slots alike, ``degree`` the slots K a node."""

    index: Tensor
    degree: int


Index = Union[Tensor, SortedIndex, DenseIndex]


def index_of(ids: Index) -> Tensor:
    """The row index of ``ids``, in whatever form it comes."""
    return ids.index if isinstance(ids, (SortedIndex, DenseIndex)) else ids


def dense_slot_reduce(data: Tensor, degree: int, num_rows: int) -> Tensor:
    """Sum ``[degree*num_rows, ...]`` slot-major rows over the slot axis,
    accumulated in float32 and returned in ``data``'s dtype."""
    if data.shape[0] != degree * num_rows:
        raise ValueError(f"dense layout expects {degree} x {num_rows} rows, got {data.shape[0]}")
    slots = data.reshape((degree, num_rows) + tuple(data.shape[1:]))
    return slots.sum(dim=0, dtype=torch.float32).to(data.dtype)


def dense_broadcast(data: Tensor, degree: int) -> Tensor:
    """``data [N, ...]`` repeated for each of ``degree`` slots: the rows
    ``[degree*N, ...]`` a slot-major gather by receiver gives."""
    return data.unsqueeze(0).expand((degree,) + tuple(data.shape)).reshape(
        (degree * data.shape[0],) + tuple(data.shape[1:]))


def _plain_on_cpu(t: Tensor, what: str) -> None:
    """``index_add_`` (whose float additions meet in another order on every
    run on the card) serves CPU tensors only."""
    if t.device.type != "cpu":
        raise ValueError(f"{what} on the card needs the index's sorted form (ops.segment.SortedIndex)")


def _sorted_sum(data: Tensor, sidx: SortedIndex, num_segments: int) -> Tensor:
    """K1 over ``data``'s rows in segment order (no autograd)."""
    rows = sidx.sorted_rows(data).contiguous()
    _check(rows, sidx.splits, num_segments)
    return _segment_sum_sorted_forward(rows, sidx.splits, num_segments)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data: Tensor, index: Tensor, sidx: Optional[SortedIndex]) -> Tensor:
        ctx.save_for_backward(index)
        ctx.sidx = sidx
        ctx.num_rows = data.shape[0]
        return data[index]

    @staticmethod
    def backward(ctx, grad: Tensor):
        (index,) = ctx.saved_tensors
        if ctx.sidx is not None:
            return _sorted_sum(grad.reshape(grad.shape[0], -1), ctx.sidx, ctx.num_rows).reshape(
                (ctx.num_rows,) + tuple(grad.shape[1:])), None, None
        _plain_on_cpu(grad, "gather_rows: a gather's backward")
        out = torch.zeros((ctx.num_rows,) + tuple(grad.shape[1:]), dtype=torch.float32, device=grad.device)
        return out.index_add_(0, index, grad.float()).to(grad.dtype), None, None


def gather_rows(data: Tensor, index: Index) -> Tensor:
    """``data[index]`` for an int64 row index.  With the index's sorted form
    the gradient is K1 over the cotangent rows in segment order; with a
    :class:`DenseIndex` the gather is a broadcast (the gradient its slot
    sum); without either (on the CPU only) an ``index_add_`` accumulated in
    float32 and rounded once."""
    if isinstance(index, DenseIndex):
        return dense_broadcast(data, index.degree)
    if isinstance(index, SortedIndex):
        return _GatherRows.apply(data, index.index, index)
    return _GatherRows.apply(data, index, None)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data: Tensor, sidx: SortedIndex) -> Tensor:
        ctx.sidx = sidx
        return sidx.sorted_rows(data)

    @staticmethod
    def backward(ctx, grad: Tensor):
        return ctx.sidx.unsorted_rows(grad), None


def _apply_mask(data: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return data
    mask = mask.to(data.dtype)
    return data * mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))


def segment_sum(
    data: Tensor,
    segment_ids: Index,
    num_segments: int,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Masked sum of ``data`` rows into ``num_segments`` buckets: K1 over
    the rows in segment order where ``segment_ids`` is a
    :class:`SortedIndex` (a receiver-sorted layout's alignment-hole rows
    fall inside the range of the last node of each tile, so ``mask`` must
    zero them there), the slot sum where it is a :class:`DenseIndex`
    (``mask`` required: the padding slots' rows need not be zero),
    otherwise (on the CPU only) an ``index_add_``."""
    if isinstance(segment_ids, DenseIndex):
        if mask is None:
            raise ValueError("segment_sum: the dense layout needs a mask zeroing the padding slots")
        return dense_slot_reduce(_apply_mask(data, mask), segment_ids.degree, num_segments)
    data = _apply_mask(data, mask)
    if isinstance(segment_ids, SortedIndex):
        rows = data if segment_ids.perm is None else _PermuteRows.apply(data, segment_ids)
        out = segment_sum_sorted(rows.reshape(rows.shape[0], -1).contiguous(), segment_ids.splits, num_segments)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))
    _plain_on_cpu(data, "segment_sum")
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=torch.float32, device=data.device
    )
    return out.index_add_(0, segment_ids, data.float()).to(data.dtype)


def segment_count(
    segment_ids: Index, num_segments: int, mask: Optional[Tensor] = None
) -> Tensor:
    """Masked float32 count of rows per segment: with a sorted index the
    difference of the sorted mask's prefix sums at the splits (integers,
    exact), in the dense layout the slot sum of the mask, otherwise (on the
    CPU only) an ``index_add_`` of ones."""
    if isinstance(segment_ids, DenseIndex):
        ones = torch.ones(segment_ids.index.shape, device=segment_ids.index.device)
        return dense_slot_reduce(_apply_mask(ones, mask), segment_ids.degree, num_segments)
    if isinstance(segment_ids, SortedIndex):
        ids = segment_ids.index
        ones = torch.ones(ids.shape, dtype=torch.int32, device=ids.device) if mask is None else mask.to(torch.int32)
        prefix = torch.cumsum(segment_ids.sorted_rows(ones), 0, dtype=torch.int32)
        prefix = torch.cat([prefix.new_zeros(1), prefix])
        splits = segment_ids.splits.long()
        return (prefix[splits[1:]] - prefix[splits[:-1]]).float()
    _plain_on_cpu(segment_ids, "segment_count")
    ones = _apply_mask(torch.ones(segment_ids.shape, device=segment_ids.device), mask)
    out = torch.zeros((num_segments,), device=segment_ids.device)
    return out.index_add_(0, segment_ids, ones)


def segment_mean(
    data: Tensor,
    segment_ids: Index,
    num_segments: int,
    mask: Optional[Tensor] = None,
    count_mask: Optional[Tensor] = None,
) -> Tensor:
    """Masked mean: ``mask`` gates the numerator, ``count_mask`` (default
    ``mask``) the denominator; counts are clamped to >= 1.  Counts always
    come from the masked rows (:func:`segment_count`), never from split
    widths, which include the sorted layout's alignment holes."""
    if count_mask is None:
        count_mask = mask
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    count = torch.clamp(segment_count(segment_ids, num_segments, mask=count_mask), min=1.0)
    mean = total.float() / count.reshape(count.shape + (1,) * (total.dim() - 1))
    return mean.to(total.dtype)


def sender_mean(
    data: Tensor,
    senders: Index,
    num_nodes: int,
    mask: Optional[Tensor] = None,
    count_mask: Optional[Tensor] = None,
) -> Tensor:
    """Per-node masked mean of outgoing-edge rows: K1 over the rows sorted
    by sender when ``senders`` is a :class:`SortedIndex` (the CSR form of
    the JAX ``build_sender_perm``), else (on the CPU only) a scatter."""
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
