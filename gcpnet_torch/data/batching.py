"""Padded shape buckets, collation, the receiver-sorted edge layout, and
packing a dataset into batches.

Port of the edge-list parts of ``gcpnet_tpu/data/batching.py``.  Host-side
numpy; the result goes to the card through ``GraphBatch.to``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from gcpnet_torch.graph import GraphBatch, GraphData, batch_graphs


# graphs featurized at once, on threads (numpy and scipy release the GIL in
# their array work), and how many may be made ahead of the one packed
FEATURIZE_THREADS = min(8, os.cpu_count() or 1)
FEATURIZE_AHEAD = 4 * FEATURIZE_THREADS


def made_ahead(fn: Callable, items: Iterable) -> Iterator[Future]:
    """The futures of ``fn(item)`` for each item, in order, computed on
    FEATURIZE_THREADS threads at most FEATURIZE_AHEAD items ahead of the
    one the caller reads."""
    with ThreadPoolExecutor(FEATURIZE_THREADS) as pool:
        pending = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= FEATURIZE_AHEAD:
                yield pending.popleft()
        yield from pending


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One static padded shape: (nodes, edges, graphs) per batch."""

    num_nodes: int
    num_edges: int
    num_graphs: int


def sorted_index(index: np.ndarray, valid: np.ndarray, num_segments: int):
    """``(perm, inv, splits)``: the rows with ``valid`` stably sorted by
    ``index``, then the others in their order; its inverse; and each
    segment's ``[S+1]`` int32 range of sorted rows (the host side of
    ``ops.segment.SortedIndex``)."""
    index = np.asarray(index).astype(np.int64)
    valid = np.asarray(valid, dtype=bool)
    perm = np.argsort(np.where(valid, index, num_segments), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    counts = np.bincount(index[valid], minlength=num_segments)
    splits = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return perm, inv, splits


def with_sorted_indices(batch: GraphBatch) -> GraphBatch:
    """``batch`` with the sorted forms of its senders (``sender_perm``,
    ``sender_inv_perm``, ``sender_splits``) and of its nodes' graph ids
    (``graph_splits``: the real nodes must come first, in graph order)."""
    perm, inv, splits = sorted_index(batch.senders, batch.edge_pad_mask, batch.num_nodes)
    real = np.asarray(batch.node_pad_mask, dtype=bool)
    graph_id = np.asarray(batch.graph_id)
    n_real = int(real.sum())
    if not real[:n_real].all() or np.any(np.diff(graph_id[:n_real]) < 0):
        raise ValueError("with_sorted_indices: the real nodes must come first, in graph order")
    counts = np.bincount(graph_id[:n_real], minlength=batch.num_graphs)
    graph_splits = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return batch.replace(sender_perm=perm, sender_inv_perm=inv, sender_splits=splits, graph_splits=graph_splits)


def sort_edges_by_receiver(batch: GraphBatch, tile: int = 128) -> GraphBatch:
    """Reorder a batch's edges so real edges are sorted by receiver and
    attach ``[N+1]`` row splits: node ``n`` owns edge rows
    ``[splits[n], splits[n+1])``.

    Each ``tile``-node group's edge segment is padded up to a ``tile``-edge
    boundary (the TPU kernel's DMA alignment).  The alignment holes are
    padding rows that fall inside the range of the last node of each group,
    so every consumer must mask them.  ``tile=1`` gives plain CSR splits with
    no holes.  Without enough spare edge slots for the alignment the edges
    are still sorted but no splits are attached.  The sorted forms of the
    senders and of the graph ids are attached too
    (:func:`with_sorted_indices`).
    """
    receivers = np.asarray(batch.receivers)
    num_edges = receivers.shape[0]
    num_nodes = batch.num_nodes
    if num_nodes == num_edges:
        # extras are reordered when their leading dim equals num_edges; with
        # equal counts node-level extras would be scrambled
        raise ValueError(
            "sort_edges_by_receiver: bucket has num_nodes == num_edges "
            f"({num_nodes}); extras reordering would be ambiguous — pad the "
            "bucket so the counts differ"
        )
    pad = ~np.asarray(batch.edge_pad_mask)
    # real edges by receiver, then the padding, each in its original order
    # (a stable sort: the JAX function's lexsort with the row as the tie key)
    order = np.argsort(receivers.astype(np.int64) + pad * (num_nodes + 1), kind="stable")
    real = int((~pad).sum())
    sorted_recv = receivers[order][:real]
    counts = np.bincount(sorted_recv, minlength=num_nodes)

    n_tiles = (num_nodes + tile - 1) // tile
    tile_counts = np.add.reduceat(
        np.pad(counts, (0, n_tiles * tile - num_nodes)),
        np.arange(0, n_tiles * tile, tile),
    )
    aligned = ((tile_counts + tile - 1) // tile) * tile
    total_aligned = int(aligned.sum())

    if total_aligned > num_edges:
        splits = None
        final_order = order
    else:
        tile_starts = np.concatenate([[0], np.cumsum(aligned)[:-1]])
        cum_real = np.concatenate([[0], np.cumsum(tile_counts)[:-1]])
        recv_tile = sorted_recv // tile
        within = np.arange(real) - cum_real[recv_tile]
        dest = tile_starts[recv_tile] + within
        final_order = np.full(num_edges, -1, dtype=np.int64)
        final_order[dest] = order[:real]
        # the remaining slots (holes and tail) take the padding edges;
        # total_aligned <= num_edges guarantees there are enough
        spare = order[real:]
        holes = np.where(final_order < 0)[0]
        final_order[holes[: spare.shape[0]]] = spare
        splits_within = np.concatenate([[0], np.cumsum(counts)])
        node_tile = np.arange(num_nodes) // tile
        node_local_start = splits_within[:-1] - cum_real[node_tile]
        starts = tile_starts[node_tile] + node_local_start
        ends = starts + counts
        splits = np.concatenate([starts, [ends[-1] if num_nodes else 0]])
        splits = splits.astype(np.int32)

    def reorder(arr):
        return None if arr is None else np.asarray(arr)[final_order]

    extras = {
        k: (
            np.asarray(v)[final_order]
            if np.asarray(v).shape[:1] == receivers.shape
            else v
        )
        for k, v in batch.extras.items()
    }
    return with_sorted_indices(batch.replace(
        e=reorder(batch.e),
        xi=reorder(batch.xi),
        senders=reorder(batch.senders),
        receivers=reorder(batch.receivers),
        edge_pad_mask=np.asarray(batch.edge_pad_mask)[final_order],
        edge_row_splits=splits,
        extras=extras,
    ))


def collate_shards(
    shard_graphs: Sequence[Sequence[GraphData]],
    bucket: Bucket,
    extra_graph_keys: Sequence[str] = (),
    like: Optional[GraphData] = None,
    sort_edges: bool = False,
    sort_tile: int = 128,
) -> GraphBatch:
    """Pad one shard's graphs into ``bucket`` and optionally sort its edges
    by receiver (``sort_tile`` is :func:`sort_edges_by_receiver`'s
    ``tile``).

    The JAX package concatenates several shard-local sub-batches for its
    data-parallel mesh; the port runs on one card, so exactly one shard is
    accepted until data parallelism is ported.
    """
    if len(shard_graphs) != 1:
        raise ValueError(
            f"collate_shards: the port takes one shard, got {len(shard_graphs)}"
        )
    graphs = shard_graphs[0]
    batch = batch_graphs(
        graphs,
        num_nodes=bucket.num_nodes,
        num_edges=bucket.num_edges,
        num_graphs=bucket.num_graphs,
        extra_graph_keys=extra_graph_keys,
        like=like if like is not None else (graphs[0] if graphs else None),
    )
    if sort_edges:
        batch = sort_edges_by_receiver(batch, tile=sort_tile)
    return batch


def shuffled_order(n: int, seed: int) -> np.ndarray:
    """``range(n)`` in the order ``np.random.default_rng(seed).shuffle``
    gives it: the JAX ``batches_from_dataset``'s order of an epoch's
    graphs."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return order


def batches_from_dataset(
    graphs: Iterable[GraphData],
    bucket: Bucket,
    extra_graph_keys: Sequence[str] = (),
) -> Iterator[GraphBatch]:
    """Pack host graphs into padded batches of ``bucket``, in order, each
    batch receiver-sorted with plain CSR row splits (``tile=1``), so that on the
    card K1 sums every batch.

    Port of ``gcpnet_tpu/data/batching.py:407-475`` for one shard: graphs
    are added to the batch until one more would overflow the bucket's
    nodes, edges or graphs, then the batch is emitted; a graph larger than
    the bucket is skipped.  The last batch is emitted however full it is:
    the JAX function's ``drop_last`` drops an incomplete set of *shards*,
    and one shard is always complete, so with one shard it keeps the last
    batch too and the port has no such flag.
    """
    shard: List[GraphData] = []
    n_used = e_used = 0

    def emit():
        return collate_shards([shard], bucket, extra_graph_keys, sort_edges=True, sort_tile=1)

    for g in graphs:
        if g.num_nodes > bucket.num_nodes or g.num_edges > bucket.num_edges:
            continue
        if (
            n_used + g.num_nodes > bucket.num_nodes
            or e_used + g.num_edges > bucket.num_edges
            or len(shard) >= bucket.num_graphs
        ):
            yield emit()
            shard, n_used, e_used = [], 0, 0
        shard.append(g)
        n_used += g.num_nodes
        e_used += g.num_edges
    if shard:
        yield emit()
