"""Padded shape buckets (also from a unit budget), collation, the
receiver-sorted edge layout, and packing a dataset into batches.

Port of the edge-list parts of ``gcpnet_tpu/data/batching.py``.  Host-side
numpy; the result goes to the card through ``GraphBatch.to``.  Under data
parallelism (``Shards``) each process packs the same groups of shards and
keeps its own.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

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


def pack_by_budget(
    sizes: Sequence[Tuple[int, int]], max_units: int, unit: str = "edge", shuffle_order: Optional[np.ndarray] = None,
) -> List[List[int]]:
    """Graph indices packed greedily into batches of at most ``max_units``
    edges (``unit="edge"``) or nodes (``"node"``), in ``shuffle_order``
    (default: index order), from per-graph ``(num_nodes, num_edges)``
    ``sizes``: the reference ``BatchSampler``'s strategy
    (``gcpnet_tpu/data/batching.py:49-81``).  A graph over the budget alone
    is dropped, as the reference drops it."""
    order = shuffle_order if shuffle_order is not None else np.arange(len(sizes))
    batches: List[List[int]] = []
    current: List[int] = []
    used = 0
    for idx in order:
        n, e = sizes[idx]
        u = e if unit == "edge" else n
        if u > max_units:
            continue
        if used + u > max_units and current:
            batches.append(current)
            current, used = [], 0
        current.append(int(idx))
        used += u
    if current:
        batches.append(current)
    return batches


def make_bucket(max_units: int, unit: str, num_graphs: int, avg_degree: float = 32.0) -> Bucket:
    """The padded bucket of a unit budget (``gcpnet_tpu/data/batching.py:
    84-98``): an edge budget holds ``max_units`` edge rows and
    ``max_units / avg_degree x 1.5 + 8`` nodes; a node budget
    ``max_units`` nodes and ``max_units x avg_degree + 8`` edge rows."""
    if unit == "edge":
        return Bucket(num_nodes=int(max_units / max(avg_degree, 1.0) * 1.5) + 8, num_edges=max_units,
                      num_graphs=num_graphs)
    return Bucket(num_nodes=max_units, num_edges=int(max_units * avg_degree) + 8, num_graphs=num_graphs)


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
    index: int = 0,
) -> GraphBatch:
    """Shard ``index`` of a group of shards, padded into ``bucket`` with
    shard-local indices, and its edges optionally sorted by receiver
    (``sort_tile`` is :func:`sort_edges_by_receiver`'s ``tile``).

    The JAX function (``gcpnet_tpu/data/batching.py:349-405``) concatenates
    every shard's sub-batch for its data-parallel mesh, which hands device
    ``i`` sub-batch ``i``; in the port each process takes its own shard, so
    this is that sub-batch.  An empty shard (the padded tail of an epoch)
    takes its arrays' shapes from ``like``, by default the first graph of
    any shard.
    """
    if like is None:
        like = next((graphs[0] for graphs in shard_graphs if graphs), None)
    batch = batch_graphs(
        shard_graphs[index],
        num_nodes=bucket.num_nodes,
        num_edges=bucket.num_edges,
        num_graphs=bucket.num_graphs,
        extra_graph_keys=extra_graph_keys,
        like=like,
    )
    if sort_edges:
        batch = sort_edges_by_receiver(batch, tile=sort_tile)
    return batch


@dataclasses.dataclass(frozen=True)
class Shards:
    """The data-parallel layout a process reads its batches in: each global
    batch is a group of ``count`` self-contained shards (one a process,
    ``count`` the world size) and this process takes shard ``index`` (its
    rank); over ``nodes`` machines, the machine of rank ``index`` first
    takes every ``nodes``-th graph of the epoch's order, as a JAX process
    of a multi-host run does."""

    count: int = 1
    index: int = 0
    nodes: int = 1

    def __post_init__(self):
        if not 0 <= self.index < self.count or self.nodes < 1 or self.count % self.nodes:
            raise ValueError(f"Shards: rank {self.index} of {self.count} over {self.nodes} nodes")

    @property
    def node(self) -> int:
        return self.index // (self.count // self.nodes)

    def split(self, items: Sequence) -> Sequence:
        """This process's equal share of ``items`` (whose length ``count``
        divides): the JAX mesh's slice of a rectangular batch."""
        if len(items) % self.count:
            raise ValueError(f"a batch of {len(items)} does not split into {self.count} shards")
        per = len(items) // self.count
        return items[self.index * per : (self.index + 1) * per]


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
    shards: Shards = Shards(),
    drop_last: bool = False,
) -> Iterator[GraphBatch]:
    """Pack host graphs into padded batches of ``bucket``, in order, each
    batch receiver-sorted with plain CSR row splits (``tile=1``), so that on the
    card K1 sums every batch.

    Port of ``gcpnet_tpu/data/batching.py:407-475``: graphs are added to a
    shard until one more would overflow the bucket's nodes, edges or
    graphs, then the next shard starts; a graph larger than the bucket is
    skipped.  Each full group of ``shards.count`` shards gives this
    process's shard (``shards.index``), so that every process steps the
    same number of times.  The last, incomplete group is dropped with
    ``drop_last``, else padded with empty shards (one shard is always a
    complete group, so with one shard the last batch is always kept).
    With ``shards.nodes`` above 1, this node packs only every
    ``shards.nodes``-th graph, from its own.
    """
    if shards.nodes > 1:
        graphs = itertools.islice(graphs, shards.node, None, shards.nodes)
    group: List[List[GraphData]] = []
    shard: List[GraphData] = []
    n_used = e_used = 0

    def emit():
        return collate_shards(
            group + [[]] * (shards.count - len(group)), bucket, extra_graph_keys,
            sort_edges=True, sort_tile=1, index=shards.index,
        )

    for g in graphs:
        if g.num_nodes > bucket.num_nodes or g.num_edges > bucket.num_edges:
            continue
        if (
            n_used + g.num_nodes > bucket.num_nodes
            or e_used + g.num_edges > bucket.num_edges
            or len(shard) >= bucket.num_graphs
        ):
            group.append(shard)
            shard, n_used, e_used = [], 0, 0
            if len(group) == shards.count:
                yield emit()
                group = []
        shard.append(g)
        n_used += g.num_nodes
        e_used += g.num_edges
    if shard:
        group.append(shard)
    if group and (len(group) == shards.count or not drop_last):
        yield emit()
