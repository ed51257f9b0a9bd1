"""Statically padded graph batches: the numpy host side and its torch form.

Port of ``gcpnet_tpu/graph.py``.  Every batch has static ``(num_nodes,
num_edges, num_graphs)`` shapes; validity is carried by boolean masks.
Feature conventions: node scalars ``h [N, ds]`` (or int atom types
``[N]``), node vectors ``chi [N, m, 3]``, edge scalars ``e [E, de]``, edge
vectors ``xi [E, me, 3]``, positions ``x [N, 3]``, directed edges
``senders -> receivers``.

A :class:`GraphBatch` holds numpy arrays while the host builds it
(:func:`batch_graphs`, ``gcpnet_torch.data.batching``) and torch tensors
after :meth:`GraphBatch.to`.

Three edge layouts: the edge list, the receiver-sorted layout and the
dense fixed-degree layout.  A receiver-sorted batch also carries the
sorted forms of its indices (:meth:`GraphBatch.receiver_index`,
:meth:`GraphBatch.sender_index`, :meth:`GraphBatch.graph_index`), so that
on the card every sum and every gather's backward runs through K1
(``ops.segment``).  A dense batch (``edge_dense_degree`` K,
``data.batching.densify_edges_by_receiver``) is SLOT-MAJOR: edge row
``k*N+n`` holds node ``n``'s k-th incoming edge, so its receiver index is
an ``ops.segment.DenseIndex`` (sums over the slot axis, gathers as
broadcasts), while its senders keep their sorted form.  The JAX package's
comment on ``GraphBatch.edge_dense_degree`` (``gcpnet_tpu/graph.py:69-70``)
calls that layout node-major (row ``n*K+j``), but its code is slot-major
(``gcpnet_tpu/data/batching.py:256, 292``; ``gcpnet_tpu/ops/segment.py:
100-103``), as the port is.  ``edge_dense_degree`` and
``sender_out_degree`` are Python ints (``STATIC_FIELDS``), kept as they
are by :meth:`GraphBatch.to` and named in a captured step's batch key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from gcpnet_torch.ops.segment import DenseIndex, SortedIndex

Array = Any  # np.ndarray on the host, torch.Tensor after GraphBatch.to

# the batch's layout as Python ints, not arrays
STATIC_FIELDS = ("edge_dense_degree", "sender_out_degree")


@dataclasses.dataclass
class GraphBatch:
    """A padded batch of graphs with static shapes.

    Attributes:
      h:    [N, ds] node scalar features (float) or [N] int atom-type ids.
      chi:  [N, m, 3] node vector features.
      e:    [E, de] edge scalar features.
      xi:   [E, me, 3] edge vector features.
      x:    [N, 3] node positions.
      senders:   [E] source node index per edge.
      receivers: [E] destination node index per edge.
      graph_id:  [N] graph index per node.
      node_pad_mask:  [N] bool, True for real nodes.
      edge_pad_mask:  [E] bool, True for real edges.
      graph_pad_mask: [G] bool, True for real graphs.
      node_mask: optional [N] bool semantic mask (nodes that exist but whose
        features are invalid); ``None`` when a task has none.
      edge_row_splits: optional [N+1] int32 edge ranges when edges are
        sorted by receiver (``data.batching.sort_edges_by_receiver``).
      sender_perm, sender_inv_perm, sender_splits: optional ``[E]``, ``[E]``
        and ``[N+1]``: the edge rows stably sorted by sender (the padding
        rows last), its inverse, and each node's range of sorted rows (the
        CSR form of the JAX ``build_sender_perm``).
      graph_splits: optional [G+1] each graph's range of nodes (the real
        nodes are in graph order, the padding nodes after them).
      extras: task-specific arrays keyed by name (labels, ...).
      edge_dense_degree: optional int K of the dense slot-major layout
        (``E = K * N``; row ``k*N+n`` belongs to receiver ``n``).
      sender_out_degree: optional int, the sender-dense budget the batch
        was checked against (no node sends more edges).
    """

    h: Array
    chi: Array
    e: Array
    xi: Array
    x: Array
    senders: Array
    receivers: Array
    graph_id: Array
    node_pad_mask: Array
    edge_pad_mask: Array
    graph_pad_mask: Array
    node_mask: Optional[Array] = None
    edge_row_splits: Optional[Array] = None
    sender_perm: Optional[Array] = None
    sender_inv_perm: Optional[Array] = None
    sender_splits: Optional[Array] = None
    graph_splits: Optional[Array] = None
    extras: Dict[str, Array] = dataclasses.field(default_factory=dict)
    edge_dense_degree: Optional[int] = None
    sender_out_degree: Optional[int] = None

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def num_graphs(self) -> int:
        return int(self.graph_pad_mask.shape[0])

    def valid_node_mask(self) -> Array:
        """Padding mask AND semantic mask."""
        if self.node_mask is None:
            return self.node_pad_mask
        return self.node_pad_mask & self.node_mask

    def valid_edge_mask(self) -> Array:
        """Edges whose both endpoints are semantically valid (and real)."""
        if self.node_mask is None:
            return self.edge_pad_mask
        nm = self.valid_node_mask()
        return self.edge_pad_mask & nm[self.senders] & nm[self.receivers]

    def receiver_index(self):
        """The receivers: a :class:`DenseIndex` in the dense layout, in
        their sorted form (the row splits of a receiver-sorted batch) where
        the batch has one, else the plain index."""
        if self.edge_dense_degree is not None:
            return DenseIndex(self.receivers, self.edge_dense_degree)
        if self.edge_row_splits is None:
            return self.receivers
        return SortedIndex(self.receivers, self.edge_row_splits)

    def sender_index(self):
        """The senders, in their sorted form where the batch has one."""
        if self.sender_splits is None:
            return self.senders
        return SortedIndex(self.senders, self.sender_splits, self.sender_perm, self.sender_inv_perm)

    def graph_index(self):
        """The nodes' graph ids, in their sorted form where the batch has
        one."""
        if self.graph_splits is None:
            return self.graph_id
        return SortedIndex(self.graph_id, self.graph_splits)

    def replace(self, **kwargs) -> "GraphBatch":
        return dataclasses.replace(self, **kwargs)

    def to(
        self, device: torch.device, dtype: torch.dtype = torch.float32, non_blocking: bool = False
    ) -> "GraphBatch":
        """Torch tensors on ``device``: float features in ``dtype``, index
        arrays as int64, the splits (every array named ``*_splits``, extras
        too) as int32 (the kernels' index type), masks as bool.  With ``non_blocking`` a copy to the card goes
        from pinned host memory and returns before it completes (it runs on
        the current stream, ahead of the work queued after it)."""
        if non_blocking and torch.device(device).type == "cuda":
            return self._map(lambda t: t.pin_memory().to(device, non_blocking=True), dtype)
        return self._map(lambda t: t.to(device), dtype)

    def pinned(self, dtype: torch.dtype = torch.float32) -> "GraphBatch":
        """Torch tensors in pinned host memory, converted as :meth:`to`
        converts them: the source of a copy to the card that does not
        block (``train.graphs.BatchSlots.fill``)."""
        return self._map(lambda t: t.pin_memory(), dtype)

    def _map(self, fn, dtype: torch.dtype) -> "GraphBatch":
        """``fn`` of every array as a torch tensor converted as :meth:`to`
        describes (``None`` stays ``None``)."""

        def conv(name, a):
            if a is None:
                return None
            t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
            if name.endswith("_splits"):
                t = t.to(torch.int32)
            elif t.is_floating_point():
                t = t.to(dtype)
            elif t.dtype != torch.bool:
                t = t.to(torch.int64)
            return fn(t)

        fields = {
            f.name: conv(f.name, getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name != "extras" and f.name not in STATIC_FIELDS
        }
        fields["extras"] = {k: conv(k, v) for k, v in self.extras.items()}
        return GraphBatch(**fields, **self.static())

    def static(self) -> Dict[str, Optional[int]]:
        """The layout's ints (``STATIC_FIELDS``) by name."""
        return {name: getattr(self, name) for name in STATIC_FIELDS}

    def tensors(self) -> Dict[str, Any]:
        """Every array by name, ``extras`` as ``extras.<key>`` in sorted
        order (``None`` for an absent optional array); not the layout's
        ints (:meth:`static`)."""
        out = {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
            if f.name != "extras" and f.name not in STATIC_FIELDS
        }
        out.update({f"extras.{k}": self.extras[k] for k in sorted(self.extras)})
        return out


@dataclasses.dataclass
class GraphData:
    """A single unpadded graph on the host (numpy), as featurizers make it."""

    h: np.ndarray
    chi: np.ndarray
    e: np.ndarray
    xi: np.ndarray
    x: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    node_mask: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


def _pad_axis0(arr: np.ndarray, target: int, fill=0) -> np.ndarray:
    pad = target - arr.shape[0]
    if pad < 0:
        raise ValueError(
            f"cannot pad array of leading dim {arr.shape[0]} to smaller {target}"
        )
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def batch_graphs(
    graphs: Sequence[GraphData],
    num_nodes: int,
    num_edges: int,
    num_graphs: Optional[int] = None,
    extra_graph_keys: Sequence[str] = (),
    like: Optional[GraphData] = None,
) -> GraphBatch:
    """Concatenate and pad a list of host graphs into one static batch.

    Padded edges point at node 0 but are masked out; padded nodes belong to
    graph 0 but are masked out.  Per-node/per-edge extras are concatenated
    and zero-padded along axis 0; extras named in ``extra_graph_keys`` are
    treated as per-graph and padded to ``num_graphs``.

    ``like`` supplies feature dims when ``graphs`` is empty (an all-padding
    batch).
    """
    if num_graphs is None:
        num_graphs = max(len(graphs), 1)
    if not graphs:
        if like is None:
            raise ValueError("empty graph list requires a `like` template")

        def z(arr, n):
            a = np.asarray(arr)
            return np.zeros((n,) + a.shape[1:], a.dtype)

        extras = {}
        for key, v in like.extras.items():
            if key in extra_graph_keys:
                extras[key] = np.zeros(
                    (num_graphs,) + np.asarray(v).shape, np.asarray(v).dtype
                )
            else:
                n_tgt = (
                    num_edges
                    if np.asarray(v).shape[0] == like.num_edges
                    and like.num_edges != like.num_nodes
                    else num_nodes
                )
                extras[key] = z(v, n_tgt)
        return GraphBatch(
            h=z(like.h, num_nodes),
            chi=z(like.chi, num_nodes),
            e=z(like.e, num_edges),
            xi=z(like.xi, num_edges),
            x=np.zeros((num_nodes, 3), np.float32),
            senders=np.zeros(num_edges, np.int32),
            receivers=np.zeros(num_edges, np.int32),
            graph_id=np.zeros(num_nodes, np.int32),
            node_pad_mask=np.zeros(num_nodes, bool),
            edge_pad_mask=np.zeros(num_edges, bool),
            graph_pad_mask=np.zeros(num_graphs, bool),
            node_mask=np.zeros(num_nodes, bool)
            if like.node_mask is not None
            else None,
            extras=extras,
        )
    if len(graphs) > num_graphs:
        raise ValueError(f"{len(graphs)} graphs exceed budget {num_graphs}")
    tot_n = sum(g.num_nodes for g in graphs)
    tot_e = sum(g.num_edges for g in graphs)
    if tot_n > num_nodes or tot_e > num_edges:
        raise ValueError(
            f"batch ({tot_n} nodes, {tot_e} edges) exceeds budget "
            f"({num_nodes}, {num_edges})"
        )

    h = np.concatenate([np.asarray(g.h) for g in graphs], axis=0)
    chi = np.concatenate([np.asarray(g.chi) for g in graphs], axis=0)
    e = np.concatenate([np.asarray(g.e) for g in graphs], axis=0)
    xi = np.concatenate([np.asarray(g.xi) for g in graphs], axis=0)
    x = np.concatenate([np.asarray(g.x) for g in graphs], axis=0)

    senders_l, receivers_l, graph_id_l = [], [], []
    offset = 0
    for gi, g in enumerate(graphs):
        senders_l.append(np.asarray(g.senders) + offset)
        receivers_l.append(np.asarray(g.receivers) + offset)
        graph_id_l.append(np.full(g.num_nodes, gi, dtype=np.int32))
        offset += g.num_nodes
    senders = np.concatenate(senders_l).astype(np.int32)
    receivers = np.concatenate(receivers_l).astype(np.int32)
    graph_id = np.concatenate(graph_id_l).astype(np.int32)

    node_pad_mask = np.zeros(num_nodes, dtype=bool)
    node_pad_mask[:tot_n] = True
    edge_pad_mask = np.zeros(num_edges, dtype=bool)
    edge_pad_mask[:tot_e] = True
    graph_pad_mask = np.zeros(num_graphs, dtype=bool)
    graph_pad_mask[: len(graphs)] = True

    node_mask = None
    if any(g.node_mask is not None for g in graphs):
        node_mask = np.concatenate(
            [
                np.asarray(g.node_mask)
                if g.node_mask is not None
                else np.ones(g.num_nodes, dtype=bool)
                for g in graphs
            ]
        )
        node_mask = _pad_axis0(node_mask.astype(bool), num_nodes, fill=False)

    extras: Dict[str, np.ndarray] = {}
    keys = set()
    for g in graphs:
        keys.update(g.extras.keys())
    for key in sorted(keys):
        arrs = [np.asarray(g.extras[key]) for g in graphs if key in g.extras]
        if len(arrs) != len(graphs):
            raise ValueError(f"extra '{key}' missing from some graphs in batch")
        if key in extra_graph_keys:
            stacked = np.stack([np.asarray(a) for a in arrs], axis=0)
            extras[key] = _pad_axis0(stacked, num_graphs)
        else:
            cat = np.concatenate(arrs, axis=0)
            target = num_edges if cat.shape[0] == tot_e and tot_e != tot_n else num_nodes
            extras[key] = _pad_axis0(cat, target)

    return GraphBatch(
        h=_pad_axis0(h, num_nodes),
        chi=_pad_axis0(chi, num_nodes),
        e=_pad_axis0(e, num_edges),
        xi=_pad_axis0(xi, num_edges),
        x=_pad_axis0(x, num_nodes),
        senders=_pad_axis0(senders, num_edges),
        receivers=_pad_axis0(receivers, num_edges),
        graph_id=_pad_axis0(graph_id, num_nodes),
        node_pad_mask=node_pad_mask,
        edge_pad_mask=edge_pad_mask,
        graph_pad_mask=graph_pad_mask,
        node_mask=node_mask,
        extras=extras,
    )
