"""Local-frame geometry: centring, edge frames, and the scalarize/vectorize
projections between equivariant vectors and frame-invariant scalars.

Port of ``gcpnet_tpu/nn/frames.py``.  Frames are PACKED ``[E, 9]``
(row-major ``[f0x f0y f0z f1x ...]``); vectors are packed ``[*, 3c]``
(see ``nn.primitives``).  Masked entries are zeros plus explicit masks.

For edge inputs the projections are row-wise over the edge frames.  A
node input projects onto each of its outgoing edges' frames and takes the
mean over them (:class:`NodeFrames`).  Scalarize and vectorize are linear
in the frame for a fixed node feature, so that gather + mean equals the
row-wise product with the node's mean frame (the JAX package's
``node_frames`` fast path), which every projection takes but E(3) mode's
scalarize: its ``abs`` of the cross-product column is not linear, so it
gathers the node rows by sender, projects them on the edge frames and
takes the mean over senders (K1 over the sender-sorted rows where the
senders come in their sorted form).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from gcpnet_torch.nn.primitives import vec_components
from gcpnet_torch.ops.segment import Index, gather_rows, index_of, segment_mean, sender_mean


def centralize(
    x: Tensor, graph_id: Index, num_graphs: int, node_mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Subtract each graph's masked centroid.  Returns ``(centroid [G, 3],
    centered [N, 3])``; masked rows are zero.  ``graph_id`` may be in its
    sorted form (``GraphBatch.graph_index``)."""
    centroid = segment_mean(x, graph_id, num_graphs, mask=node_mask)
    centered = x - centroid[index_of(graph_id)]
    if node_mask is not None:
        centered = centered * node_mask[:, None].to(x.dtype)
    return centroid, centered


def decentralize(
    x: Tensor, graph_id: Tensor, centroid: Tensor, node_mask: Optional[Tensor] = None
) -> Tensor:
    """Add each graph's centroid back (the inverse of :func:`centralize`);
    masked rows are zero."""
    out = x + centroid[graph_id]
    if node_mask is not None:
        out = out * node_mask[:, None].to(x.dtype)
    return out


def frame_rows(frames: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The three frame vectors of PACKED frames, each ``[E, 3]``."""
    return frames[:, 0:3], frames[:, 3:6], frames[:, 6:9]


def localize(
    x: Tensor,
    senders: Tensor,
    receivers: Tensor,
    norm_x_diff: bool = True,
    edge_mask: Optional[Tensor] = None,
) -> Tensor:
    """Edge-wise local frames, PACKED ``[E, 9]``: rows ``x_i - x_j``,
    ``x_i × x_j`` and their cross product, the first two optionally divided
    by ``(‖·‖ + 1)``.  Masked edges give zero frames."""
    xi, xj = x[senders], x[receivers]
    x_diff = xi - xj
    x_cross = torch.linalg.cross(xi, xj, dim=-1)
    if norm_x_diff:
        x_diff = x_diff / (torch.linalg.vector_norm(x_diff, dim=-1, keepdim=True) + 1.0)
        x_cross = x_cross / (torch.linalg.vector_norm(x_cross, dim=-1, keepdim=True) + 1.0)
    x_vertical = torch.linalg.cross(x_diff, x_cross, dim=-1)
    f_ij = torch.cat([x_diff, x_cross, x_vertical], dim=-1)
    if edge_mask is not None:
        f_ij = f_ij * edge_mask[:, None].to(f_ij.dtype)
    return f_ij


def node_mean_frames(
    frames: Tensor,
    senders: Index,
    num_nodes: int,
    edge_mask: Optional[Tensor] = None,
    count_mask: Optional[Tensor] = None,
) -> Tensor:
    """Per-node mean of outgoing-edge frames, ``[N, 9]``: ``edge_mask``
    gates the numerator, ``count_mask`` (default ``edge_mask``) the
    denominator; K1 over the frames sorted by sender where ``senders`` is
    in its sorted form (``GraphBatch.sender_index``)."""
    return sender_mean(
        frames,
        senders,
        num_nodes,
        mask=edge_mask,
        count_mask=count_mask if count_mask is not None else edge_mask,
    )


class NodeFrames:
    """The frames a node-input GCP projects onto: every node's outgoing
    edges' ``frames [E, 9]`` (``senders`` in their sorted form where the
    batch has one), ``edge_mask`` gating the mean's numerator and
    ``count_mask`` (default ``edge_mask``) its denominator.  :attr:`mean`,
    the per-node mean frame, is computed at its first use (a stack whose
    GCPs read no frames computes none)."""

    def __init__(
        self,
        frames: Tensor,
        senders: Index,
        num_nodes: int,
        edge_mask: Optional[Tensor] = None,
        count_mask: Optional[Tensor] = None,
    ):
        self.frames, self.senders, self.num_nodes = frames, senders, num_nodes
        self.edge_mask = edge_mask
        self.count_mask = count_mask if count_mask is not None else edge_mask
        self._mean: Optional[Tensor] = None

    @property
    def mean(self) -> Tensor:
        """``[N, 9]``: :func:`node_mean_frames` of the edge frames."""
        if self._mean is None:
            self._mean = node_mean_frames(self.frames, self.senders, self.num_nodes, self.edge_mask, self.count_mask)
        return self._mean


Frames = Union[Tensor, NodeFrames]


def _project(vector_rep: Tensor, frames: Tensor, e3: bool) -> Tensor:
    """Row-wise projection of 3 packed channels on the row's frame,
    channel-major; with ``e3`` the cross-product column's ``abs``."""
    vx, vy, vz = vec_components(vector_rep)
    cols = []
    for c in range(3):
        for f in range(3):
            col = vx[:, c] * frames[:, 3 * f] + vy[:, c] * frames[:, 3 * f + 1] + vz[:, c] * frames[:, 3 * f + 2]
            # x_cross flips its sign under a reflection: abs restores the invariance
            cols.append(col.abs() if e3 and f == 1 else col)
    return torch.stack(cols, dim=-1)


def scalarize(
    vector_rep: Tensor, frames: Frames, edge_mask: Optional[Tensor] = None, e3: bool = False
) -> Tensor:
    """Project 3 packed vector channels ``[R, 9]`` onto frames: ``[R, 9]``
    invariant scalars, channel-major ``(c0·f0, c0·f1, c0·f2, c1·f0, ...)``.
    ``frames`` are the rows' own (edge rows, or node rows' mean frames;
    ``edge_mask`` zeroes masked rows) or a :class:`NodeFrames`.  ``e3``
    (``enable_e3_equivariance``) takes the ``abs`` of the cross-product
    column; for node rows that is a mean over the outgoing edges of each
    edge's projection, not the projection on the mean frame."""
    if isinstance(frames, NodeFrames):
        if not e3:
            return _project(vector_rep, frames.mean, False)
        local = _project(gather_rows(vector_rep, frames.senders), frames.frames, True)
        return sender_mean(local, frames.senders, frames.num_nodes, mask=frames.edge_mask,
                           count_mask=frames.count_mask)
    out = _project(vector_rep, frames, e3)
    if edge_mask is not None:
        out = out * edge_mask[:, None].to(out.dtype)
    return out


def vectorize(gate: Tensor, frames: Frames, edge_mask: Optional[Tensor] = None) -> Tensor:
    """Inverse of :func:`scalarize`: 9 channel-major gates combine the
    frame vectors into 3 packed vector channels ``[R, 9]`` (linear in the
    frame: a :class:`NodeFrames` gives its mean frame)."""
    if isinstance(frames, NodeFrames):
        frames, edge_mask = frames.mean, None
    comps = []
    for x in range(3):
        comps.append(
            torch.stack(
                [
                    gate[:, 3 * c] * frames[:, x]
                    + gate[:, 3 * c + 1] * frames[:, 3 + x]
                    + gate[:, 3 * c + 2] * frames[:, 6 + x]
                    for c in range(3)
                ],
                dim=-1,
            )
        )
    out = torch.cat(comps, dim=-1)
    if edge_mask is not None:
        out = out * edge_mask[:, None].to(out.dtype)
    return out
