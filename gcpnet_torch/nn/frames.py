"""Local-frame geometry: centring, edge frames, and the scalarize/vectorize
projections between equivariant vectors and frame-invariant scalars.

Port of ``gcpnet_tpu/nn/frames.py``.  Frames are PACKED ``[E, 9]``
(row-major ``[f0x f0y f0z f1x ...]``); vectors are packed ``[*, 3c]``
(see ``nn.primitives``).  Masked entries are zeros plus explicit masks.

The projections here are row-wise: for edge inputs ``frames`` are the edge
frames, and for node inputs they are the per-node mean frames from
:func:`node_mean_frames`.  Scalarize and vectorize are linear in the frame
for a fixed node feature, so a node input's gather + scatter-mean over its
outgoing edges equals the row-wise product with its mean frame (the JAX
package's ``node_frames`` fast path, which its GCPs always take).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from gcpnet_torch.nn.primitives import vec_components
from gcpnet_torch.ops.segment import Index, index_of, segment_mean, sender_mean


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


def scalarize(vector_rep: Tensor, frames: Tensor, edge_mask: Optional[Tensor] = None) -> Tensor:
    """Project 3 packed vector channels ``[R, 9]`` onto the row's frame:
    ``[R, 9]`` invariant scalars, channel-major ``(c0·f0, c0·f1, c0·f2,
    c1·f0, ...)``.  ``edge_mask`` zeroes masked edge rows."""
    vx, vy, vz = vec_components(vector_rep)
    cols = [
        vx[:, c] * frames[:, 3 * f] + vy[:, c] * frames[:, 3 * f + 1] + vz[:, c] * frames[:, 3 * f + 2]
        for c in range(3)
        for f in range(3)
    ]
    out = torch.stack(cols, dim=-1)
    if edge_mask is not None:
        out = out * edge_mask[:, None].to(out.dtype)
    return out


def vectorize(gate: Tensor, frames: Tensor, edge_mask: Optional[Tensor] = None) -> Tensor:
    """Inverse of :func:`scalarize`: 9 channel-major gates combine the
    row's 3 frame vectors into 3 packed vector channels ``[R, 9]``."""
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
