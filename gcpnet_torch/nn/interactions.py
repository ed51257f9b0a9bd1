"""The GCP interaction layer of LBA/PSR/CPD/NMS/RS.

Port of ``gcpnet_tpu/nn/interactions.py:GCPInteractions`` without the
autoregressive branch and without the position update: message passing,
dropout + residual + norm, a feed-forward GCP stack, dropout + residual +
norm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModuleCfg
from gcpnet_torch.nn.frames import node_mean_frames
from gcpnet_torch.nn.gcp import make_gcp
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import GCPDropout, GCPLayerNorm, ScalarVector


def _ff_hidden_dims(node_dims: Tuple[int, int], num_ff: int) -> Tuple[int, int]:
    if num_ff == 1:
        return tuple(node_dims)
    return (4 * node_dims[0], 2 * node_dims[1])


class GCPInteractions(nn.Module):
    def __init__(
        self,
        node_dims: Tuple[int, int],
        edge_dims: Tuple[int, int],
        cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        dropout: float = 0.1,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.pre_norm = layer_cfg.pre_norm
        self.interaction = GCPMessagePassing(node_dims, node_dims, edge_dims, cfg, layer_cfg, **kw)
        self.gcp_norm_0 = GCPLayerNorm(node_dims[0], device=device)
        self.gcp_norm_1 = GCPLayerNorm(node_dims[0], device=device)
        self.gcp_dropout_0 = GCPDropout(dropout)
        self.gcp_dropout_1 = GCPDropout(dropout)

        num_ff = layer_cfg.num_feedforward_layers
        hidden = _ff_hidden_dims(node_dims, num_ff)
        ff = [
            make_gcp(
                node_dims, hidden, cfg,
                nonlinearities=None if num_ff == 1 else cfg.nonlinearities,
                vector_residual=False, **kw,
            )
        ]
        ff += [
            make_gcp(hidden, hidden, cfg, nonlinearities=cfg.nonlinearities, **kw)
            for _ in range(max(0, num_ff - 2))
        ]
        if num_ff > 1:
            ff.append(
                make_gcp(hidden, node_dims, cfg, nonlinearities=(None, None), vector_residual=False, **kw)
            )
        for i, module in enumerate(ff):
            self.add_module(f"feedforward_{i}", module)
        self.num_ff = num_ff

    def forward(
        self,
        node_rep: ScalarVector,
        edge_rep: ScalarVector,
        senders: Tensor,
        receivers: Tensor,
        frames: Tensor,
        node_mask: Optional[Tensor] = None,
        edge_mask: Optional[Tensor] = None,
        count_mask: Optional[Tensor] = None,
        row_splits: Optional[Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> ScalarVector:
        num_nodes = node_rep.scalar.shape[0]
        # node validity gates the scalarize numerators inside the message
        # GCPs, but the aggregation runs over every real edge: only the
        # padding mask may gate it
        frame_mask = edge_mask
        if node_mask is not None:
            nm_e = node_mask[senders] & node_mask[receivers]
            frame_mask = nm_e if frame_mask is None else (frame_mask & nm_e)
        agg_mask = count_mask if count_mask is not None else edge_mask

        node_rep_in = node_rep
        if self.pre_norm:
            node_rep = self.gcp_norm_0(node_rep)
        hidden = self.interaction(
            node_rep, edge_rep, senders, receivers, frames,
            edge_mask=agg_mask, count_mask=count_mask,
            row_splits=row_splits, frame_mask=frame_mask,
        )
        node_rep = node_rep + self.gcp_dropout_0(hidden, deterministic, generator)
        node_rep = self.gcp_norm_1(node_rep) if self.pre_norm else self.gcp_norm_0(node_rep)

        # with a node mask the feed-forward sees only the unmasked subgraph
        if node_mask is not None:
            ff_edge_mask = ff_count_mask = frame_mask
        else:
            ff_edge_mask, ff_count_mask = edge_mask, count_mask
        nf = node_mean_frames(frames, senders, num_nodes, ff_edge_mask, ff_count_mask)
        hidden = node_rep
        for i in range(self.num_ff):
            hidden = getattr(self, f"feedforward_{i}")(hidden, nf)
        node_rep = node_rep + self.gcp_dropout_1(hidden, deterministic, generator)

        if not self.pre_norm:
            node_rep = self.gcp_norm_1(node_rep)
        if node_mask is not None:
            m = node_mask[:, None]
            node_rep = ScalarVector(
                torch.where(m, node_rep.scalar, node_rep_in.scalar),
                torch.where(m, node_rep.vector, node_rep_in.vector),
            )
        return node_rep
