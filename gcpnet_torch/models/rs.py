"""RS task model: binary R/S enantiomer chirality classification.

Port of ``gcpnet_tpu/models/rs.py``: LBA's trunk (centre + frames, the
encoder over float node scalars, ``num_atom_types=0``) and pooled head with
a leaky-relu dense layer, one logit a graph; the loss is the masked
binary cross-entropy with logits.  With the RS configuration the message
stacks apply leaky relu to their scalars, so on the card K2 and K3 run
their leaky-relu layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.models.common import (
    GCPNetEncoder,
    InvariantPooledHead,
    batch_masks,
    centralize_and_frames,
)
from gcpnet_torch.ops.segment import masked_mean


class GCPNetRS(nn.Module):
    """``device=None`` builds the model on the card (and raises without
    one); weights are drawn from ``generator`` on the CPU and moved.
    ``layer_class`` names the trunk's interaction layer."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        layer_class: str = "GCPInteractions",
        *,
        generator: torch.Generator,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        mc = model_cfg
        self.norm_x_diff = module_cfg.norm_x_diff
        self.encoder = GCPNetEncoder(
            mc, module_cfg, layer_cfg, num_atom_types=0,
            node_input_dims=(mc.h_input_dim, mc.chi_input_dim), layer_class=layer_class, **kw,
        )
        self.head = InvariantPooledHead(
            (mc.h_hidden_dim, mc.chi_hidden_dim), module_cfg,
            output_dim=mc.output_dim, output_scale_factor=mc.output_scale_factor,
            dense_dropout=mc.dense_dropout, dense_activation="leakyrelu", **kw,
        )

    def forward(
        self,
        batch: GraphBatch,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """One logit a graph ``[G]``.  ``deterministic=False`` applies
        dropout, with masks drawn from ``generator``."""
        _, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        batch = batch.replace(x=centered)
        node_rep, _ = self.encoder(batch, frames, deterministic=deterministic, generator=generator)
        edge_mask, count_mask = batch_masks(batch)
        return self.head(
            node_rep, batch, frames, edge_mask, count_mask,
            deterministic=deterministic, generator=generator,
        )


def rs_loss(logits: Tensor, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """Masked binary cross-entropy with logits over the real graphs (JAX
    ``models/rs.py:72-79``): ``(loss, labels)``, labels in float32."""
    labels = batch.extras["label"].float()
    per_graph = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return masked_mean(per_graph, batch.graph_pad_mask), labels
