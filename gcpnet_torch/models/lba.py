"""LBA task model: ligand binding affinity graph regression; PSR.

Port of ``gcpnet_tpu/models/lba.py``: centre + frames -> encoder ->
invariant projection -> graph mean-pool -> 2-layer dense head; the masked
per-graph MSE loss.  PSR (structure ranking: one GDT-TS a decoy) is the same
model and loss (``GCPNetPSR``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

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


class GCPNetLBA(nn.Module):
    """``device=None`` builds the model on the card (and raises without
    one); weights are drawn from ``generator`` on the CPU and moved.
    ``layer_class`` names the trunk's interaction layer; ``remat``
    rematerializes each of its layers (``models.common.remat_call``)."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        num_atom_types: int = 9,
        layer_class: str = "GCPInteractions",
        remat: Union[bool, str] = False,
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
            mc, module_cfg, layer_cfg,
            num_atom_types=num_atom_types,
            node_input_dims=(num_atom_types, mc.chi_input_dim),
            layer_class=layer_class,
            **kw,
            remat=remat,
        )
        self.head = InvariantPooledHead(
            (mc.h_hidden_dim, mc.chi_hidden_dim), module_cfg,
            output_dim=mc.output_dim, output_scale_factor=mc.output_scale_factor,
            dense_dropout=mc.dense_dropout, **kw,
        )

    def forward(
        self,
        batch: GraphBatch,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """``deterministic=False`` applies dropout, with masks drawn from
        ``generator`` (on the batch's device)."""
        _, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        batch = batch.replace(x=centered)
        node_rep, _ = self.encoder(batch, frames, deterministic=deterministic, generator=generator)
        edge_mask, count_mask = batch_masks(batch)
        return self.head(
            node_rep, batch, frames, edge_mask, count_mask,
            deterministic=deterministic, generator=generator,
        )


def graph_regression_loss(preds: Tensor, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """Masked per-graph MSE of LBA and PSR (JAX ``models/lba.py:72-77``):
    ``(loss, labels)``, in the dtype of ``preds`` and the labels."""
    labels = batch.extras["label"]
    loss = masked_mean((preds - labels) ** 2, batch.graph_pad_mask)
    return loss, labels


GCPNetPSR = GCPNetLBA  # PSR runs the LBA architecture with 9 atom types (JAX models/lba.py:80)
