"""NMS task model: Newtonian many-body future-position regression.

Port of ``gcpnet_tpu/models/nms.py:26-62``: centre the positions, build the
edge frames, embed, run position-updating interaction layers, and add the
centroids back; the loss is the masked MSE of the coordinates.

The frames are built once from the input positions and every layer reuses
them, so they depend on no parameter: no gradient flows through them, and
the edge map's backward (K3) needs no frame cotangent.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.models.common import GCPNetEncoder, centralize_and_frames
from gcpnet_torch.nn.frames import decentralize
from gcpnet_torch.ops.segment import masked_mean


class GCPNetNMS(nn.Module):
    """``device=None`` builds the model on the card (and raises without
    one); weights are drawn from ``generator`` on the CPU and moved.
    ``layer_class`` names the trunk's interaction layer; ``remat``
    rematerializes each of its layers (``models.common.remat_call``)."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        layer_class: str = "GCPInteractions",
        remat: Union[bool, str] = False,
        *,
        generator: torch.Generator,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.norm_x_diff = module_cfg.norm_x_diff
        self.encoder = GCPNetEncoder(
            model_cfg, module_cfg, layer_cfg,
            num_atom_types=0,
            node_input_dims=(model_cfg.h_input_dim, model_cfg.chi_input_dim),
            updating_node_positions=True,
            layer_class=layer_class,
            generator=generator,
            device=device,
            remat=remat,
        )

    def forward(
        self,
        batch: GraphBatch,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """Predicted positions ``[N, 3]``.  ``deterministic=False`` applies
        dropout, with masks drawn from ``generator``."""
        centroid, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        batch = batch.replace(x=centered)
        _, _, x = self.encoder(
            batch, frames, deterministic=deterministic, generator=generator, node_pos=centered
        )
        return decentralize(x, batch.graph_id, centroid, node_mask=batch.node_mask)


def nms_loss(preds: Tensor, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """Masked MSE over the real nodes' coordinates: ``(loss, labels)``."""
    labels = batch.extras["label"]
    sq = (preds - labels) ** 2
    return masked_mean(sq.reshape(sq.shape[0], -1), batch.node_pad_mask), labels
