"""AR task model: all-atom protein structure refinement.

Port of ``gcpnet_tpu/models/ar.py``: the atoms are centred and the edge
frames built once, a ``GCPInteractions2`` trunk with the position update
moves the centred positions layer by layer, and each atom's prediction is
its residue's Ca position plus the atom's move, ``ca_x[res(a)] + (x_out -
x_in)`` (``ca_x`` the batch-global residue table of
``data.ar.globalize_ar_residues``).  The loss is ``sqrt(sum((p - l)^2) /
number of real atoms)``.

The Ca gather and the centroid gather read data, which carry no gradient,
so they need no sorted index; every gather that carries one (the message
stacks' node rows) goes through ``ops.segment.SortedIndex``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.models.common import GCPNetEncoder, centralize_and_frames
from gcpnet_torch.nn.frames import decentralize
from gcpnet_torch.ops.segment import index_of


class GCPNetAR(nn.Module):
    """``device=None`` builds the model on the card (and raises without
    one); weights are drawn from ``generator`` on the CPU and moved.  The
    parameters keep the flax module's names.  ``layer_class`` names the
    trunk's interaction layer."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        layer_class: str = "GCPInteractions2",
        *,
        generator: torch.Generator,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        mc = model_cfg
        self.norm_x_diff = module_cfg.norm_x_diff
        self.encoder = GCPNetEncoder(
            mc, module_cfg, layer_cfg, num_atom_types=0, node_input_dims=(mc.h_input_dim, mc.chi_input_dim),
            updating_node_positions=True, layer_class=layer_class,
            embedding_nonlinearities=module_cfg.nonlinearities, generator=generator, device=device,
        )

    def forward(
        self,
        batch: GraphBatch,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """The refined position of each atom slot ``[N, 3]``.
        ``deterministic=False`` applies dropout, with masks drawn from
        ``generator``."""
        x_input = batch.x
        centroid, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        batch = batch.replace(x=centered)
        _, _, x = self.encoder(batch, frames, deterministic=deterministic, generator=generator, node_pos=centered)
        x = decentralize(x, index_of(batch.graph_index()), centroid, node_mask=batch.node_mask)
        ca_x = batch.extras["ca_x"]
        return ca_x[batch.extras["atom_residue_idx"].long()] + (x - x_input)


def ar_loss(preds: Tensor, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """``sqrt(sum((p - l)^2 over the real atoms) / their number)``:
    ``(loss, labels)``."""
    labels = batch.extras["label"]
    valid = batch.valid_node_mask()
    sq = (preds - labels) ** 2 * valid[:, None].to(preds.dtype)
    n = torch.clamp(valid.sum(), min=1)
    return torch.sqrt(sq.sum() / n), labels
