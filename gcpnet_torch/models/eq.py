"""EQ task model: per-residue lDDT regression over all-atom protein graphs.

Port of ``gcpnet_tpu/models/eq.py``: the atom-type embedding concatenated
onto the node scalars (ESM-2 residue embeddings and plDDT, from
``data.eq``), the ``GCPInteractions2`` trunk, ``projection_norm`` and the
invariant projection, a masked mean of the atoms' scalars into their
residues (``atom_residue_idx``, made batch-global on the host), and the
dense head; the masked SmoothL1 loss.  On the card the residue mean runs
through K1 over the residue index's sorted form (``residue_splits``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.data.eq import NUM_EQ_ATOM_TYPES
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.models.common import GCPNetEncoder, batch_masks, centralize_and_frames
from gcpnet_torch.nn.embedding import Embed
from gcpnet_torch.nn.frames import NodeFrames
from gcpnet_torch.nn.gcp import Dense, make_gcp
from gcpnet_torch.nn.primitives import GCPDropout, GCPLayerNorm
from gcpnet_torch.ops.segment import SortedIndex, masked_mean, segment_mean


def residue_index(batch: GraphBatch):
    """The atoms' batch-global residue index, in its sorted form where the
    batch has one (``data.eq.globalize_residues``)."""
    ex = batch.extras
    if "residue_splits" not in ex:
        return ex["atom_residue_idx"].long()
    return SortedIndex(ex["atom_residue_idx"].long(), ex["residue_splits"], ex["residue_perm"],
                       ex["residue_inv_perm"])


class GCPNetEQ(nn.Module):
    """``device=None`` builds the model on the card (and raises without
    one); weights are drawn from ``generator`` on the CPU and moved.  The
    parameters keep the flax module's names.  ``layer_class`` names the
    trunk's interaction layer; ``remat`` rematerializes each of its layers
    (``models.common.remat_call``)."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        layer_class: str = "GCPInteractions2",
        remat: Union[bool, str] = False,
        *,
        generator: torch.Generator,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        mc = model_cfg
        node_dims = (mc.h_hidden_dim, mc.chi_hidden_dim)
        self.norm_x_diff = module_cfg.norm_x_diff
        self.atom_embedding = Embed(NUM_EQ_ATOM_TYPES, NUM_EQ_ATOM_TYPES, **kw)
        self.encoder = GCPNetEncoder(
            mc, module_cfg, layer_cfg, num_atom_types=0,
            node_input_dims=(mc.h_input_dim + NUM_EQ_ATOM_TYPES, mc.chi_input_dim),
            layer_class=layer_class, embedding_nonlinearities=module_cfg.nonlinearities, **kw,
            remat=remat,
        )
        self.projection_norm = GCPLayerNorm(node_dims[0], device=device)
        self.invariant_node_projection = make_gcp(
            node_dims, (node_dims[0], 0), module_cfg, nonlinearities=module_cfg.nonlinearities, bottleneck=1,
            vector_residual=False, **kw,
        )
        hidden = mc.h_hidden_dim * mc.output_scale_factor
        self.dense_0 = Dense(mc.h_hidden_dim, hidden, **kw)
        self.dense_dropout = GCPDropout(mc.dense_dropout)
        self.dense_1 = Dense(hidden, mc.output_dim, **kw)

    def forward(
        self,
        batch: GraphBatch,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """One lDDT a residue slot ``[R]``.  ``deterministic=False`` applies
        dropout, with masks drawn from ``generator``."""
        _, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        atom_embed = self.atom_embedding(batch.extras["atom_types"]).to(batch.h.dtype)
        batch = batch.replace(x=centered, h=torch.cat([batch.h, atom_embed], dim=-1))
        node_rep, _ = self.encoder(batch, frames, deterministic=deterministic, generator=generator)
        edge_mask, count_mask = batch_masks(batch)
        out = self.projection_norm(node_rep)
        nf = NodeFrames(frames, batch.sender_index(), batch.num_nodes, edge_mask, count_mask)
        out = self.invariant_node_projection(out, nf)
        num_res = batch.extras["res_mask"].shape[0]
        res_out = segment_mean(out, residue_index(batch), num_res, mask=batch.valid_node_mask())
        y = torch.relu(self.dense_0(res_out))
        y = self.dense_dropout(y, deterministic, generator)
        return self.dense_1(y)[..., 0]


def eq_loss(preds: Tensor, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """Masked SmoothL1 (beta 1) over the real residues: ``(loss, labels)``."""
    labels = batch.extras["label"]
    diff = preds - labels
    absd = diff.abs()
    smooth = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5)
    return masked_mean(smooth, batch.extras["res_mask"].bool()), labels
