"""Shared model-building blocks: masks, centring + frames, the pooled
invariant head and the encoder trunk.

Port of ``gcpnet_tpu/models/common.py``.  The encoder is a plain loop over
its interaction layers (the JAX package may scan them; the math is the
same), each optionally rematerialized in the backward pass (``remat``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
from torch import Tensor, nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.nn.embedding import GCPEmbedding
from gcpnet_torch.nn.frames import NodeFrames, centralize, localize
from gcpnet_torch.nn.gcp import Dense, make_gcp
from gcpnet_torch.nn.interactions import LAYER_CLASSES
from gcpnet_torch.nn.primitives import GCPDropout, GCPLayerNorm, MaskTape, ScalarVector, get_nonlinearity
from gcpnet_torch.ops.segment import segment_mean


def batch_masks(batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """(edge_mask numerator, count_mask denominator): the denominator of the
    masked frame means counts every real edge."""
    return batch.valid_edge_mask(), batch.edge_pad_mask


def centralize_and_frames(batch: GraphBatch, norm_x_diff: bool = True):
    """Returns (centroid [G, 3], centred x [N, 3], frames [E, 9])."""
    centroid, centered = centralize(
        batch.x, batch.graph_index(), batch.num_graphs, node_mask=batch.valid_node_mask()
    )
    edge_mask, _ = batch_masks(batch)
    frames = localize(
        centered, batch.senders, batch.receivers, norm_x_diff=norm_x_diff, edge_mask=edge_mask
    )
    return centroid, centered, frames


class InvariantPooledHead(nn.Module):
    """GCPLayerNorm -> invariant-projection GCP -> graph mean-pool -> dense
    MLP head."""

    def __init__(
        self,
        node_dims: Tuple[int, int],
        cfg: ModuleCfg,
        output_dim: int = 1,
        output_scale_factor: int = 2,
        dense_dropout: float = 0.1,
        dense_activation: str = "relu",
        *,
        generator: torch.Generator,
        device,
    ):
        """``dense_activation`` between the two dense layers: relu (LBA),
        leaky relu at slope 0.01 (RS)."""
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.output_dim = output_dim
        self.dense_activation = get_nonlinearity(dense_activation)
        self.dense_dropout = GCPDropout(dense_dropout)
        self.projection_norm = GCPLayerNorm(node_dims[0], device=device)
        self.invariant_node_projection = make_gcp(
            node_dims, (node_dims[0], 0), cfg,
            nonlinearities=cfg.nonlinearities, bottleneck=1, vector_residual=False, **kw,
        )
        hidden = node_dims[0] * output_scale_factor
        self.dense_0 = Dense(node_dims[0], hidden, **kw)
        self.dense_1 = Dense(hidden, output_dim, **kw)

    def forward(
        self,
        node_rep: ScalarVector,
        batch: GraphBatch,
        frames: Tensor,
        edge_mask: Optional[Tensor],
        count_mask: Optional[Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        out = self.projection_norm(node_rep)
        nf = NodeFrames(frames, batch.sender_index(), node_rep.scalar.shape[0], edge_mask, count_mask)
        out = self.invariant_node_projection(out, nf)
        pooled = segment_mean(out, batch.graph_index(), batch.num_graphs, mask=batch.valid_node_mask())
        y = self.dense_activation(self.dense_0(pooled))
        y = self.dense_dropout(y, deterministic, generator)
        y = self.dense_1(y)
        return y[..., 0] if self.output_dim == 1 else y


# the matrix products whose outputs the "dots" policy saves: the aten ops
# that ``jax.checkpoint_policies.dots_saveable``'s dot_general becomes
DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "baddbmm", "dot", "vdot", "mv", "addmv")
)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(remat: Union[bool, str]) -> Union[bool, str]:
    """``remat`` if it is ``False``, ``True`` or ``"dots"`` (the JAX
    ``_remat_policy``'s values); any other string raises."""
    if isinstance(remat, str) and remat != "dots":
        raise ValueError(f"unknown remat policy {remat!r}; use False, True, or 'dots'")
    return remat if isinstance(remat, str) else bool(remat)


def remat_call(layer: nn.Module, remat: Union[bool, str], *args, **kwargs):
    """``layer(*args, **kwargs)`` rematerialized in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): ``True`` keeps only the
    layer's inputs and recomputes the rest, ``"dots"`` also keeps the
    outputs of its matrix products (``DOT_OPS``, a selective-checkpoint
    policy: the counterpart of ``dots_saveable``) and recomputes the
    elementwise chains.  Dropout masks are recorded in the first run and
    replayed in the recompute (``nn.primitives.MaskTape``, handed to the
    layer as its ``generator``), so the gradients equal those without
    remat; the generator's state is not touched
    (``preserve_rng_state=False``), which keeps the call inside a captured
    CUDA graph.  The recompute runs on the tensors the layer held
    in the first run (under ``torch.func.functional_call``, as a bf16 step
    calls the model, its parameters' bf16 copies, which are gone from the
    module by the time the backward runs).  The recompute launches the
    layer's kernels again (K1's sums, K2's stack)."""
    if kwargs.get("generator") is not None:
        kwargs["generator"] = tape = MaskTape(kwargs["generator"])
    else:
        tape = None
    held = {}

    def run(*a, **kw):
        if held:
            if tape is not None:
                tape.replay = 0
            return torch.func.functional_call(layer, held, a, kw)
        held.update(layer.named_parameters())
        held.update(layer.named_buffers())
        return layer(*a, **kw)

    context = (functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
               if remat == "dots" else None)
    extra = {} if context is None else {"context_fn": context}
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **extra, **kwargs)


class GCPNetEncoder(nn.Module):
    """Embedding + a stack of interaction layers (the shared trunk):
    ``layer_class`` ``"GCPInteractions"`` or ``"GCPInteractions2"`` (EQ),
    ``embedding_nonlinearities`` the embedding's edge GCP's.  With
    ``updating_node_positions`` every layer also moves the node positions
    it is given, and the encoder returns them.  ``remat`` (``False``,
    ``True`` or ``"dots"``) rematerializes each interaction layer in the
    backward pass (:func:`remat_call`), where gradients are taken."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        num_atom_types: int,
        node_input_dims: Tuple[int, int],
        updating_node_positions: bool = False,
        layer_class: str = "GCPInteractions",
        embedding_nonlinearities: Optional[Tuple[Optional[str], Optional[str]]] = None,
        remat: Union[bool, str] = False,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.remat = check_remat(remat)
        mc = model_cfg
        node_dims = (mc.h_hidden_dim, mc.chi_hidden_dim)
        edge_dims = (mc.e_hidden_dim, mc.xi_hidden_dim)
        self.gcp_embedding = GCPEmbedding(
            edge_input_dims=(mc.e_input_dim, mc.xi_input_dim),
            node_input_dims=node_input_dims,
            edge_hidden_dims=edge_dims,
            node_hidden_dims=node_dims,
            cfg=module_cfg,
            num_atom_types=num_atom_types,
            nonlinearities=embedding_nonlinearities,
            **kw,
        )
        self.num_layers = mc.num_encoder_layers
        self.updating_node_positions = updating_node_positions
        for i in range(self.num_layers):
            self.add_module(
                f"interaction_{i}",
                LAYER_CLASSES[layer_class](
                    node_dims, edge_dims, module_cfg, layer_cfg, dropout=mc.dropout,
                    updating_node_positions=updating_node_positions, **kw,
                ),
            )

    def forward(
        self,
        batch: GraphBatch,
        frames: Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        node_pos: Optional[Tensor] = None,
    ):
        """``(node_rep, edge_rep)``; with ``updating_node_positions``,
        ``(node_rep, edge_rep, node_pos)`` after every layer's update."""
        edge_mask, count_mask = batch_masks(batch)
        node_rep, edge_rep = self.gcp_embedding(batch, frames, edge_mask, count_mask)
        remat = self.remat if torch.is_grad_enabled() else False
        for i in range(self.num_layers):
            layer = getattr(self, f"interaction_{i}")
            args = (node_rep, edge_rep, batch.sender_index(), batch.receiver_index(), frames)
            kwargs = dict(node_mask=batch.node_mask, edge_mask=edge_mask, count_mask=count_mask,
                          deterministic=deterministic, generator=generator, node_pos=node_pos)
            out = remat_call(layer, remat, *args, **kwargs) if remat else layer(*args, **kwargs)
            if self.updating_node_positions:
                node_rep, node_pos = out
            else:
                node_rep = out
        if self.updating_node_positions:
            return node_rep, edge_rep, node_pos
        return node_rep, edge_rep
