"""The GCP interaction layers: ``GCPInteractions`` (LBA, PSR, CPD, NMS,
RS) and ``GCPInteractions2`` (EQ, and with its position update AR).

Port of ``gcpnet_tpu/nn/interactions.py:GCPInteractions``: message
passing, dropout + residual + norm, a feed-forward GCP stack, dropout +
residual + norm, and with ``updating_node_positions`` the equivariant
position update of NMS (``_derive_x_update``, ``interactions.py:260-365``).

The autoregressive branch (CPD's decoder, ``interactions.py:119-150``)
sums the messages: edges with sender < receiver read ``node_rep``, the
others ``node_rep_regressive``, and the sum is divided by each node's
whole in-degree.  The JAX layer runs the message stack twice, once on
each edge set with the other masked out.  The stack works row by row, so
an edge's message depends only on its own row: the rep it reads, its
edge features and its frame.  The port builds each edge's stack input
from the rep its direction selects and runs the stack once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModuleCfg
from gcpnet_torch.nn.frames import NodeFrames, frame_rows
from gcpnet_torch.nn.gcp import Dense, make_gcp, uniform_param
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import GCPDropout, GCPLayerNorm, ScalarVector, get_nonlinearity, vec_at
from gcpnet_torch.ops.segment import Index, gather_rows, index_of, segment_count, segment_mean


def _ff_hidden_dims(node_dims: Tuple[int, int], num_ff: int) -> Tuple[int, int]:
    if num_ff == 1:
        return tuple(node_dims)
    return (4 * node_dims[0], 2 * node_dims[1])


def _frame_mask(senders: Index, receivers: Index, node_mask: Optional[Tensor], edge_mask: Optional[Tensor]):
    """``edge_mask`` and, with a node mask, both ends valid: node validity
    gates the scalarize numerators inside the message GCPs."""
    if node_mask is None:
        return edge_mask
    nm_e = node_mask[index_of(senders)] & node_mask[index_of(receivers)]
    return nm_e if edge_mask is None else (edge_mask & nm_e)


class GCPInteractions(nn.Module):
    def __init__(
        self,
        node_dims: Tuple[int, int],
        edge_dims: Tuple[int, int],
        cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        dropout: float = 0.1,
        updating_node_positions: bool = False,
        autoregressive: bool = False,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.nonlinearity_slope = layer_cfg.nonlinearity_slope
        self.updating_node_positions = updating_node_positions
        self.pre_norm = layer_cfg.pre_norm
        self.interaction = GCPMessagePassing(
            node_dims, node_dims, edge_dims, cfg, layer_cfg, reduce_function="add" if autoregressive else "mean", **kw
        )
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

        if updating_node_positions:
            s_dim = node_dims[0]
            self.node_position_update_0 = make_gcp(
                node_dims, (s_dim, 1), cfg, nonlinearities=cfg.nonlinearities, vector_residual=False, **kw
            )
            if not cfg.ablate_x_force_update:
                self.phi_force_i = Dense(s_dim, s_dim, **kw)
                self.phi_force_j = Dense(s_dim, s_dim, **kw)
                # Xavier-uniform scaled by 1e-3: the force term starts near 0
                bound = 0.001 * math.sqrt(6.0 / (s_dim + 3))
                self.phi_force_ij_kernel = uniform_param((s_dim, 3), bound, generator, device)

    def forward(
        self,
        node_rep: ScalarVector,
        edge_rep: ScalarVector,
        senders: Index,
        receivers: Index,
        frames: Tensor,
        node_mask: Optional[Tensor] = None,
        edge_mask: Optional[Tensor] = None,
        count_mask: Optional[Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        node_pos: Optional[Tensor] = None,
        node_rep_regressive: Optional[ScalarVector] = None,
    ):
        """The new node representation; with ``updating_node_positions``,
        ``(node_rep, node_pos + x_update)`` for positions ``node_pos [N, 3]``.
        ``node_rep_regressive`` (with ``autoregressive``) is the rep the
        edges with sender >= receiver read.  ``senders`` and ``receivers``
        each in its sorted form where the batch has one."""
        num_nodes = node_rep.scalar.shape[0]
        frame_mask = _frame_mask(senders, receivers, node_mask, edge_mask)
        # the aggregation runs over every real edge: only the padding mask
        # may gate it
        agg_mask = count_mask if count_mask is not None else edge_mask

        node_rep_in = node_rep
        if self.pre_norm:
            node_rep = self.gcp_norm_0(node_rep)
        if node_rep_regressive is None:
            hidden = self.interaction(
                node_rep, edge_rep, senders, receivers, frames,
                edge_mask=agg_mask, count_mask=count_mask, frame_mask=frame_mask,
            )
        else:
            hidden = self._autoregressive_messages(
                node_rep, node_rep_regressive, edge_rep, senders, receivers, frames,
                agg_mask, count_mask, frame_mask,
            )
        node_rep = node_rep + self.gcp_dropout_0(hidden, deterministic, generator)
        node_rep = self.gcp_norm_1(node_rep) if self.pre_norm else self.gcp_norm_0(node_rep)

        # with a node mask the feed-forward sees only the unmasked subgraph
        if node_mask is not None:
            ff_edge_mask = ff_count_mask = frame_mask
        else:
            ff_edge_mask, ff_count_mask = edge_mask, count_mask
        nf = NodeFrames(frames, senders, num_nodes, ff_edge_mask, ff_count_mask)
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
        if not self.updating_node_positions:
            return node_rep

        if node_mask is None:
            nf_pos = nf  # the feed-forward's mask pair is the position head's
        else:
            # the position head keeps the all-real-edges denominator
            nf_pos = NodeFrames(frames, senders, num_nodes, frame_mask, count_mask)
        x_update = self._derive_x_update(node_rep, senders, receivers, frames, agg_mask, nf_pos)
        return node_rep, node_pos + x_update

    def _autoregressive_messages(
        self, node_rep, node_rep_regressive, edge_rep, senders, receivers, frames,
        agg_mask, count_mask, frame_mask,
    ) -> ScalarVector:
        """The summed messages of the forward (sender < receiver, reading
        ``node_rep``) and backward (the rest, reading ``node_rep_regressive``)
        edges over each node's in-degree (``count_mask``'s edges)."""
        mp = self.interaction
        fwd = mp.messages(node_rep, edge_rep, senders, receivers)
        bwd = mp.messages(node_rep_regressive, edge_rep, senders, receivers)
        fm = (index_of(senders) < index_of(receivers))[:, None]
        message = ScalarVector(torch.where(fm, fwd.scalar, bwd.scalar), torch.where(fm, fwd.vector, bwd.vector))
        hidden = mp(
            node_rep, edge_rep, senders, receivers, frames, edge_mask=agg_mask, count_mask=count_mask,
            frame_mask=frame_mask, message=message,
        )
        count = torch.clamp(segment_count(receivers, node_rep.scalar.shape[0], mask=count_mask), min=1.0)[:, None]
        return ScalarVector(
            (hidden.scalar.float() / count).to(hidden.scalar.dtype),
            (hidden.vector.float() / count).to(hidden.vector.dtype),
        )

    def _derive_x_update(
        self,
        node_rep: ScalarVector,
        senders: Index,
        receivers: Index,
        frames: Tensor,
        force_mask: Optional[Tensor],
        node_frames: NodeFrames,
    ) -> Tensor:
        """The equivariant position update ``[N, 3]``: the position GCP's one
        vector channel, plus (unless ``ablate_x_force_update``) a force term,
        a mean over each node's in-edges of the edge frames weighted by
        ``act(phi_i(h_sender) + phi_j(h_receiver)) @ kernel``, gated by the
        padding-level ``force_mask``; scaled by ``node_positions_weight`` and
        clipped to ±100."""
        h_v, chi_v = self.node_position_update_0(node_rep, node_frames)
        x_update = vec_at(chi_v, 0)
        if not self.cfg.ablate_x_force_update:
            act = get_nonlinearity(self.cfg.scalar_nonlinearity, self.nonlinearity_slope)
            h_i = self.phi_force_i(gather_rows(h_v, senders))
            h_j = self.phi_force_j(gather_rows(h_v, receivers))
            coef = act(h_i + h_j) @ self.phi_force_ij_kernel  # [E, 3]
            f0, f1, f2 = frame_rows(frames)
            force_e = coef[:, 0:1] * f0 + coef[:, 1:2] * f1 + coef[:, 2:3] * f2
            x_update = x_update + segment_mean(
                force_e, receivers, h_v.shape[0], mask=force_mask, count_mask=force_mask
            )
        return torch.clamp(x_update * self.cfg.node_positions_weight, -100.0, 100.0)


class GCPInteractions2(nn.Module):
    """The leaner interaction layer of EQ (``gcpnet_tpu/nn/interactions.py:
    368-534``): sum-reduced messages (with the layer config's scalar
    message attention and sender-keyed aggregation), ``concat(messages,
    node)`` into the feed-forward stack (GCP3 with ``feedforward_out`` on
    its last GCP), one dropout + residual + norm, and the multiplicative
    node mask.  The feed-forward runs on every real edge's frames, with
    node-masked numerators.  With ``updating_node_positions`` (AR) a GCP on
    the new node rep (``node_position_update_gcp``: one vector channel, the
    module config's nonlinearities, no vector residual, on the
    feed-forward's node frames) moves each node by its vector times
    ``node_positions_weight``, and the node mask zeroes the positions of
    padding nodes (``interactions.py:509-534``)."""

    def __init__(
        self,
        node_dims: Tuple[int, int],
        edge_dims: Tuple[int, int],
        cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        dropout: float = 0.1,
        updating_node_positions: bool = False,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.pre_norm = layer_cfg.pre_norm
        self.updating_node_positions = updating_node_positions
        self.node_positions_weight = cfg.node_positions_weight
        self.interaction = GCPMessagePassing(
            node_dims, node_dims, edge_dims, cfg, layer_cfg, reduce_function="sum",
            use_scalar_message_attention=layer_cfg.use_scalar_message_attention,
            aggregate_with_row=layer_cfg.aggregate_with_row, **kw,
        )
        self.gcp_norm_0 = GCPLayerNorm(node_dims[0], device=device)
        self.gcp_dropout_0 = GCPDropout(dropout)
        num_ff = layer_cfg.num_feedforward_layers
        hidden = _ff_hidden_dims(node_dims, num_ff)
        ff = [
            make_gcp(
                (2 * node_dims[0], 2 * node_dims[1]), hidden, cfg,
                nonlinearities=(None, None) if num_ff == 1 else cfg.nonlinearities,
                feedforward_out=num_ff == 1, vector_residual=False, **kw,
            )
        ]
        ff += [make_gcp(hidden, hidden, cfg, nonlinearities=cfg.nonlinearities, **kw) for _ in range(max(0, num_ff - 2))]
        if num_ff > 1:
            ff.append(
                make_gcp(
                    hidden, node_dims, cfg, nonlinearities=(None, None), feedforward_out=True,
                    vector_residual=False, **kw,
                )
            )
        for i, module in enumerate(ff):
            self.add_module(f"feedforward_{i}", module)
        self.num_ff = num_ff
        if updating_node_positions:
            self.node_position_update_gcp = make_gcp(
                node_dims, (node_dims[0], 1), cfg, nonlinearities=cfg.nonlinearities, vector_residual=False, **kw
            )

    def forward(
        self,
        node_rep: ScalarVector,
        edge_rep: ScalarVector,
        senders: Index,
        receivers: Index,
        frames: Tensor,
        node_mask: Optional[Tensor] = None,
        edge_mask: Optional[Tensor] = None,
        count_mask: Optional[Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        node_pos: Optional[Tensor] = None,
    ):
        """The new node representation; with ``updating_node_positions``,
        ``(node_rep, node_pos + x_update)`` for positions ``node_pos [N, 3]``.
        ``senders`` and ``receivers`` each in its sorted form where the
        batch has one."""
        frame_mask = _frame_mask(senders, receivers, node_mask, edge_mask)
        agg_mask = count_mask if count_mask is not None else edge_mask

        if self.pre_norm:
            node_rep = self.gcp_norm_0(node_rep)
        hidden = self.interaction(
            node_rep, edge_rep, senders, receivers, frames, edge_mask=agg_mask, count_mask=count_mask,
            frame_mask=frame_mask,
        )
        hidden = hidden.concat((node_rep,))
        nf = NodeFrames(frames, senders, node_rep.scalar.shape[0], frame_mask, count_mask)
        for i in range(self.num_ff):
            hidden = getattr(self, f"feedforward_{i}")(hidden, nf)
        node_rep = node_rep + self.gcp_dropout_0(hidden, deterministic, generator)
        if not self.pre_norm:
            node_rep = self.gcp_norm_0(node_rep)
        if node_mask is not None:
            m = node_mask[:, None].to(node_rep.scalar.dtype)
            node_rep = ScalarVector(node_rep.scalar * m, node_rep.vector * m)
        if not self.updating_node_positions:
            return node_rep
        update = self.node_position_update_gcp(node_rep, nf)
        node_pos = node_pos + vec_at(update.vector, 0).to(node_pos.dtype) * self.node_positions_weight
        if node_mask is not None:
            node_pos = node_pos * node_mask[:, None].to(node_pos.dtype)
        return node_rep, node_pos


LAYER_CLASSES = {"GCPInteractions": GCPInteractions, "GCPInteractions2": GCPInteractions2}
