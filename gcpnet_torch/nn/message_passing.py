"""Geometry-complete message passing.

Port of ``gcpnet_tpu/nn/message_passing.py``: every edge builds the message
``[src node ‖ edge ‖ dst node]``, a (Res)GCP stack maps it, optionally
the scalar message attention ``sigmoid(Dense(1)(s))`` scales its scalars
(EQ, AR), and a masked mean (``"mean"``) or sum (``"sum"``, ``"add"``)
reduces the messages into their receivers, or with ``aggregate_with_row``
into their senders (EQ, AR).

On the card a stack that the fused edge map covers (``_fast_supported``)
runs as one (``ops.edge_map``, kernels K2 and K3), whatever index it is
summed by; on the CPU it does so where the receivers come in their sorted
form (the row splits of a receiver-sorted batch), as the JAX package's
``"fused"`` configuration does, and otherwise module by module.  An index
in its sorted form (``ops.segment.SortedIndex``: ``GraphBatch.
receiver_index``, ``GraphBatch.sender_index``) is summed through the
sorted segment sum (kernel K1), and the gathers of the message's node rows
have K1 as their backward.  The JAX EQ passes no
row splits with ``aggregate_with_row`` and so reaches no Pallas kernel;
running K1-K3 there is the port's choice, with the same math.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModuleCfg
from gcpnet_torch.nn.gcp import GCP2, Dense, GCPSettings, make_gcp
from gcpnet_torch.nn.primitives import ScalarVector
from gcpnet_torch.ops.edge_map import PackedStack, StackLayer, edge_map, pack_stack
from gcpnet_torch.ops.segment import Index, SortedIndex, gather_rows, segment_mean, segment_sum


def _fast_supported(settings: GCPSettings, input_dims, output_dims) -> bool:
    """The settings the fused stack covers (the JAX ``_fast_supported``
    set: GCP2, or GCP3 without ``feedforward_out``, which is GCP2's
    math)."""
    st = settings
    if input_dims[1] <= 0 or output_dims[1] <= 0:
        return False
    return not (
        st.frame_gate
        or st.sigma_frame_gate
        or st.enable_e3_equivariance
        or st.ablate_frame_updates
        or st.ablate_scalars
        or st.ablate_vectors
    )


def _stack_layer(module: GCP2) -> StackLayer:
    st = module.settings
    gate = module.vector_out_scale if st.vector_gate else None
    return StackLayer(
        w_down=torch.cat([module.vector_down.kernel, module.vector_down_frames.kernel], dim=1).float(),
        w_so=module.scalar_out.kernel.float(),
        b_so=module.scalar_out.bias.float(),
        w_up=module.vector_up.kernel.float(),
        w_gate=None if gate is None else gate.kernel.float(),
        b_gate=None if gate is None else gate.bias.float(),
        act_s=st.scalar_nonlinearity,
        act_v=st.vector_nonlinearity,
        slope=st.nonlinearity_slope,
        vector_residual=st.vector_residual,
    )


class GCPMessagePassing(nn.Module):
    def __init__(
        self,
        input_dims: Tuple[int, int],
        output_dims: Tuple[int, int],
        edge_dims: Tuple[int, int],
        cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        reduce_function: str = "mean",
        use_scalar_message_attention: bool = False,
        aggregate_with_row: bool = False,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        if reduce_function not in ("mean", "sum", "add"):
            raise ValueError(f"unknown reduce_function {reduce_function!r}")
        self.reduce_function = reduce_function
        self.output_dims = tuple(output_dims)
        self.residual = layer_cfg.mp_cfg.use_residual_message_gcp
        s_in, v_in = input_dims
        e_s, e_v = edge_dims
        n_layers = layer_cfg.mp_cfg.num_message_layers
        # first/last GCP: default bottleneck and default vector residual
        soft = dict(bottleneck=cfg.default_bottleneck, vector_residual=cfg.default_vector_residual)
        specs = [
            dict(
                input_dims=(2 * s_in + e_s, 2 * v_in + e_v),
                nonlinearities=cfg.nonlinearities if n_layers > 1 else None,
                **soft,
            )
        ]
        specs += [dict(input_dims=self.output_dims) for _ in range(max(0, n_layers - 2))]
        if n_layers > 1:
            specs.append(dict(input_dims=self.output_dims, nonlinearities=(None, None), **soft))
        for i, spec in enumerate(specs):
            dims = spec.pop("input_dims")
            self.add_module(
                f"message_fusion_{i}",
                make_gcp(dims, self.output_dims, cfg, generator=generator, device=device, **spec),
            )
        self.num_message_layers = len(specs)
        self.fast_supported = all(
            _fast_supported(m.settings, m.input_dims, m.output_dims) and not m.feedforward_out for m in self.stack
        )
        self.aggregate_with_row = aggregate_with_row
        self.scalar_message_attention = (
            Dense(self.output_dims[0], 1, generator=generator, device=device)
            if use_scalar_message_attention else None
        )
        self._packed: Optional[PackedStack] = None
        self._packed_key = None

    @property
    def stack(self):
        return [getattr(self, f"message_fusion_{i}") for i in range(self.num_message_layers)]

    def packed_stack(self) -> PackedStack:
        """The stack's weights in the edge-map kernels' layout.  Outside
        ``torch.inference_mode`` it is packed anew on each call from the
        tensors the modules hold now (under ``torch.func.functional_call``
        those are the substituted ones), so that autograd carries the
        gradient back to them.  Under inference mode it is derived once and
        re-derived only when a parameter changes (``load_state_dict``,
        ``.to(...)``)."""
        if not torch.is_inference_mode_enabled():
            return pack_stack([_stack_layer(m) for m in self.stack], self.residual)
        # inference tensors (made under torch.inference_mode) keep no version
        key = tuple(
            (p.data_ptr(), 0 if p.is_inference() else p._version, p.dtype, p.device)
            for p in self.parameters()
        )
        if key != self._packed_key:
            self._packed = pack_stack([_stack_layer(m) for m in self.stack], self.residual)
            self._packed_key = key
        return self._packed

    def messages(self, node_rep: ScalarVector, edge_rep: ScalarVector, senders: Index, receivers: Index):
        """The stack's input ``[src node ‖ edge ‖ dst node]`` of each edge
        (each index in its sorted form where there is one: the gathers'
        backward is then K1)."""
        flat_nodes = node_rep.flatten()
        v_dim = node_rep.dims[1]
        src = ScalarVector.recover(gather_rows(flat_nodes, senders), v_dim)
        dst = ScalarVector.recover(gather_rows(flat_nodes, receivers), v_dim)
        return src.concat((edge_rep, dst))

    def forward(
        self,
        node_rep: ScalarVector,
        edge_rep: ScalarVector,
        senders: Index,
        receivers: Index,
        frames: Tensor,
        edge_mask: Optional[Tensor] = None,
        count_mask: Optional[Tensor] = None,
        frame_mask: Optional[Tensor] = None,
        message: Optional[ScalarVector] = None,
    ) -> ScalarVector:
        """``senders`` and ``receivers`` each in its sorted form where the
        batch has one.  ``edge_mask`` gates the aggregation; ``frame_mask``
        (default ``edge_mask``) gates the scalarize numerators inside the
        stack; ``count_mask`` gates the mean's denominator.  ``message``,
        when given, is the stack's input in place of :meth:`messages` of
        ``node_rep``."""
        num_nodes = node_rep.scalar.shape[0]
        sorted_receivers = isinstance(receivers, SortedIndex)
        if sorted_receivers and edge_mask is None:
            raise ValueError("GCPMessagePassing: sorted receivers (the sorted layout) need edge_mask to zero its padding rows")
        fm = frame_mask if frame_mask is not None else edge_mask
        if message is None:
            message = self.messages(node_rep, edge_rep, senders, receivers)

        if self.fast_supported and (sorted_receivers or message.scalar.is_cuda):
            fr = frames if fm is None else frames * fm[:, None].to(frames.dtype)
            flat = edge_map(message.flatten(), fr.contiguous(), self.packed_stack())
        else:
            stack = self.stack
            if self.residual:
                rep = stack[0](message, frames, fm)
                for module in stack[1:]:
                    rep = rep + module(rep, frames, fm)
            else:
                rep = message
                for module in stack:
                    rep = module(rep, frames, fm)
            flat = rep.flatten()
        if self.scalar_message_attention is not None:
            s_out = self.output_dims[0]
            scalar = flat[:, :s_out]
            attn = torch.sigmoid(self.scalar_message_attention(scalar).float()).to(flat.dtype)
            flat = torch.cat([scalar * attn, flat[:, s_out:]], dim=-1)

        ids = senders if self.aggregate_with_row else receivers
        if self.reduce_function == "mean":
            agg = segment_mean(flat, ids, num_nodes, mask=edge_mask, count_mask=count_mask)
        else:
            agg = segment_sum(flat, ids, num_nodes, mask=edge_mask)
        return ScalarVector.recover(agg, self.output_dims[1])
