"""Geometry-complete message passing.

Port of ``gcpnet_tpu/nn/message_passing.py``: every edge builds the message
``[src node ‖ edge ‖ dst node]``, a (Res)GCP stack maps it, optionally
the scalar message attention ``sigmoid(Dense(1)(s))`` scales its scalars
(EQ, AR), and a masked mean (``"mean"``) or sum (``"sum"``, ``"add"``)
reduces the messages into their receivers, or with ``aggregate_with_row``
into their senders (EQ, AR).

On the card a stack that the fused edge map covers (``fast_supported``)
runs as one (``ops.edge_map``, kernels K2 and K3), whatever index it is
summed by; on the CPU it does so where the receivers come in their sorted
form (the row splits of a receiver-sorted batch), as the JAX package's
``"fused"`` configuration does, and otherwise module by module.  An index
in its sorted form (``ops.segment.SortedIndex``: ``GraphBatch.
receiver_index``, ``GraphBatch.sender_index``) is summed through the
sorted segment sum (kernel K1), and the gathers of the message's node rows
have K1 as their backward.  A stack with a setting outside the kernels'
layer table (:func:`kernel_outside`: GCP v1, the frame gates, E(3) mode,
the scalar, vector and frame ablations) runs module by module on the card
too, its sums and gathers' backward still through K1, as the JAX package
runs such stacks outside its Pallas kernels.  The JAX EQ passes no
row splits with ``aggregate_with_row`` and so reaches no Pallas kernel;
running K1-K3 there is the port's choice, with the same math.  In the
dense slot-major layout the receivers come as an ``ops.segment.
DenseIndex``: the receiver gather of the message is a broadcast of the
node rows over the slots, the receiver-side sum the slot sum, and K2/K3
run the stack over the slot rows as over any others (the rows are
independent).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModuleCfg
from gcpnet_torch.nn.gcp import GCP2, Dense, make_gcp
from gcpnet_torch.nn.primitives import ScalarVector
from gcpnet_torch.ops.edge_map import PackedStack, StackLayer, edge_map, pack_stack
from gcpnet_torch.ops.segment import DenseIndex, Index, SortedIndex, gather_rows, segment_mean, segment_sum


# the GCP settings outside K2/K3's layer table: stacks with any of them run
# module by module, as the JAX ``_fast_supported`` sends them to XLA
# (``gcpnet_tpu/nn/message_passing.py:111-132``)
KERNEL_OUTSIDE_FLAGS = (
    "frame_gate", "sigma_frame_gate", "enable_e3_equivariance", "ablate_frame_updates", "ablate_scalars",
    "ablate_vectors",
)


def kernel_outside(module) -> Tuple[str, ...]:
    """The settings of a message-stack GCP that the fused stack (K2/K3)
    does not cover: GCP v1 (its two-stage update), GCP3's
    ``feedforward_out``, inputs or outputs without vector channels, and
    the flags of ``KERNEL_OUTSIDE_FLAGS``."""
    st = module.settings
    out = [] if isinstance(module, GCP2) else ["GCP v1"]
    if module.input_dims[1] <= 0 or module.output_dims[1] <= 0:
        out.append("no vector channels")
    out += [name for name in KERNEL_OUTSIDE_FLAGS if getattr(st, name)]
    if module.feedforward_out:
        out.append("feedforward_out")
    return tuple(out)


def _stack_layer(module) -> StackLayer:
    """A message-stack GCP as a layer of the kernels' table, with the
    settings it would need that the table lacks in ``outside``
    (``ops.edge_map._check_kernel_supported`` raises on them).  Where the
    GCP projects no frames in its first stage (``ablate_frame_updates``,
    GCP v1) the frame weights are zeros."""
    st = module.settings
    outside = kernel_outside(module)
    if "no vector channels" in outside:
        raise NotImplementedError(f"edge_map kernel: a stack layer with {list(outside)}")
    v_in = module.vector_down.kernel.shape[0]
    reads_frames = isinstance(module, GCP2) and not st.ablate_frame_updates
    if reads_frames:
        w_down = torch.cat([module.vector_down.kernel, module.vector_down_frames.kernel], dim=1)
    else:
        w_down = torch.cat([module.vector_down.kernel, module.vector_down.kernel.new_zeros(v_in, 3)], dim=1)
    w_so = module.scalar_out_0.kernel if module.feedforward_out else module.scalar_out.kernel
    b_so = module.scalar_out_0.bias if module.feedforward_out else module.scalar_out.bias
    if not reads_frames:
        w_so = torch.cat([w_so, w_so.new_zeros(9, w_so.shape[1])], dim=0)
    gate = getattr(module, "vector_out_scale", None) if st.vector_gate else None
    return StackLayer(
        w_down=w_down.float(),
        w_so=w_so.float(),
        b_so=b_so.float(),
        w_up=module.vector_up.kernel.float(),
        w_gate=None if gate is None else gate.kernel.float(),
        b_gate=None if gate is None else gate.bias.float(),
        act_s=st.scalar_nonlinearity,
        act_v=st.vector_nonlinearity,
        slope=st.nonlinearity_slope,
        vector_residual=st.vector_residual,
        outside=outside,
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
        # the JAX ``_fast_supported`` set: GCP2, or GCP3 without
        # ``feedforward_out`` (GCP2's math), with none of the other settings
        self.fast_supported = not any(kernel_outside(m) for m in self.stack)
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
        sorted_receivers = isinstance(receivers, (SortedIndex, DenseIndex))
        if sorted_receivers and edge_mask is None:
            raise ValueError(
                "GCPMessagePassing: sorted or dense receivers (those layouts) need edge_mask to zero their padding rows")
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
