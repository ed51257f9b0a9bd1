"""CPD task model: computational protein design, a 20-way residue
classification over the nodes of a CATH residue graph.

Port of ``gcpnet_tpu/models/cpd.py``: the embedding (float node features,
post-norm), ``num_encoder_layers`` interaction layers, then either the
direct-shot ``GCPMLPDecoder`` or ``num_decoder_layers`` autoregressive
interaction layers whose edge scalars carry the sequence embedding of the
sender on causal edges (sender < receiver), and the invariant projection
to the vocabulary.

The encoder passes the batch's sorted receivers, so on the card its message
stacks run the edge map (K2, K3) and its reductions K1; the JAX model
passes none and runs its plain stack (the same function).  The decoder's
stacks ablate the frames, which the edge map does not cover: they run the
plain stack, and their sums K1.

Two differences from the JAX model.  The forward returns the logits alone:
:func:`cpd_loss` takes their log-softmax, in float32 (the JAX model returns
both, in the compute dtype).  :meth:`GCPNetCPD.sample` computes at each
position only what the JAX ``fori_loop`` keeps (the in-edges of the
position's nodes, their senders' cached reps, the position's nodes); its
draws come from a torch generator, not ``jax.random``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.data.batching import sorted_index
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.models.common import batch_masks, centralize_and_frames
from gcpnet_torch.nn.decoder import GCPMLPDecoder
from gcpnet_torch.nn.embedding import Embed, GCPEmbedding, one_hot
from gcpnet_torch.nn.frames import NodeFrames
from gcpnet_torch.nn.gcp import make_gcp
from gcpnet_torch.nn.interactions import GCPInteractions
from gcpnet_torch.nn.primitives import ScalarVector
from gcpnet_torch.ops.segment import Index, SortedIndex, gather_rows, index_of, masked_mean


def decoder_cfg(cfg: ModuleCfg) -> ModuleCfg:
    """The decoder's GCPs: the frame gate's flag becomes the vector gate's,
    and frame updates are ablated (JAX ``models/cpd.py:40-45``)."""
    return cfg.replace(vector_gate=cfg.frame_gate, frame_gate=False, ablate_frame_updates=True)


class GCPNetCPD(nn.Module):
    """``device=None`` builds the model on the card (and raises without
    one); weights are drawn from ``generator`` on the CPU and moved."""

    def __init__(
        self,
        model_cfg: ModelCfg,
        module_cfg: ModuleCfg,
        layer_cfg: LayerCfg,
        node_input_dims: Tuple[int, int] = (6, 3),
        edge_input_dims: Tuple[int, int] = (32, 1),
        autoregressive_decoder: bool = False,
        remat: bool = False,
        *,
        generator: torch.Generator,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.remat = remat  # declared and not read, as in the JAX CPD
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        mc = model_cfg
        node_dims = (mc.h_hidden_dim, mc.chi_hidden_dim)
        edge_dims = (mc.e_hidden_dim, mc.xi_hidden_dim)
        vocab = mc.output_dim
        self.norm_x_diff = module_cfg.norm_x_diff
        self.autoregressive_decoder = autoregressive_decoder
        self.num_encoder_layers = mc.num_encoder_layers
        self.num_decoder_layers = mc.num_decoder_layers
        self.gcp_embedding = GCPEmbedding(
            edge_input_dims, node_input_dims, edge_dims, node_dims, module_cfg,
            num_atom_types=0, pre_norm=False, **kw,
        )
        for i in range(mc.num_encoder_layers):
            self.add_module(
                f"encoder_{i}", GCPInteractions(node_dims, edge_dims, module_cfg, layer_cfg, dropout=mc.dropout, **kw)
            )
        if autoregressive_decoder:
            self.seq_embedding = Embed(vocab, vocab, **kw)
            for i in range(mc.num_decoder_layers):
                self.add_module(
                    f"decoder_{i}",
                    GCPInteractions(
                        node_dims, (edge_dims[0] + vocab, edge_dims[1]), decoder_cfg(module_cfg), layer_cfg,
                        dropout=mc.dropout, autoregressive=True, **kw,
                    ),
                )
            proj_dim = vocab
        else:
            self.decoder = GCPMLPDecoder(
                node_dims[0], vocab, num_layers=mc.num_decoder_layers,
                residual_updates=mc.decoder_residual_updates, **kw,
            )
            proj_dim = node_dims[0]
        self.invariant_node_projection = make_gcp(
            node_dims, (proj_dim, 0), module_cfg, nonlinearities=(None, None), bottleneck=1,
            vector_residual=False, **kw,
        )

    def _decoders(self) -> List[GCPInteractions]:
        return [getattr(self, f"decoder_{i}") for i in range(self.num_decoder_layers)]

    def _encode(self, batch: GraphBatch, frames: Tensor, deterministic: bool, generator):
        """``(node_rep, edge_rep)`` after the embedding and the encoder layers."""
        edge_mask, count_mask = batch_masks(batch)
        node_rep, edge_rep = self.gcp_embedding(batch, frames, edge_mask, count_mask)
        for i in range(self.num_encoder_layers):
            node_rep = getattr(self, f"encoder_{i}")(
                node_rep, edge_rep, batch.sender_index(), batch.receiver_index(), frames,
                node_mask=batch.node_mask, edge_mask=edge_mask, count_mask=count_mask,
                deterministic=deterministic, generator=generator,
            )
        return node_rep, edge_rep

    def _causal_seq_edges(self, senders: Index, receivers: Tensor, seq: Tensor) -> Tensor:
        """The senders' sequence embeddings on causal edges (sender <
        receiver), zero elsewhere (``senders`` in their sorted form where
        the batch has one)."""
        e_seq = gather_rows(self.seq_embedding(seq), senders)
        return e_seq * (index_of(senders) < receivers)[:, None].to(e_seq.dtype)

    def forward(
        self,
        batch: GraphBatch,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """The logits ``[N, vocab]`` (teacher-forced on ``extras["seq"]`` with
        the autoregressive decoder).  ``deterministic=False`` applies
        dropout, with masks drawn from ``generator``."""
        _, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        batch = batch.replace(x=centered)
        edge_mask, count_mask = batch_masks(batch)
        node_rep, edge_rep = self._encode(batch, frames, deterministic, generator)
        if self.autoregressive_decoder:
            encoder_rep = node_rep
            e_seq = self._causal_seq_edges(batch.sender_index(), batch.receivers, batch.extras["seq"])
            edge_rep = ScalarVector(torch.cat([edge_rep.scalar, e_seq], dim=-1), edge_rep.vector)
            for layer in self._decoders():
                node_rep = layer(
                    node_rep, edge_rep, batch.sender_index(), batch.receiver_index(), frames,
                    node_mask=batch.node_mask, edge_mask=edge_mask, count_mask=count_mask,
                    deterministic=deterministic, generator=generator, node_rep_regressive=encoder_rep,
                )
        nf = NodeFrames(frames, batch.sender_index(), batch.num_nodes, edge_mask, count_mask)
        out = self.invariant_node_projection(node_rep, nf)
        if self.autoregressive_decoder:
            return out
        logits, _ = self.decoder(out)
        return logits

    @torch.inference_mode()
    def sample(
        self,
        batch: GraphBatch,
        nodes_per_graph: int,
        temperature: float = 0.1,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """Autoregressive sampling (JAX ``GCPNetCPD.sample``): ``batch``
        holds graphs of exactly ``nodes_per_graph`` node slots each (as
        ``num_samples`` copies of one chain), a node's local index is its
        position; returns the sampled residues ``[N]`` (0 at masked nodes).
        At position ``i`` each decoder layer updates the valid nodes at
        ``i`` from their in-edges, reading layer ``j``'s cache (its input
        for decoded positions, the encoder's rep for the rest) on forward
        edges and the encoder's rep on backward ones; the projection sees
        those nodes' frames through the edges among them only, as the JAX
        step's ``proj_edge_mask`` has it: self-loops, whose frames are zero.
        Residues are drawn from ``softmax(logits / temperature)`` by the
        Gumbel-max rule, with noise from ``generator``.  The decoder's GCPs
        ablate the frames (:func:`decoder_cfg`), so a step's subgraph, which
        lacks its nodes' other edges, gives them what the whole graph
        would."""
        if not self.autoregressive_decoder:
            raise ValueError("GCPNetCPD.sample needs the autoregressive decoder")
        decoders = self._decoders()
        _, centered, frames = centralize_and_frames(batch, norm_x_diff=self.norm_x_diff)
        batch = batch.replace(x=centered)
        edge_mask, _ = batch_masks(batch)
        node_rep, edge_rep = self._encode(batch, frames, True, None)
        device = node_rep.scalar.device
        plan = sampling_plan(batch, nodes_per_graph, device)
        # the projection's node frames: the JAX step's proj_edge_mask keeps
        # only edges whose both ends are step nodes (one a graph: so
        # self-loops), and a self-loop's frame (x_i - x_i, x_i x x_i) is
        # zero, so the step nodes' mean frames are zero in every graph (and
        # in E(3) mode so is each self-loop's projection, abs included)
        zero_frames = frames.new_zeros((batch.num_nodes, frames.shape[1]))
        cache = [ScalarVector(node_rep.scalar.clone(), node_rep.vector.clone()) for _ in decoders]
        seq = torch.zeros(batch.num_nodes, dtype=torch.long, device=device)
        for step in plan:
            nodes, edges, rows = step.nodes, step.edges, step.step_rows
            senders_g, receivers_g = batch.senders[edges], batch.receivers[edges]
            e_seq = self._causal_seq_edges(senders_g, receivers_g, seq)
            step_edges = ScalarVector(torch.cat([edge_rep.scalar[edges], e_seq], dim=-1), edge_rep.vector[edges])
            sub_frames = frames[edges]
            sub_edge_mask = edge_mask[edges]
            regressive = ScalarVector(cache[0].scalar[nodes], cache[0].vector[nodes])
            for j, layer in enumerate(decoders):
                out = layer(
                    ScalarVector(cache[j].scalar[nodes], cache[j].vector[nodes]), step_edges,
                    step.senders, step.receivers, sub_frames, node_mask=step.is_step, edge_mask=sub_edge_mask,
                    count_mask=step.all_edges, node_rep_regressive=regressive,
                )
                if j + 1 < len(decoders):
                    cache[j + 1].scalar[step.step_nodes] = out.scalar[rows]
                    cache[j + 1].vector[step.step_nodes] = out.vector[rows]
            step_rep = ScalarVector(out.scalar[rows], out.vector[rows])
            logits = self.invariant_node_projection(step_rep, zero_frames[: rows.shape[0]])
            u = torch.rand(logits.shape, generator=generator, device=device)
            gumbel = -torch.log(-torch.log(u))
            seq[step.step_nodes] = torch.argmax(logits.float() / temperature + gumbel, dim=-1)
        return seq


class SamplingStep(NamedTuple):
    """One position's subgraph: ``nodes`` (global ids, ascending, so that an
    edge's direction in the subgraph is its direction in the batch: the
    position's valid nodes and their in-edges' senders), ``edges`` (global
    rows of those nodes' in-edges under the padding mask), the edges'
    ``senders`` and ``receivers`` as indices into ``nodes``, each in its
    sorted form (so that on the card the decoder's sums run through K1);
    ``is_step`` over ``nodes``, ``step_rows`` (its indices) and
    ``step_nodes`` (their global ids); ``all_edges`` (ones)."""

    nodes: Tensor
    edges: Tensor
    senders: SortedIndex
    receivers: SortedIndex
    is_step: Tensor
    step_rows: Tensor
    step_nodes: Tensor
    all_edges: Tensor


def sampling_plan(batch: GraphBatch, nodes_per_graph: int, device) -> List[SamplingStep]:
    """The :class:`SamplingStep` of every position with a valid node, built
    on the host from one read of the batch's index arrays and moved to
    ``device`` in one copy each."""
    senders = batch.senders.cpu().numpy()
    receivers = batch.receivers.cpu().numpy()
    pad = batch.edge_pad_mask.cpu().numpy()
    valid = batch.valid_node_mask().cpu().numpy()
    local = np.arange(batch.num_nodes) % nodes_per_graph
    edge_pos = np.where(pad & valid[receivers], local[receivers], nodes_per_graph)
    edge_order = np.argsort(edge_pos, kind="stable")
    edge_bounds = np.searchsorted(edge_pos[edge_order], np.arange(nodes_per_graph + 1))
    node_pos = np.where(valid, local, nodes_per_graph)
    node_order = np.argsort(node_pos, kind="stable")
    node_bounds = np.searchsorted(node_pos[node_order], np.arange(nodes_per_graph + 1))
    names = ("nodes", "edges", "is_step", "step_rows", "step_nodes")
    index_parts = ("index", "perm", "inv", "splits")
    names += tuple(f"{end}_{part}" for end in ("senders", "receivers") for part in index_parts)
    parts = {name: [] for name in names}
    shapes = []
    for i in range(nodes_per_graph):
        step_nodes = node_order[node_bounds[i]:node_bounds[i + 1]]
        if not step_nodes.size:
            continue
        edges = edge_order[edge_bounds[i]:edge_bounds[i + 1]]
        nodes = np.union1d(step_nodes, senders[edges])
        is_step = np.isin(nodes, step_nodes)
        parts["nodes"].append(nodes)
        parts["edges"].append(edges)
        for end, ids in (("senders", senders), ("receivers", receivers)):
            local_ids = np.searchsorted(nodes, ids[edges])
            perm, inv, splits = sorted_index(local_ids, np.ones(edges.size, dtype=bool), nodes.size)
            for part, arr in zip(index_parts, (local_ids, perm, inv, splits)):
                parts[f"{end}_{part}"].append(arr)
        parts["is_step"].append(is_step)
        parts["step_rows"].append(np.flatnonzero(is_step))
        parts["step_nodes"].append(nodes[is_step])
        shapes.append((nodes.size, edges.size, step_nodes.size))
    flat = {
        name: torch.from_numpy(np.concatenate(arrs) if arrs else np.zeros(0, np.int64)).to(device)
        for name, arrs in parts.items()
    }
    ones = torch.ones(max((e for _, e, _ in shapes), default=0), dtype=torch.bool, device=device)
    steps, n0, e0, k0, s0 = [], 0, 0, 0, 0
    for n, e, k in shapes:
        nodes, edges, rows, splits = slice(n0, n0 + n), slice(e0, e0 + e), slice(k0, k0 + k), slice(s0, s0 + n + 1)

        def index(end):
            return SortedIndex(**{part: flat[f"{end}_{part}"][splits if part == "splits" else edges]
                                  for part in index_parts})

        steps.append(SamplingStep(
            flat["nodes"][nodes], flat["edges"][edges], index("senders"), index("receivers"),
            flat["is_step"][nodes], flat["step_rows"][rows], flat["step_nodes"][rows], ones[:e],
        ))
        n0, e0, k0, s0 = n0 + n, e0 + e, k0 + k, s0 + n + 1
    return steps


def cpd_loss(logits: Tensor, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
    """Masked cross-entropy over the valid residues (JAX ``models/cpd.py:
    281-``): ``(loss, seq)``, the log-softmax taken in float32."""
    seq = batch.extras["seq"].long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    # a one-hot product, whose backward scatters nothing
    nll = -(log_probs * one_hot(seq, log_probs.shape[-1], log_probs.dtype)).sum(-1)
    return masked_mean(nll, batch.valid_node_mask()), seq
