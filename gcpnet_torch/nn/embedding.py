"""Input embedding for nodes and edges.

Port of ``gcpnet_tpu/nn/embedding.py`` as LBA, PSR, CPD, NMS and RS use
it: the node scalars are atom types through an embedding table
(``num_atom_types > 0``) or float features taken as they are
(``num_atom_types == 0``), with the ligand flag's embedding appended where
``cfg.concatenate_lig_flag`` (LBA on ATOM3D records,
``batch.extras["lig_flag"]``); one edge GCP and one node GCP, with a
GCPLayerNorm of their inputs (``pre_norm``) or of their outputs (CPD).
Nodes or edges without input vector channels (``node_input_dims[1]`` or
``edge_input_dims[1]`` 0) enter their GCP as scalars alone; an output
without vector channels leaves with empty vectors.  ``nonlinearities``
(EQ's) are the edge GCP's; the node GCP has none.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import ModuleCfg
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.nn.frames import NodeFrames
from gcpnet_torch.nn.gcp import make_gcp
from gcpnet_torch.nn.primitives import GCPLayerNorm, ScalarVector, pack_vector

NUM_LIG_FLAGS = 2  # pocket atom, ligand atom


def one_hot(ids: Tensor, num: int, dtype: torch.dtype) -> Tensor:
    """``[..., num]`` one-hot rows of ``ids`` in ``dtype`` (by comparison:
    ``F.one_hot`` reads the ids' range back to the host)."""
    return (ids.long()[..., None] == torch.arange(num, device=ids.device)).to(dtype)


class Embed(nn.Module):
    """Lookup table with parameter ``embedding`` ``[num, features]``
    (flax ``nn.Embed``), initialised ``N(0, 1/features)``.  The lookup is a
    one-hot product, so its backward is a matrix product and not a scatter
    (the tables are small: at most 38 rows)."""

    def __init__(self, num_embeddings: int, features: int, *, generator: torch.Generator, device):
        super().__init__()
        w = torch.randn((num_embeddings, features), generator=generator) / math.sqrt(features)
        self.embedding = nn.Parameter(w.to(device))

    def forward(self, ids: Tensor) -> Tensor:
        return one_hot(ids, self.embedding.shape[0], self.embedding.dtype) @ self.embedding


class GCPEmbedding(nn.Module):
    def __init__(
        self,
        edge_input_dims: Tuple[int, int],
        node_input_dims: Tuple[int, int],
        edge_hidden_dims: Tuple[int, int],
        node_hidden_dims: Tuple[int, int],
        cfg: ModuleCfg,
        num_atom_types: int,
        pre_norm: bool = True,
        nonlinearities: Optional[Tuple[Optional[str], Optional[str]]] = None,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        self.pre_norm = pre_norm
        kw = dict(generator=generator, device=device)
        self.atom_embedding = Embed(num_atom_types, num_atom_types, **kw) if num_atom_types > 0 else None
        self.lig_flag_embedding = None
        if cfg.concatenate_lig_flag:
            self.lig_flag_embedding = Embed(NUM_LIG_FLAGS, NUM_LIG_FLAGS, **kw)
            node_input_dims = (node_input_dims[0] + NUM_LIG_FLAGS, node_input_dims[1])
        edge_norm_dims, node_norm_dims = (
            (edge_input_dims, node_input_dims) if pre_norm else (edge_hidden_dims, node_hidden_dims)
        )
        self.edge_normalization = GCPLayerNorm(edge_norm_dims[0], device=device)
        self.node_normalization = GCPLayerNorm(node_norm_dims[0], device=device)
        # embedding GCPs: bottleneck 1, no vector residual, no
        # nonlinearities but the edge GCP's ``nonlinearities`` (EQ's)
        overrides = dict(bottleneck=1, vector_residual=False)
        edge_nls = nonlinearities if nonlinearities is not None else (None, None)
        self.edge_embedding = make_gcp(
            edge_input_dims, edge_hidden_dims, cfg, nonlinearities=edge_nls, **overrides, **kw
        )
        self.node_embedding = make_gcp(
            node_input_dims, node_hidden_dims, cfg, nonlinearities=(None, None), **overrides, **kw
        )

    def forward(
        self,
        batch: GraphBatch,
        frames: Tensor,
        edge_mask: Optional[Tensor] = None,
        count_mask: Optional[Tensor] = None,
    ) -> Tuple[ScalarVector, ScalarVector]:
        h = batch.h if self.atom_embedding is None else self.atom_embedding(batch.h)
        if self.lig_flag_embedding is not None:
            h = torch.cat([h, self.lig_flag_embedding(batch.extras["lig_flag"]).to(h.dtype)], dim=-1)
        node_rep = ScalarVector(h, pack_vector(batch.chi))
        edge_rep = ScalarVector(batch.e, pack_vector(batch.xi))
        if self.pre_norm:
            edge_rep = self.edge_normalization(edge_rep)
            node_rep = self.node_normalization(node_rep)
        edge_out = self.edge_embedding(edge_rep, frames, edge_mask)
        nf = NodeFrames(frames, batch.sender_index(), batch.h.shape[0], edge_mask, count_mask)
        node_out = self.node_embedding(node_rep, nf)
        if not self.pre_norm:
            edge_out = self.edge_normalization(edge_out)
            node_out = self.node_normalization(node_out)
        return _with_vectors(node_out), _with_vectors(edge_out)


def _with_vectors(rep) -> ScalarVector:
    """A GCP's output as a ``ScalarVector`` (empty vectors for an output
    without vector channels)."""
    return rep if isinstance(rep, ScalarVector) else ScalarVector(rep, rep.new_zeros(rep.shape[:-1] + (0,)))
