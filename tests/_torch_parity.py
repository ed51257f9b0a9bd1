"""Helpers shared by the tests that hold gcpnet_torch against gcpnet_tpu:
the same numpy inputs and the same weights go to the JAX function and to
its port, on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.batching import Bucket, collate_shards, sort_edges_by_receiver
from gcpnet_torch.graph import GraphData, batch_graphs
from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.weights import from_jax_params

# The small LBA configuration of the parity tests: 2 interaction layers of
# 3-layer message stacks, hidden 16/4/8/4; bucket (nodes, edges, graphs).
LBA_MODEL = dict(
    chi_input_dim=2, e_input_dim=16, xi_input_dim=1, h_hidden_dim=16,
    chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2,
)
LBA_MESSAGE_LAYERS = 3
LBA_BUCKET = (48, 256, 3)


def random_graphs(rng: np.random.Generator, num_graphs: int = 2, nodes: int = 20, edges: int = 70):
    """Keyword dicts of random LBA-shaped graphs, for either package's
    ``GraphData``."""
    out = []
    for _ in range(num_graphs):
        out.append(
            dict(
                h=rng.integers(0, 9, size=nodes).astype(np.int32),
                chi=rng.normal(size=(nodes, 2, 3)).astype(np.float32),
                e=rng.normal(size=(edges, 16)).astype(np.float32),
                xi=rng.normal(size=(edges, 1, 3)).astype(np.float32),
                x=(rng.normal(size=(nodes, 3)) * 4).astype(np.float32),
                senders=rng.integers(0, nodes, size=edges).astype(np.int32),
                receivers=rng.integers(0, nodes, size=edges).astype(np.int32),
                extras={"label": np.float32(rng.normal())},
            )
        )
    return out


def sorted_batch(rng, tile, nodes=70, graphs=2, edges=300, bucket_edges=900):
    """A receiver-sorted port batch: with ``tile=128`` the tile-aligned
    layout with alignment holes, with ``tile=1`` plain CSR splits."""
    gs = random_graphs(rng, num_graphs=graphs, nodes=nodes, edges=edges)
    batch = batch_graphs(
        [GraphData(**g) for g in gs], graphs * nodes + 3, bucket_edges, graphs + 1,
        extra_graph_keys=("label",),
    )
    out = sort_edges_by_receiver(batch, tile=tile)
    assert out.edge_row_splits is not None
    return out


def to_jax(batch):
    """A host batch of the JAX package as device arrays."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a) if a is not None else None, batch)


def load_jax_params(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a flax variable tree into a port module (strict names)."""
    module.load_state_dict(from_jax_params(variables))
    return module


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy/JAX array -> torch tensor (floats in ``dtype``)."""
    arr = np.asarray(a)
    out = torch.from_numpy(arr.copy())
    return out.to(dtype) if out.is_floating_point() else out


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def lba_graphs():
    """Two random LBA graphs of 20 nodes and 70 edges, from a fixed seed."""
    return random_graphs(np.random.default_rng(3), num_graphs=2, nodes=20, edges=70)


def port_lba(params=None, **model_kw):
    """The port's small LBA model (``LBA_MODEL``) on the CPU, with the flax
    ``params`` where given."""
    model = GCPNetLBA(
        ModelCfg(**{**LBA_MODEL, **model_kw}), ModuleCfg(),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=LBA_MESSAGE_LAYERS)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return model if params is None else load_jax_params(model, params)


def port_batch(graphs, sort_tile=128):
    """``graphs`` as one receiver-sorted port batch of ``LBA_BUCKET``."""
    return collate_shards(
        [[GraphData(**g) for g in graphs]], Bucket(*LBA_BUCKET),
        extra_graph_keys=("label",), sort_edges=True, sort_tile=sort_tile,
    )
