"""Serve LBA predictions with the port: ``python -m gcpnet_torch.predict``.

Builds the LBA model at the width of the JAX package's benchmark (hidden
100/16/32/4, 8 interaction layers of 8-layer message stacks, 9 atom
types), initialises it from ``--seed`` or loads ``--weights`` (an ``.npz``
of flax parameter paths, see ``gcpnet_torch.weights``), and answers
``--batches`` synthetic LBA-shaped batches, printing one JSON line of
predictions per batch.  The batches are receiver-sorted, so the forward pass
runs through the edge-map (K2) and sorted segment-sum (K1) kernels on the
card, where the forward is a CUDA graph captured for the batch shape and
the model's dtype and replayed for every batch (:class:`Predictor`).  It
runs on the card unless ``--device cpu`` is given.

The synthetic graphs copy the JAX benchmark's generator: ATOM3D-LBA-shaped
graphs with in-degrees uniform around the mean (24..32 for a mean of 28)
and random senders.  Real LBA inputs wait for the ATOM3D data.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from gcpnet_torch.config.schema import LayerCfg, MPCfg, ModelCfg, ModuleCfg
from gcpnet_torch.data.batching import Bucket, collate_shards
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.graph import GraphBatch, GraphData
from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.train.graphs import CapturedCall
from gcpnet_torch.weights import from_jax_params

# spare edge rows for the 128-row tile alignment of the sorted layout
EDGE_SLACK = 64 * 128
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def lba_configs():
    """(ModelCfg, ModuleCfg, LayerCfg) of the benchmark's LBA model."""
    model_cfg = ModelCfg(
        chi_input_dim=2, e_input_dim=16, xi_input_dim=1,
        h_hidden_dim=100, chi_hidden_dim=16, e_hidden_dim=32, xi_hidden_dim=4,
        num_encoder_layers=8, dropout=0.1,
    )
    layer_cfg = LayerCfg(mp_cfg=MPCfg(num_message_layers=8))
    return model_cfg, ModuleCfg(), layer_cfg


def random_lba_graph(rng: np.random.Generator, nodes: int, edges_per_node: int) -> GraphData:
    """One LBA-shaped graph: in-degrees uniform in ``edges_per_node ± 4``,
    adjusted to sum to exactly ``nodes * edges_per_node``."""
    n, e = nodes, nodes * edges_per_node
    lo, hi = max(edges_per_node - 4, 0), edges_per_node + 4
    x = (rng.normal(size=(n, 3)) * 8).astype(np.float32)
    in_deg = rng.integers(lo, hi + 1, size=n)
    delta = e - int(in_deg.sum())
    step = 1 if delta > 0 else -1
    while delta != 0:
        i = int(rng.integers(0, n))
        nd = in_deg[i] + step
        if lo <= nd <= hi:
            in_deg[i] = nd
            delta -= step
    receivers = np.repeat(np.arange(n, dtype=np.int32), in_deg)
    senders = rng.integers(0, n, size=e).astype(np.int32)
    perm = rng.permutation(e)
    return GraphData(
        h=rng.integers(0, 9, size=n).astype(np.int32),
        chi=rng.normal(size=(n, 2, 3)).astype(np.float32),
        e=rng.normal(size=(e, 16)).astype(np.float32),
        xi=rng.normal(size=(e, 1, 3)).astype(np.float32),
        x=x,
        senders=senders[perm],
        receivers=receivers[perm],
        extras={"label": np.float32(rng.normal())},
    )


def synthetic_batches(
    num_batches: int, graphs: int, nodes: int, edges_per_node: int, seed: int,
    sort_tile: int = 128,
) -> List[GraphBatch]:
    """Host batches of ``graphs`` random LBA graphs, padded with
    ``EDGE_SLACK`` spare edge rows and sorted by receiver."""
    rng = np.random.default_rng(seed)
    bucket = Bucket(
        num_nodes=nodes * graphs,
        num_edges=nodes * edges_per_node * graphs + EDGE_SLACK,
        num_graphs=graphs,
    )
    batches = []
    for _ in range(num_batches):
        batch = collate_shards(
            [[random_lba_graph(rng, nodes, edges_per_node) for _ in range(graphs)]],
            bucket, extra_graph_keys=("label",), sort_edges=True, sort_tile=sort_tile,
        )
        if batch.edge_row_splits is None:
            raise ValueError("edge budget lacks alignment slack for the sorted layout")
        batches.append(batch)
    return batches


def build_model(
    seed: int,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
    weights: Optional[str] = None,
) -> GCPNetLBA:
    """The LBA model in eval mode on ``device`` (``None``: the card), in
    ``dtype``, initialised from ``seed`` or loaded from ``weights``."""
    model = GCPNetLBA(
        *lba_configs(),
        num_atom_types=9,
        generator=torch.Generator().manual_seed(seed),
        device=device,
    )
    if weights is not None:
        model.load_state_dict(from_jax_params(weights))
    return model.to(dtype).eval()


@torch.inference_mode()
def predict(model: GCPNetLBA, batch: GraphBatch) -> torch.Tensor:
    """One eager forward pass over a host batch: ``[num_graphs]``
    predictions on the model's device, in its dtype."""
    param = next(model.parameters())
    return model(batch.to(param.device, param.dtype))


class Predictor:
    """The serving forward of ``model``: on the card one replay of a CUDA
    graph captured per batch shape (and the model's dtype,
    ``train.graphs.CapturedCall``), its input copied from pinned host
    memory; on the CPU :func:`predict`.

    Under inference mode the layers' packed weights (and K2's weight
    images) are made in the eager first call and cached, and a graph reads
    the cache.  So each call compares every parameter's and buffer's
    address and version with those the graphs were captured with, and
    drops the graphs where any changed (``load_state_dict``, an optimizer
    step, ``model.to``)."""

    def __init__(self, model: GCPNetLBA):
        self.model = model
        param = next(model.parameters())
        self.graphs = None
        self._weights = None
        if param.device.type == "cuda":
            self.graphs = CapturedCall(lambda batches: tuple(model(b) for b in batches), param.device)

    def _weights_key(self) -> tuple:
        # as ``GCPMessagePassing.packed_stack``: inference tensors keep no version
        tensors = itertools.chain(self.model.parameters(), self.model.buffers())
        return tuple((t.data_ptr(), 0 if t.is_inference() else t._version) for t in tensors)

    @torch.inference_mode()
    def __call__(self, batch: GraphBatch) -> torch.Tensor:
        """``[num_graphs]`` predictions of a host batch, on the model's
        device, in its dtype."""
        if self.graphs is None:
            return predict(self.model, batch)
        weights = self._weights_key()
        if weights != self._weights:
            self.graphs.clear()
            self._weights = weights
        return self.graphs([batch.pinned(next(self.model.parameters()).dtype)])[0]


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--graphs", type=int, default=16)
    parser.add_argument("--nodes", type=int, default=448)
    parser.add_argument("--edges-per-node", type=int, default=28)
    parser.add_argument("--batches", type=int, default=1)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="fp32")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--weights", default=None, help=".npz of flax parameter paths")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model = build_model(args.seed, device, DTYPES[args.dtype], args.weights)
    batches = synthetic_batches(
        args.batches, args.graphs, args.nodes, args.edges_per_node, args.seed
    )
    predictor = Predictor(model)
    for i, batch in enumerate(batches):
        preds = predictor(batch).float().cpu()[torch.as_tensor(batch.graph_pad_mask)]
        print(json.dumps({"batch": i, "predictions": preds.tolist()}), flush=True)


if __name__ == "__main__":
    main()
