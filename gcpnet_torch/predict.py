"""Serve predictions with the port: ``python -m gcpnet_torch.predict``.

With overrides (``key=value`` words), the port of the root ``predict.py``:
it composes ``configs/predict.yaml`` with the JAX entry point's grammar
(as ``gcpnet_torch.train``), builds the datamodule and the model from the
composed blocks, loads the best checkpoint of ``ckpt_path`` (else its
last) in float32, and serves every batch of the datamodule's
``predict_batches`` (:func:`serve`); the datamodule's
``record_predictions`` writes its outputs to
``datamodule.predict_output_dir`` (EQ: each decoy's PDB with its
per-residue lDDT in the b-factor column; AR: each decoy's refined PDB,
stitched from its windows) and gives a row a decoy, written to
``predictions_csv_path``::

    python -m gcpnet_torch.predict model=gcpnet_eq datamodule=eq ckpt_path=... \
        datamodule.predict_input_dir=... datamodule.predict_output_dir=...

With flags (or none), the benchmark's forward: builds the LBA model at the
width of the JAX package's benchmark (hidden 100/16/32/4, 8 interaction
layers of 8-layer message stacks, 9 atom types), initialises it from
``--seed`` or loads ``--weights`` (an ``.npz`` of flax parameter paths, see
``gcpnet_torch.weights``), and answers ``--batches`` synthetic LBA-shaped
batches, printing one JSON line of predictions per batch.  The synthetic
graphs copy the JAX benchmark's generator: ATOM3D-LBA-shaped graphs with
in-degrees uniform around the mean (24..32 for a mean of 28) and random
senders.

The batches are receiver-sorted, so the forward pass runs through the
edge-map (K2) and sorted segment-sum (K1) kernels on the card, where the
forward is a CUDA graph captured for the batch shape and the model's dtype
and replayed for every batch (:class:`Predictor`).  Both run on the card
unless asked for the CPU (``trainer.accelerator=cpu``, ``--device cpu``).
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def serve(model: torch.nn.Module, dm, output_dir: str, served: Optional[list] = None) -> Tuple[List[dict], List[float]]:
    """Every batch of ``dm.predict_batches()`` through ``model``'s
    :class:`Predictor`, its predictions handed to ``dm.record_predictions``
    with ``output_dir``: the rows it gives, and each row's milliseconds
    from the first batch it reads to the row.  ``(batch, predictions)``
    pairs go to ``served`` where that is a list."""
    os.makedirs(output_dir, exist_ok=True)
    predictor = Predictor(model)
    rows, ms, batches = [], [], 0
    t0 = time.perf_counter()
    for batch in dm.predict_batches():
        batches += 1
        preds = predictor(batch).float().cpu().numpy()
        if served is not None:
            served.append((batch, preds))
        for row in dm.record_predictions(batch, preds, output_dir):
            rows.append(row)
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
    if not batches:
        raise RuntimeError(f"no prediction inputs found in {getattr(dm, 'predict_input_dir', None)}")
    return rows, ms


def write_rows(rows: List[dict], path: str) -> None:
    """``rows`` as a CSV, columns in sorted order (the JAX writer's)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=sorted(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def predict_from_config(cfg: Dict[str, Any], served: Optional[list] = None) -> Dict[str, Any]:
    """The composed ``predict.yaml`` route: ``{"num_predictions": n}``."""
    from gcpnet_torch.train.checkpoints import CheckpointManager
    from gcpnet_torch.train.entry import device_of, setup
    from gcpnet_torch.utils.loggers import WandbLogger, instantiate_loggers
    from gcpnet_torch.utils.pylogger import get_pylogger

    log = get_pylogger("gcpnet_torch.predict")
    device_of(cfg.get("trainer") or {})  # no card and no trainer.accelerator=cpu: raise before anything else
    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path or ckpt_path == "???":
        raise ValueError("predict requires ckpt_path=<checkpoint dir>")
    device, dm, model, _ = setup(cfg, stage="predict")
    mgr = CheckpointManager(ckpt_path, monitor="val/loss")
    state = mgr.restore_best(map_location=device) or mgr.restore_last(map_location=device)
    if state is None:
        raise FileNotFoundError(f"no checkpoint found under {ckpt_path}")
    model.load_state_dict(state["model"])
    model.float().eval()
    out_dir = cfg["datamodule"].get("predict_output_dir") or "predictions"
    rows, ms = serve(model, dm, out_dir, served)
    for row, t in zip(rows, ms):
        log.info(f"{row} in {t:.1f} ms")
    if rows:
        csv_path = cfg.get("predictions_csv_path") or os.path.join(out_dir, "predictions.csv")
        write_rows(rows, csv_path)
        log.info(f"wrote {len(rows)} prediction rows to {csv_path}")
    for logger in instantiate_loggers(cfg.get("logger")):
        if isinstance(logger, WandbLogger):
            key = "refined_pdb" if any("refined_pdb" in r for r in rows) else "annotated_pdb"
            logger.log_molecule_table("predictions", rows, pdb_key=key)
        logger.finalize()
    return {"num_predictions": len(rows)}


def main(argv: Optional[Sequence[str]] = None, served: Optional[list] = None):
    """Overrides: the composed route (:func:`predict_from_config`, its
    metrics); flags or none: the benchmark's forward (:func:`bench_main`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or any(a.startswith("--") for a in argv):
        return bench_main(argv)
    from gcpnet_torch.config.loader import CONFIG_DIR, compose
    from gcpnet_torch.utils.utils import task_wrapper

    return task_wrapper(predict_from_config)(compose(CONFIG_DIR, "predict.yaml", argv), served)


def bench_main(argv: Optional[Sequence[str]] = None) -> None:
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
