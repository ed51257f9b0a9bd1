"""Refine protein decoys with the port's AR model: ``python -m
gcpnet_torch.predict_ar --input-dir D --output-dir O``.

Builds the AR model of the JAX package's experiment ``gcpnet_ar``
(``train.cli.ar_configs``) in float32, loads the best checkpoint of
``--checkpoint-dir`` (a ``python -m gcpnet_torch.train --task ar`` run's)
or draws the weights from ``--seed``, and runs
every ``.pdb`` of ``--input-dir`` through the windowed prediction path of
``data.ar.ARDataModule``: a decoy of 1,500 residues or more goes in
900-residue windows shifted by 850, one batch a window in the bucket of
``--max-nodes-per-batch`` nodes (a window that does not fit raises, naming
the decoy, the window and the bucket).  Each decoy's refined PDB, stitched
from its windows' kept atoms, goes to ``--output-dir`` under its own name,
and one row a decoy to ``--output-dir/scores.csv``; with ``--true-dir``
(the natives under the decoys' names) the row holds TM-score, GDT-TS,
GDT-HA, MaxSub and RMSD over the matched Ca atoms and lDDT over the matched
heavy atoms (the native scores; the binaries are not ported).  Prints one
JSON line a decoy.  On the card each window is one replay of a CUDA graph
of the forward, captured per bucket (``predict.Predictor``), through K1 and
K2; it runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from typing import Optional, Sequence

import torch

from gcpnet_torch.data.ar import ARDataModule
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.models.ar import GCPNetAR
from gcpnet_torch.predict import Predictor
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.train.cli import ar_configs

SCORE_KEYS = ("TM-score", "GDT-TS", "GDT-HA", "MaxSub", "RMSD", "lDDT")


def build_model(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 4,
    checkpoint_dir: Optional[str] = None,
) -> GCPNetAR:
    """The AR model in eval mode on ``device`` (``None``: the card): the best
    checkpoint of ``checkpoint_dir``, else weights drawn from ``seed``."""
    device = resolve_device(device)
    model = GCPNetAR(*ar_configs(num_encoder_layers), generator=torch.Generator().manual_seed(seed), device=device)
    if checkpoint_dir is not None:
        ckpt = CheckpointManager(checkpoint_dir).restore_best(map_location=device)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        model.load_state_dict(ckpt["model"])
    return model.eval()


def refine(model: GCPNetAR, dm: ARDataModule, output_dir: str, log=None) -> list:
    """Every decoy of ``dm.predict_input_dir`` refined and written to
    ``output_dir``; the score rows, each with its milliseconds from its
    first window's batch to its PDB (``ms``)."""
    os.makedirs(output_dir, exist_ok=True)
    predictor = Predictor(model)
    rows = []
    t0 = time.perf_counter()
    for batch in dm.predict_batches():
        preds = predictor(batch).float().cpu().numpy()
        for row in dm.record_predictions(batch, preds, output_dir):
            row["ms"] = (time.perf_counter() - t0) * 1e3
            rows.append(row)
            if log is not None:
                log(row)
            t0 = time.perf_counter()
    return rows


def write_scores(rows: list, path: str) -> None:
    keys = ["decoy", "refined_pdb", *SCORE_KEYS, "ms"]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(rows)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input-dir", required=True, help="the decoys, one .pdb each")
    parser.add_argument("--true-dir", default=None, help="the natives, under the decoys' names, for the scores")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--checkpoint-dir", default=None, help="a --task ar run's checkpoints: the best is loaded")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-encoder-layers", type=int, default=4)
    parser.add_argument("--k-max", type=int, default=128)
    parser.add_argument("--max-nodes-per-batch", type=int, default=4096)
    parser.add_argument("--max-residues-per-batch", type=int, default=600)
    parser.add_argument("--esm-cache-dir", default=None)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    model = build_model(args.seed, args.device, args.num_encoder_layers, args.checkpoint_dir)
    dm = ARDataModule(
        splits_dir="", af2_dir="", true_dir="", k_max=args.k_max, max_nodes_per_batch=args.max_nodes_per_batch,
        max_residues_per_batch=args.max_residues_per_batch, predict_input_dir=args.input_dir,
        predict_true_dir=args.true_dir, esm_cache_dir=args.esm_cache_dir,
    )
    rows = refine(model, dm, args.output_dir, log=lambda row: print(json.dumps(row), flush=True))
    write_scores(rows, os.path.join(args.output_dir, "scores.csv"))


if __name__ == "__main__":
    main()
