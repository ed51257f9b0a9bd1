"""Refine protein decoys with the port's AR model: ``python -m
gcpnet_torch.predict_ar --input-dir D --output-dir O --checkpoint-dir C``.

An alias of the composed prediction route (``gcpnet_torch.predict``) with
``model=gcpnet_ar datamodule=ar``: each flag becomes an override, and the
score rows go to ``O/scores.csv``.  Every ``.pdb`` of ``--input-dir`` runs
through the windowed prediction path of ``data.ar.ARDataModule`` (a decoy
of 1,500 residues or more in 900-residue windows shifted by 850, one batch
a window); each decoy's refined PDB, stitched from its windows, goes to
``--output-dir`` under its own name; with ``--true-dir`` its row holds
TM-score, GDT-TS, GDT-HA, MaxSub, RMSD and lDDT against the native.  It
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from gcpnet_torch import predict


def overrides(args: argparse.Namespace) -> list:
    """The composed route's overrides of the alias's flags."""
    out = [
        "model=gcpnet_ar", "datamodule=ar", "extras.print_config=false",
        f"datamodule.predict_input_dir={args.input_dir}",
        f"datamodule.predict_true_dir={args.true_dir or 'null'}",
        f"datamodule.predict_output_dir={args.output_dir}",
        f"predictions_csv_path={os.path.join(args.output_dir, 'scores.csv')}",
        f"paths.output_dir={args.output_dir}",
        f"ckpt_path={args.checkpoint_dir}",
        f"model.model_cfg.num_encoder_layers={args.num_encoder_layers}",
        f"datamodule.k_max={args.k_max}",
        f"+datamodule.max_nodes_per_batch={args.max_nodes_per_batch}",
        f"+datamodule.max_residues_per_batch={args.max_residues_per_batch}",
    ]
    if args.esm_cache_dir:
        out.append(f"+datamodule.esm_cache_dir={args.esm_cache_dir}")
    if args.device is not None:
        out.append(f"trainer.accelerator={'cpu' if args.device == 'cpu' else 'gpu'}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input-dir", required=True, help="the decoys, one .pdb each")
    parser.add_argument("--true-dir", default=None, help="the natives, under the decoys' names, for the scores")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--checkpoint-dir", required=True, help="a training run's checkpoints: the best is loaded")
    parser.add_argument("--num-encoder-layers", type=int, default=4)
    parser.add_argument("--k-max", type=int, default=128)
    parser.add_argument("--max-nodes-per-batch", type=int, default=4096)
    parser.add_argument("--max-residues-per-batch", type=int, default=600)
    parser.add_argument("--esm-cache-dir", default=None)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    return predict.main(overrides(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
