"""Train the LBA model with the port: ``python -m gcpnet_torch.train``.

Builds the LBA model at the width of the JAX package's benchmark
(``predict.lba_configs``: hidden 100/16/32/4, 8 interaction layers of
8-layer message stacks, dropout 0.1) from ``--seed``, with float32 master
weights, and takes ``--steps`` Adam steps (``--lr``, 1e-4 as in the
benchmark) on ``--batches`` synthetic LBA batches
(``predict.synthetic_batches``, used in turn), computing in ``--dtype``
(``bf16``: bf16 copies of the masters, the benchmark's policy).  Prints one
JSON line per step: step, loss, gradient norm, milliseconds.  The batches
are receiver-sorted, so on the card every step runs the sorted segment sum
(K1) and the edge map (K2) forward and the edge map's backward (K3).  It
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence, Tuple

import torch

from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.predict import DTYPES, lba_configs, synthetic_batches
from gcpnet_torch.train.optim import build_optimizer
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import train_step


def build_lba_training(
    seed: int,
    device: DeviceLike = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    lr: float = 1e-4,
    dropout: float = 0.1,
    adaptive_clip: bool = False,
    num_encoder_layers: Optional[int] = None,
) -> Tuple[GCPNetLBA, TrainState]:
    """The benchmark's LBA model with float32 weights drawn from ``seed``
    on ``device`` (``None``: the card), and a train state with Adam at
    ``lr``.  ``dropout`` sets the interaction and head dropout rates."""
    device = resolve_device(device)
    model_cfg, module_cfg, layer_cfg = lba_configs()
    model_cfg = model_cfg.replace(dropout=dropout, dense_dropout=dropout)
    if num_encoder_layers is not None:
        model_cfg = model_cfg.replace(num_encoder_layers=num_encoder_layers)
    model = GCPNetLBA(
        model_cfg, module_cfg, layer_cfg, num_atom_types=9,
        generator=torch.Generator().manual_seed(seed), device=device,
    ).train()
    optimizer = build_optimizer(model.parameters(), {"_target_": "Adam", "lr": lr})
    ring = GradNormRing(device=device) if adaptive_clip else None
    return model, TrainState(optimizer, ring=ring, compute_dtype=compute_dtype)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--graphs", type=int, default=16)
    parser.add_argument("--nodes", type=int, default=448)
    parser.add_argument("--edges-per-node", type=int, default=28)
    parser.add_argument("--batches", type=int, default=1)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--adaptive-clip", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model, state = build_lba_training(
        args.seed, device, DTYPES[args.dtype], lr=args.lr, adaptive_clip=args.adaptive_clip
    )
    batches = [
        b.to(device)
        for b in synthetic_batches(args.batches, args.graphs, args.nodes, args.edges_per_node, args.seed)
    ]
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for step in range(args.steps):
        t0 = time.perf_counter()
        result = train_step(model, state, batches[step % len(batches)], generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({
            "step": step, "loss": result.loss.item(), "grad_norm": result.grad_norm.item(),
            "updated": result.ok, "ms": ms,
        }), flush=True)
