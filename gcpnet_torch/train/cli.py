"""Train with the port: ``python -m gcpnet_torch.train [--task lba|nms]``.

``--task lba`` (the default): builds the LBA model at the width of the JAX
package's benchmark (``predict.lba_configs``: hidden 100/16/32/4, 8
interaction layers of 8-layer message stacks, dropout 0.1) from ``--seed``,
with float32 master weights, and takes ``--steps`` Adam steps (``--lr``,
1e-4 as in the benchmark) on ``--batches`` synthetic LBA batches
(``predict.synthetic_batches``, used in turn), computing in ``--dtype``
(``bf16``: bf16 copies of the masters, the benchmark's policy).  Prints one
JSON line per step: step, loss, gradient norm, milliseconds.

``--task nms``: fits the NMS model on simulated Newtonian many-body data
through the :class:`~gcpnet_torch.train.trainer.Trainer`, with the defaults
of the JAX package's experiment ``gcpnet_nms_small_20body`` (hidden
64/16/32/4, 4 interaction layers of 8-layer message stacks, dropout 0.1,
Adam at 1e-4, batches of 100 20-body graphs, 10,000/2,000/2,000
trajectories, at least 100 and at most 12,000 epochs, early stopping after
10 epochs without a better ``val/loss``, the best 30 checkpoints).  The
splits are simulated on the training device and cached under
``--data-root``.  Prints one JSON line per epoch, then the test metrics of
the best checkpoint (of the final weights without ``--checkpoint-dir``).

The batches are receiver-sorted, so on the card every step runs the sorted
segment sum (K1) and the edge map (K2) forward and the edge map's backward
(K3).  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence, Tuple

import torch

from gcpnet_torch import tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.predict import DTYPES, lba_configs, synthetic_batches
from gcpnet_torch.train.optim import build_optimizer
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import train_step
from gcpnet_torch.train.trainer import Trainer


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


def nms_configs(num_encoder_layers: int = 4, dropout: float = 0.1):
    """(ModelCfg, ModuleCfg, LayerCfg) of the NMS model
    (``configs/model/{model_cfg,module_cfg,layer_cfg}/*_nms.yaml``)."""
    model_cfg = ModelCfg(
        h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1,
        h_hidden_dim=64, chi_hidden_dim=16, e_hidden_dim=32, xi_hidden_dim=4,
        num_encoder_layers=num_encoder_layers, dropout=dropout,
    )
    layer_cfg = LayerCfg(dropout=dropout, mp_cfg=MPCfg(num_message_layers=8))
    return model_cfg, ModuleCfg(ablate_x_force_update=True), layer_cfg


def build_nms_trainer(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 4,
    lr: float = 1e-4,
    **trainer_kw,
) -> Trainer:
    """The NMS model with weights drawn from ``seed`` on ``device``
    (``None``: the card) in a :class:`Trainer` with Adam at ``lr``, the
    task's metrics, and the experiment's early stopping and checkpoint
    defaults unless ``trainer_kw`` overrides them."""
    model = GCPNetNMS(
        *nms_configs(num_encoder_layers), generator=torch.Generator().manual_seed(seed), device=device,
    )
    kw = dict(
        monitor="val/loss", early_stopping_patience=10, save_top_k=30, seed=seed,
        collect_fn=tasks.build_collect("GCPNetNMS"), metric_fns=tasks.build_metric_fns("GCPNetNMS"),
    )
    kw.update(trainer_kw)
    return Trainer(model, nms_loss, optimizer_cfg={"_target_": "Adam", "lr": lr}, **kw)


class JsonLines:
    """A trainer logger: one JSON line of metrics on standard output."""

    def log_metrics(self, metrics, step=None) -> None:
        print(json.dumps({**metrics, "step": step}), flush=True)


def _main_nms(args) -> None:
    device = resolve_device(args.device)
    dm = NMSDataModule(
        data_root=args.data_root, data_mode=args.data_mode, batch_size=args.batch_size,
        num_train=args.num_train, num_valid=args.num_valid, num_test=args.num_test, sim_device=device,
    )
    dm.prepare_data()
    dm.setup()
    trainer = build_nms_trainer(
        args.seed, device, num_encoder_layers=args.num_encoder_layers, lr=args.lr,
        max_epochs=args.max_epochs, min_epochs=args.min_epochs, checkpoint_dir=args.checkpoint_dir,
        precision=args.precision, adaptive_clip=args.adaptive_clip, loggers=[JsonLines()],
    )
    trainer.fit(dm, resume=args.resume)
    trainer.restore_best()
    trainer.test(dm)


def _main_lba(args) -> None:
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
        result = train_step(model, state, batches[step % len(batches)], graph_regression_loss, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({
            "step": step, "loss": result.loss.item(), "grad_norm": result.grad_norm.item(),
            "updated": result.ok, "ms": ms,
        }), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", choices=("lba", "nms"), default="lba")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--adaptive-clip", action="store_true")
    parser.add_argument("--seed", type=int, default=None, help="default: 0 (lba), 42 (nms)")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    lba = parser.add_argument_group("--task lba")
    lba.add_argument("--steps", type=int, default=6)
    lba.add_argument("--graphs", type=int, default=16)
    lba.add_argument("--nodes", type=int, default=448)
    lba.add_argument("--edges-per-node", type=int, default=28)
    lba.add_argument("--batches", type=int, default=1)
    lba.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    nms = parser.add_argument_group("--task nms")
    nms.add_argument("--data-root", default="data/NMS")
    nms.add_argument("--data-mode", default="small_20body")
    nms.add_argument("--batch-size", type=int, default=100)
    nms.add_argument("--num-train", type=int, default=None, help="default: 10,000")
    nms.add_argument("--num-valid", type=int, default=None, help="default: 2,000")
    nms.add_argument("--num-test", type=int, default=None, help="default: 2,000")
    nms.add_argument("--num-encoder-layers", type=int, default=4)
    nms.add_argument("--max-epochs", type=int, default=12000)
    nms.add_argument("--min-epochs", type=int, default=100)
    nms.add_argument("--checkpoint-dir", default=None)
    nms.add_argument("--resume", action="store_true", help="go on from --checkpoint-dir's last checkpoint")
    nms.add_argument("--precision", type=int, choices=(32, 16), default=32)
    args = parser.parse_args(argv)
    if args.seed is None:
        args.seed = 0 if args.task == "lba" else 42
    (_main_nms if args.task == "nms" else _main_lba)(args)
