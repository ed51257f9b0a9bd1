"""Train with the port: ``python -m gcpnet_torch.train [--task lba|nms|rs]``.

``--task lba`` (the default): builds the LBA model at the width of the JAX
package's benchmark (``predict.lba_configs``: hidden 100/16/32/4, 8
interaction layers of 8-layer message stacks, dropout 0.1) from ``--seed``,
with float32 master weights, and takes ``--steps`` Adam steps (``--lr``,
1e-4 as in the benchmark) on ``--batches`` synthetic LBA batches
(``predict.synthetic_batches``, used in turn), computing in ``--dtype``
(``bf16``: bf16 copies of the masters, the benchmark's policy).  On the
card each step is one replay of a CUDA graph of the step
(``train.graphs.TrainSteps``).  Prints one JSON line per step: step, loss,
gradient norm, whether the update was applied, milliseconds.

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

``--task rs``: fits the RS chirality classifier on synthetic enantiomer
pairs (``data.rs``: 4,096 / 512 / 512 graphs, or ``--num-train``,
``--num-valid`` and ``--num-test``) with the defaults of the JAX package's
experiment ``gcpnet_rs`` (hidden 100/16/32/4, 8 interaction layers of 8-layer message
stacks with leaky relu, dropout 0.1, Adam at 1e-4, seed 42, batches of 64
anchors each paired with its opposite enantiomer, at least 1 and at most
1,000 epochs, early stopping after 10 epochs without a better
``val/loss``, the best 30 checkpoints), printing as ``--task nms`` does;
its metrics are ``Accuracy`` and ``F1``.  ``--scan-chunk-size k`` (the JAX
trainer's ``trainer.scan_chunk_size``) runs each k training or validation
batches in one dispatch: on the card one replay of a CUDA graph of k steps.

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
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch.predict import DTYPES, lba_configs, synthetic_batches
from gcpnet_torch.train.graphs import TrainSteps
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


def rs_configs(num_encoder_layers: int = 8, dropout: float = 0.1):
    """(ModelCfg, ModuleCfg, LayerCfg) of the RS model
    (``configs/model/{model_cfg,module_cfg,layer_cfg}/*_rs.yaml``): LBA's
    widths with 52 float node scalars, 30 edge scalars and leaky relu."""
    model_cfg = ModelCfg(
        h_input_dim=52, chi_input_dim=2, e_input_dim=30, xi_input_dim=1,
        h_hidden_dim=100, chi_hidden_dim=16, e_hidden_dim=32, xi_hidden_dim=4,
        num_encoder_layers=num_encoder_layers, dropout=dropout, dense_dropout=dropout,
    )
    layer_cfg = LayerCfg(dropout=dropout, mp_cfg=MPCfg(num_message_layers=8))
    return model_cfg, ModuleCfg(scalar_nonlinearity="leakyrelu"), layer_cfg


def _task_trainer(model, loss_fn, model_name: str, seed: int, lr: float, trainer_kw) -> Trainer:
    """``model`` in a :class:`Trainer` with Adam at ``lr``, the task's
    metrics, and the experiments' early stopping and checkpoint defaults
    unless ``trainer_kw`` overrides them."""
    kw = dict(
        monitor="val/loss", early_stopping_patience=10, save_top_k=30, seed=seed,
        collect_fn=tasks.build_collect(model_name), metric_fns=tasks.build_metric_fns(model_name),
    )
    kw.update(trainer_kw)
    return Trainer(model, loss_fn, optimizer_cfg={"_target_": "Adam", "lr": lr}, **kw)


def build_nms_trainer(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 4,
    lr: float = 1e-4,
    **trainer_kw,
) -> Trainer:
    """The NMS model with weights drawn from ``seed`` on ``device``
    (``None``: the card) in a :class:`Trainer` (:func:`_task_trainer`)."""
    model = GCPNetNMS(
        *nms_configs(num_encoder_layers), generator=torch.Generator().manual_seed(seed), device=device,
    )
    return _task_trainer(model, nms_loss, "GCPNetNMS", seed, lr, trainer_kw)


def build_rs_trainer(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 8,
    lr: float = 1e-4,
    **trainer_kw,
) -> Trainer:
    """The RS model with weights drawn from ``seed`` on ``device``
    (``None``: the card) in a :class:`Trainer` (:func:`_task_trainer`)."""
    model = GCPNetRS(
        *rs_configs(num_encoder_layers), generator=torch.Generator().manual_seed(seed), device=device,
    )
    return _task_trainer(model, rs_loss, "GCPNetRS", seed, lr, trainer_kw)


class JsonLines:
    """A trainer logger: one JSON line of metrics on standard output."""

    def log_metrics(self, metrics, step=None) -> None:
        print(json.dumps({**metrics, "step": step}), flush=True)


# per task: the experiment's batch size, encoder depth and epoch bounds
FIT_DEFAULTS = {
    "nms": dict(batch_size=100, num_encoder_layers=4, min_epochs=100, max_epochs=12000),
    "rs": dict(batch_size=64, num_encoder_layers=8, min_epochs=1, max_epochs=1000),
}


def _main_fit(args) -> None:
    device = resolve_device(args.device)
    if args.task == "nms":
        dm = NMSDataModule(
            data_root=args.data_root, data_mode=args.data_mode, batch_size=args.batch_size,
            num_train=args.num_train, num_valid=args.num_valid, num_test=args.num_test, sim_device=device,
        )
        build = build_nms_trainer
    else:
        sizes = {"train": args.num_train or 4096, "valid": args.num_valid or 512, "test": args.num_test or 512}
        dm = RSDataModule(seed=args.seed, batch_size=args.batch_size, synthetic_sizes=sizes)
        build = build_rs_trainer
    dm.prepare_data()
    dm.setup()
    trainer = build(
        args.seed, device, num_encoder_layers=args.num_encoder_layers, lr=args.lr,
        max_epochs=args.max_epochs, min_epochs=args.min_epochs, checkpoint_dir=args.checkpoint_dir,
        precision=args.precision, adaptive_clip=args.adaptive_clip, loggers=[JsonLines()],
        scan_chunk_size=args.scan_chunk_size,
    )
    trainer.fit(dm, resume=args.resume)
    trainer.restore_best()
    trainer.test(dm)


def _main_lba(args) -> None:
    device = resolve_device(args.device)
    model, state = build_lba_training(
        args.seed, device, DTYPES[args.dtype], lr=args.lr, adaptive_clip=args.adaptive_clip
    )
    host = synthetic_batches(args.batches, args.graphs, args.nodes, args.edges_per_node, args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        steps = TrainSteps(model, state, graph_regression_loss, generator)
        batches = [b.pinned() for b in host]
        run = lambda batch: steps([batch])  # noqa: E731
    else:
        batches = [b.to(device) for b in host]
        run = lambda batch: train_step(model, state, batch, graph_regression_loss, generator)  # noqa: E731
    for step in range(args.steps):
        t0 = time.perf_counter()
        result = run(batches[step % len(batches)])
        # the line's own reads of the step's results wait for it
        line = {"step": step, "loss": result.loss.item(), "grad_norm": result.grad_norm.item(),
                "updated": bool(result.ok.item())}
        print(json.dumps({**line, "ms": (time.perf_counter() - t0) * 1e3}), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", choices=("lba", "nms", "rs"), default="lba")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--adaptive-clip", action="store_true")
    parser.add_argument("--seed", type=int, default=None, help="default: 0 (lba), 42 (nms, rs)")
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
    fit = parser.add_argument_group("--task nms and --task rs")
    fit.add_argument("--batch-size", type=int, default=None, help="default: 100 (nms), 64 anchors (rs)")
    fit.add_argument("--num-train", type=int, default=None, help="default: 10,000 (nms), 4,096 (rs)")
    fit.add_argument("--num-valid", type=int, default=None, help="default: 2,000 (nms), 512 (rs)")
    fit.add_argument("--num-test", type=int, default=None, help="default: 2,000 (nms), 512 (rs)")
    fit.add_argument("--num-encoder-layers", type=int, default=None, help="default: 4 (nms), 8 (rs)")
    fit.add_argument("--max-epochs", type=int, default=None, help="default: 12,000 (nms), 1,000 (rs)")
    fit.add_argument("--min-epochs", type=int, default=None, help="default: 100 (nms), 1 (rs)")
    fit.add_argument("--checkpoint-dir", default=None)
    fit.add_argument("--resume", action="store_true", help="go on from --checkpoint-dir's last checkpoint")
    fit.add_argument("--precision", type=int, choices=(32, 16), default=32)
    fit.add_argument("--scan-chunk-size", type=int, default=1,
                     help="training and validation batches a dispatch (the JAX trainer.scan_chunk_size)")
    args = parser.parse_args(argv)
    if args.seed is None:
        args.seed = 0 if args.task == "lba" else 42
    if args.task == "lba":
        _main_lba(args)
        return
    for key, value in FIT_DEFAULTS[args.task].items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    _main_fit(args)
