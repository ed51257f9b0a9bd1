"""Train with the port: ``python -m gcpnet_torch.train``.

With overrides (``key=value`` words, ``-m``): the config-driven route of
:mod:`gcpnet_torch.train.entry`, in the JAX entry point's grammar::

    python -m gcpnet_torch.train experiment=gcpnet_psr datamodule.data_dir=data/ATOM3D trainer.max_epochs=10

With ``--task X``: the same route on task X's experiment
(``TASK_EXPERIMENTS``: nms is ``gcpnet_nms_small_20body``), each flag given
turned into an override (:func:`task_overrides`), so that every default is
the experiment's.  It prints one JSON line of metrics per epoch, then the
test metrics of the best checkpoint, and for cpd then the design metrics
of the test chains (``models.cpd_eval.evaluate_cpd``, ``--num-samples``
sequences a chain).  Without ``--checkpoint-dir`` the checkpoints go to a
temporary directory that is removed at the end.

With ``--task lba`` and no ``--data-dir`` (or no argument at all): not an
experiment but the benchmark's training step.  It builds the LBA model at
the width of the JAX package's benchmark (``predict.lba_configs``) from
``--seed``, with float32 master weights, and takes ``--steps`` Adam steps
(``--lr``) on ``--batches`` synthetic LBA batches
(``predict.synthetic_batches``, used in turn), computing in ``--dtype``
(``bf16``: bf16 copies of the masters).  On the card each step is one
replay of a CUDA graph of the step (``train.graphs.TrainSteps``).  It
prints one JSON line per step: step, loss, gradient norm, whether the
update was applied, milliseconds.

The batches are receiver-sorted, so on the card every step runs the sorted
segment sum (K1) and the edge map (K2) forward and the edge map's backward
(K3).  It runs on the card unless ``--device cpu`` (or
``trainer.accelerator=cpu``) is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from gcpnet_torch import tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.predict import DTYPES, lba_configs, synthetic_batches
from gcpnet_torch.train import entry
from gcpnet_torch.train.graphs import TrainSteps
from gcpnet_torch.train.optim import build_optimizer
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import train_step
from gcpnet_torch.train.trainer import Trainer

TASK_EXPERIMENTS = {
    "nms": "gcpnet_nms_small_20body", "rs": "gcpnet_rs", "psr": "gcpnet_psr", "lba": "gcpnet_lba",
    "cpd": "gcpnet_cpd", "eq": "gcpnet_eq", "ar": "gcpnet_ar",
}


def experiment(task: str, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The composed config of ``task``'s experiment with ``overrides``."""
    return compose(CONFIG_DIR, "train.yaml", [f"experiment={TASK_EXPERIMENTS[task]}", *overrides])


def _model_overrides(num_encoder_layers=None, dropout=None, num_decoder_layers=None, autoregressive=None) -> list:
    """Overrides of the model block: ``dropout`` sets every dropout rate
    (the interactions', the head's and the layer config's)."""
    out = []
    if num_encoder_layers is not None:
        out.append(f"model.model_cfg.num_encoder_layers={num_encoder_layers}")
    if num_decoder_layers is not None:
        out.append(f"model.model_cfg.num_decoder_layers={num_decoder_layers}")
    if dropout is not None:
        out += [f"model.model_cfg.{k}={dropout}" for k in ("dropout", "dense_dropout")]
        out.append(f"model.layer_cfg.dropout={dropout}")
    if autoregressive is not None:
        out.append(f"model.autoregressive_decoder={str(bool(autoregressive)).lower()}")
    return out


def task_configs(task: str, num_encoder_layers: Optional[int] = None, dropout: Optional[float] = None,
                 num_decoder_layers: Optional[int] = None) -> Tuple[ModelCfg, ModuleCfg, LayerCfg]:
    """(ModelCfg, ModuleCfg, LayerCfg) of ``task``'s experiment, with the
    depths and every dropout rate replaced where given."""
    block = experiment(task, _model_overrides(num_encoder_layers, dropout, num_decoder_layers))["model"]
    return (ModelCfg.from_dict(block["model_cfg"]), ModuleCfg.from_dict(block["module_cfg"]),
            LayerCfg.from_dict(block["layer_cfg"]))


def build_task_trainer(
    task: str,
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: Optional[int] = None,
    lr: Optional[float] = None,
    dropout: Optional[float] = None,
    num_decoder_layers: Optional[int] = None,
    autoregressive: Optional[bool] = None,
    checkpoint_dir: Optional[str] = None,
    loggers: Sequence = (),
    layer_class: Optional[str] = None,
    **trainer: Any,
) -> Trainer:
    """``task``'s experiment as the training entry point builds it
    (``entry.build_trainer`` of the composed config): its model
    (``tasks.build_model``, the depths, dropout and interaction layer
    ``layer_class`` replaced where given)
    with weights drawn from ``seed`` on ``device`` (``None``: the card), its
    optimizer (``lr`` where given), precision, gradient clipping,
    scheduler, early stopping and checkpoint settings.  ``trainer`` holds
    overrides of the ``trainer`` block (``max_epochs=2``, ``precision=32``,
    ``scan_chunk_size``, ``limit_train_batches``,
    ``accumulate_grad_batches``).  With ``checkpoint_dir`` the checkpoints
    and the fit's ``metrics.csv`` go there; without it no checkpoint is
    written and ``metrics.csv`` goes to the experiment's
    ``paths.output_dir``."""
    overrides = [*_model_overrides(num_encoder_layers, dropout, num_decoder_layers, autoregressive), f"seed={seed}"]
    overrides += [f"trainer.{k}={v}" for k, v in trainer.items()]
    if lr is not None:
        overrides.append(f"model.optimizer.lr={lr}")
    if layer_class is not None:
        overrides.append(f"model.layer_class._target_={layer_class}")
    if checkpoint_dir is not None:
        overrides += [f"paths.output_dir={checkpoint_dir}", f"callbacks.model_checkpoint.dirpath={checkpoint_dir}"]
    cfg = experiment(task, overrides)
    model, name = tasks.build_model(cfg["model"], seed=seed, device=device)
    return entry.build_trainer(cfg, model, tasks.build_loss(name), name, checkpoints=checkpoint_dir is not None,
                               loggers=loggers)


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


class JsonLines:
    """A trainer logger: one JSON line of metrics on standard output."""

    def log_metrics(self, metrics, step=None) -> None:
        print(json.dumps({**metrics, "step": step}), flush=True)


def task_overrides(args: argparse.Namespace, output_dir: str) -> list:
    """The overrides of ``--task``'s flags: the experiment, then each flag
    that was given."""
    out = [f"experiment={TASK_EXPERIMENTS[args.task]}", "extras.print_config=false", f"paths.output_dir={output_dir}"]
    dm = {}
    if args.data_dir is not None:
        if args.task in ("eq", "ar"):
            dirs = {"splits_dir": "splits", "true_dir": "true_model", "model_data_cache_dir": "model_data_cache",
                    **({"decoy_dir": "decoy_model"} if args.task == "eq" else {"af2_dir": "AF2_model"})}
            dm.update({k: os.path.join(args.data_dir, d) for k, d in dirs.items()})
        else:
            dm["data_dir"] = args.data_dir
    if args.task == "nms":
        dm.update({k: v for k, v in (("data_dir", args.data_root), ("data_mode", args.data_mode)) if v is not None})
    if args.task == "lba" and args.lba_split is not None:
        dm["lba_split"] = args.lba_split
    for key in ("batch_size", "num_train", "num_valid", "num_test"):
        if getattr(args, key) is not None and (args.task == "nms" or not key.startswith("num_")):
            dm[key] = getattr(args, key)
    if args.task == "rs":  # the sizes given; the others are the datamodule's
        for split, key in (("train", "num_train"), ("valid", "num_valid"), ("test", "num_test")):
            if getattr(args, key) is not None:
                dm[f"synthetic_sizes.{split}"] = getattr(args, key)
    out += [f"+datamodule.{k}={v}" if k.startswith("synthetic_sizes.") else f"datamodule.{k}={v}" for k, v in dm.items()]
    out += _model_overrides(args.num_encoder_layers, autoregressive=None if args.task != "cpd" else args.autoregressive)
    trainer = {"max_epochs": args.max_epochs, "min_epochs": args.min_epochs, "precision": args.precision,
               "scan_chunk_size": args.scan_chunk_size}
    out += [f"trainer.{k}={v}" for k, v in trainer.items() if v is not None]
    if args.device is not None:
        out.append(f"trainer.accelerator={'cpu' if torch.device(args.device).type == 'cpu' else 'gpu'}")
    if args.lr is not None:
        out.append(f"model.optimizer.lr={args.lr}")
    if args.adaptive_clip:
        out.append("model.module_cfg.clip_gradients=true")
    if args.seed is not None:
        out.append(f"seed={args.seed}")
    out.append(f"callbacks.model_checkpoint.dirpath={args.checkpoint_dir or os.path.join(output_dir, 'checkpoints')}")
    if args.resume:
        out.append(f"ckpt_path={args.checkpoint_dir}")
    return out


def _main_task(args) -> None:
    output_dir = args.output_dir or tempfile.mkdtemp(prefix=f"gcpnet_{args.task}_")
    try:
        cfg = compose(CONFIG_DIR, "train.yaml", task_overrides(args, output_dir))
        _, trainer, dm = entry.train(cfg, loggers=[JsonLines()])
        if args.task == "cpd":
            from gcpnet_torch.models.cpd_eval import evaluate_cpd

            metrics = evaluate_cpd(
                trainer.model, dm.named_graphs("test"), custom_splits=dm.custom_splits,
                num_samples=args.num_samples, max_nodes=dm.max_nodes_per_batch,
                compute_recovery=bool(cfg["model"].get("autoregressive_decoder", False)),
            )
            print(json.dumps(metrics), flush=True)
    finally:
        if args.output_dir is None:
            shutil.rmtree(output_dir, ignore_errors=True)


def _main_lba(args) -> None:
    device = resolve_device(args.device)
    model, state = build_lba_training(
        args.seed, device, DTYPES[args.dtype], lr=args.lr or 1e-4, adaptive_clip=args.adaptive_clip
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


def main(argv: Optional[Sequence[str]] = None):
    """Overrides go to :func:`entry.main`; flags (or none) to ``--task``'s
    route or the benchmark's training step."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and not any(a.startswith("--") and a != "--multirun" for a in argv):
        return entry.main(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", choices=sorted(TASK_EXPERIMENTS), default="lba")
    parser.add_argument("--lr", type=float, default=None, help="default: the experiment's (1e-4)")
    parser.add_argument("--adaptive-clip", action="store_true")
    parser.add_argument("--seed", type=int, default=None, help="default: 0 (lba's bench steps), the experiment's")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    lba = parser.add_argument_group("--task lba without --data-dir")
    lba.add_argument("--steps", type=int, default=6)
    lba.add_argument("--graphs", type=int, default=16)
    lba.add_argument("--nodes", type=int, default=448)
    lba.add_argument("--edges-per-node", type=int, default=28)
    lba.add_argument("--batches", type=int, default=1)
    lba.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    nms = parser.add_argument_group("--task nms")
    nms.add_argument("--data-root", default=None, help="where the simulated splits are cached")
    nms.add_argument("--data-mode", default=None)
    data = parser.add_argument_group("--task psr, cpd, eq and ar, and --task lba with --data-dir")
    data.add_argument("--data-dir", default=None,
                      help="the ATOM3D npz records (psr, lba), the CATH files (cpd), the EQ or AR directories "
                           "(splits/, decoy_model/ or AF2_model/, true_model/, model_data_cache/); default: the "
                           "experiment's datamodule paths")
    data.add_argument("--lba-split", type=int, default=None, help="LBA's sequence-identity split")
    cpd = parser.add_argument_group("--task cpd")
    cpd.add_argument("--autoregressive", action=argparse.BooleanOptionalAction, default=True,
                     help="the autoregressive decoder (the experiment's), or the direct-shot MLP head")
    cpd.add_argument("--num-samples", type=int, default=100, help="sequences sampled a test chain for its recovery")
    fit = parser.add_argument_group("the experiments: every --task but lba without --data-dir; default: the experiment's")
    fit.add_argument("--batch-size", type=int, default=None)
    fit.add_argument("--num-train", type=int, default=None, help="nms: trajectories; rs: synthetic graphs")
    fit.add_argument("--num-valid", type=int, default=None)
    fit.add_argument("--num-test", type=int, default=None)
    fit.add_argument("--num-encoder-layers", type=int, default=None)
    fit.add_argument("--max-epochs", type=int, default=None)
    fit.add_argument("--min-epochs", type=int, default=None)
    fit.add_argument("--checkpoint-dir", default=None)
    fit.add_argument("--output-dir", default=None, help="the run's logs (default: a temporary directory)")
    fit.add_argument("--resume", action="store_true", help="go on from --checkpoint-dir's last checkpoint")
    fit.add_argument("--precision", type=int, choices=(32, 16), default=None, help="16: bf16 over float32 masters")
    fit.add_argument("--scan-chunk-size", type=int, default=None,
                     help="training and validation batches a dispatch (the JAX trainer.scan_chunk_size)")
    args = parser.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        parser.error("--resume needs --checkpoint-dir")
    if args.task == "lba" and args.data_dir is None:
        args.seed = 0 if args.seed is None else args.seed
        _main_lba(args)
        return None
    _main_task(args)
    return None
