"""Train with the port: ``python -m gcpnet_torch.train [--task lba|psr|nms|rs|cpd|eq|ar]``.

``--task lba`` (the default) without ``--data-dir``: builds the LBA model
at the width of the JAX package's benchmark (``predict.lba_configs``:
hidden 100/16/32/4, 8 interaction layers of 8-layer message stacks, dropout
0.1) from ``--seed``, with float32 master weights, and takes ``--steps``
Adam steps (``--lr``, 1e-4 as in the benchmark) on ``--batches`` synthetic
LBA batches (``predict.synthetic_batches``, used in turn), computing in
``--dtype`` (``bf16``: bf16 copies of the masters, the benchmark's policy).
On the card each step is one replay of a CUDA graph of the step
(``train.graphs.TrainSteps``).  Prints one JSON line per step: step, loss,
gradient norm, whether the update was applied, milliseconds.

``--task psr``: fits the PSR structure-ranking model on ATOM3D records
(``data.atom3d``: the npz record directories that
``scripts/convert_atom3d_to_npz.py`` writes, under ``--data-dir``, by default
``data/ATOM3D``) through the :class:`~gcpnet_torch.train.trainer.Trainer`,
with the defaults of the JAX package's experiment ``gcpnet_psr`` (hidden
100/16/32/4, 5 interaction layers of 8-layer message stacks, dropout 0.1,
Adam at 1e-4, seed 42, batches of 16 graphs in a bucket of 16,384 nodes and
524,288 edge rows, at least 1 and at most 1,000 epochs, early stopping after
10 epochs without a better ``val/loss``, the best 30 checkpoints, bf16
compute over float32 masters as the JAX trainer's ``precision: 16``); its
metrics are RMSE, Pearson and Spearman, and the per-target (``local_*``)
and global Pearson, Spearman and Kendall correlations.  ``--task lba
--data-dir D`` fits LBA on ATOM3D records the same way (``gcpnet_lba``: 8
interaction layers; ``--lba-split``, 30 by default).

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

``--task cpd``: fits the CPD protein-design model on CATH chains
(``data.cath``: ``chain_set.jsonl``, ``chain_set_splits.json`` and the
``short`` and ``single_chain`` test subsets under ``--data-dir``, by
default ``data/CATH``; nothing is downloaded) with the defaults of the JAX
package's experiment ``gcpnet_cpd`` (hidden 100/16/32/4, 9 encoder layers
and 3 autoregressive decoder layers of 8-layer message stacks, or the
direct-shot MLP head with ``--no-autoregressive``, dropout 0.2, Adam at
1e-4 with weight decay 1e-8, gradients accumulated over 4 batches, seed
42, batches of 8 chains in a bucket of 2,048 nodes and 61,440 edge rows,
at least 1 and at most 1,000 epochs, early stopping after 10 epochs
without a better ``val/loss``, the best 30 checkpoints, bf16 over float32
masters); its metric is ``recovery_argmax``.  After the test of the best
checkpoint it prints the JAX ``eval.py``'s CPD metrics of the test chains
(``models.cpd_eval.evaluate_cpd``: median perplexity, and with the
autoregressive decoder the median recovery of ``--num-samples`` sequences
sampled at temperature 0.1, for all chains, ``short`` and
``single_chain``).

``--task eq``: fits the EQ structure-quality model (per-residue lDDT) on
decoy and native PDBs (``data.eq``: ``splits/``, ``decoy_model/``,
``true_model/`` and the ESM cache ``model_data_cache/esm/`` under
``--data-dir``, by default ``data/EQ``; ``data.eq_synthetic`` writes a
synthetic set in that layout) with the defaults of the JAX package's
experiment ``gcpnet_eq`` (hidden 100/16/32/4, 1,281 + 38 atom-type node
scalars, 5 ``GCPInteractions2`` layers of 8-layer message stacks of GCP3
with scalar message attention and sender-keyed sums, dropout 0.1, Adam at
1e-4 without weight decay, seed 42, one decoy a batch in a bucket of
8,192 nodes, 262,144 edge rows and 1,100 residues, at least 1 and at most
1,000 epochs, early stopping after 10 epochs without a better
``val/loss``, the best 30 checkpoints, bf16 over float32 masters); its
metrics are RMSE and Pearson over the residues.

``--task ar``: fits the AR all-atom refinement model on AF2 decoy and
native PDB pairs (``data.ar``: ``splits/``, ``AF2_model/``,
``true_model/`` and the ESM cache ``model_data_cache/esm/`` under
``--data-dir``, by default ``data/AR``; ``data.ar_synthetic`` writes a
synthetic set in that layout) with the defaults of the JAX package's
experiment ``gcpnet_ar`` (hidden 100/32/16/4, 1,338 node scalars and 29
edge scalars, 4 ``GCPInteractions2`` layers with the position update, of
4-layer message stacks of GCP3 with silu on scalars and vectors, scalar
message attention and sender-keyed sums, dropout 0, Adam at 1e-4 without a
scheduler, seed 42, one decoy a batch in a bucket of 4,096 nodes, 622,592
edge rows and 600 residues, a 250-residue training crop, at least 1 and
at most 1,000 epochs, early stopping after 10 epochs without a better
``val/loss``, the best 30 checkpoints, bf16 over float32 masters); its
metric is the RMSE of the atom positions.  ``python -m
gcpnet_torch.predict_ar`` refines decoys with a trained model.

The batches are receiver-sorted, so on the card every step runs the sorted
segment sum (K1) and the edge map (K2) forward and the edge map's backward
(K3).  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Optional, Sequence, Tuple

import torch

from gcpnet_torch import tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.ar import ARDataModule
from gcpnet_torch.data.atom3d import ATOM3DDataModule
from gcpnet_torch.data.cath import CATHDataModule
from gcpnet_torch.data.eq import EQDataModule
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.device import DeviceLike, resolve_device
from gcpnet_torch.models.ar import GCPNetAR, ar_loss
from gcpnet_torch.models.cpd import GCPNetCPD, cpd_loss
from gcpnet_torch.models.cpd_eval import evaluate_cpd
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.models.lba import GCPNetLBA, GCPNetPSR, graph_regression_loss
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


def cpd_configs(num_encoder_layers: int = 9, num_decoder_layers: int = 3, dropout: float = 0.2):
    """(ModelCfg, ModuleCfg, LayerCfg) of the CPD model
    (``configs/model/{model_cfg,module_cfg,layer_cfg}/*_cpd.yaml``, the
    experiment's dropout 0.2): LBA's widths, a vocabulary of 20."""
    model_cfg = ModelCfg(
        chi_input_dim=2, e_input_dim=16, xi_input_dim=1,
        h_hidden_dim=100, chi_hidden_dim=16, e_hidden_dim=32, xi_hidden_dim=4,
        num_encoder_layers=num_encoder_layers, num_decoder_layers=num_decoder_layers, output_dim=20,
        dropout=dropout, decoder_residual_updates=True,
    )
    return model_cfg, ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=8))


def eq_configs(num_encoder_layers: int = 5, dropout: float = 0.1):
    """(ModelCfg, ModuleCfg, LayerCfg) of the EQ model
    (``configs/model/{model_cfg,module_cfg,layer_cfg}/*_eq.yaml``): GCP3,
    1,281 node scalars (ESM-2 and plDDT), 18 edge scalars, scalar message
    attention, sums over senders, one feed-forward GCP."""
    model_cfg = ModelCfg(
        h_input_dim=1281, chi_input_dim=2, e_input_dim=18, xi_input_dim=1,
        h_hidden_dim=100, chi_hidden_dim=16, e_hidden_dim=32, xi_hidden_dim=4,
        num_encoder_layers=num_encoder_layers, dropout=dropout, dense_dropout=dropout,
    )
    layer_cfg = LayerCfg(
        pre_norm=False, num_feedforward_layers=1, dropout=dropout, use_scalar_message_attention=True,
        aggregate_with_row=True, mp_cfg=MPCfg(num_message_layers=8),
    )
    return model_cfg, ModuleCfg(selected_gcp="GCP3"), layer_cfg


def ar_configs(num_encoder_layers: int = 4, dropout: float = 0.0):
    """(ModelCfg, ModuleCfg, LayerCfg) of the AR model
    (``configs/model/{model_cfg,module_cfg,layer_cfg}/*_ar.yaml``): GCP3,
    1,338 node scalars (residue and atom-name one-hots, ESM-2), 29 edge
    scalars, hidden 100/32/16/4, silu on scalars and vectors with the
    vector gate, scalar message attention, sums over senders, one
    feed-forward GCP, 4-layer message stacks."""
    model_cfg = ModelCfg(
        h_input_dim=1338, chi_input_dim=2, e_input_dim=29, xi_input_dim=1,
        h_hidden_dim=100, chi_hidden_dim=32, e_hidden_dim=16, xi_hidden_dim=4,
        num_encoder_layers=num_encoder_layers, dropout=dropout,
    )
    layer_cfg = LayerCfg(
        pre_norm=False, num_feedforward_layers=1, dropout=dropout, use_scalar_message_attention=True,
        aggregate_with_row=True, mp_cfg=MPCfg(num_message_layers=4),
    )
    module_cfg = ModuleCfg(selected_gcp="GCP3", scalar_nonlinearity="silu", vector_nonlinearity="silu")
    return model_cfg, module_cfg, layer_cfg


# the CPD experiment's optimizer (configs/model/gcpnet_cpd.yaml) and its
# trainer's accumulate_grad_batches (configs/experiment/gcpnet_cpd.yaml)
CPD_WEIGHT_DECAY, CPD_ACCUMULATE = 1e-8, 4


def _task_trainer(model, loss_fn, model_name: str, seed: int, lr: float, trainer_kw, **optimizer) -> Trainer:
    """``model`` in a :class:`Trainer` with Adam at ``lr`` (and ``optimizer``'s
    other settings), the task's metrics, and the experiments' early stopping
    and checkpoint defaults unless ``trainer_kw`` overrides them."""
    kw = dict(
        monitor="val/loss", early_stopping_patience=10, save_top_k=30, seed=seed,
        collect_fn=tasks.build_collect(model_name), metric_fns=tasks.build_metric_fns(model_name),
    )
    kw.update(trainer_kw)
    return Trainer(model, loss_fn, optimizer_cfg={"_target_": "Adam", "lr": lr, **optimizer}, **kw)


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


def build_atom3d_trainer(
    task: str,
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: Optional[int] = None,
    lr: float = 1e-4,
    dropout: float = 0.1,
    **trainer_kw,
) -> Trainer:
    """The PSR (``task="psr"``) or LBA (``"lba"``) model of the JAX package's
    experiments at their widths (``predict.lba_configs``), with 5 or 8
    interaction layers unless ``num_encoder_layers`` says otherwise and
    dropout ``dropout``, weights drawn from ``seed`` on ``device`` (``None``:
    the card), in a :class:`Trainer` (:func:`_task_trainer`) with the task's
    metrics."""
    model_cfg, module_cfg, layer_cfg = lba_configs()
    layers = num_encoder_layers or FIT_DEFAULTS[task]["num_encoder_layers"]
    model_cfg = model_cfg.replace(num_encoder_layers=layers, dropout=dropout, dense_dropout=dropout)
    model_cls, name = (GCPNetPSR, "GCPNetPSR") if task == "psr" else (GCPNetLBA, "GCPNetLBA")
    model = model_cls(
        model_cfg, module_cfg, layer_cfg.replace(dropout=dropout), num_atom_types=9,
        generator=torch.Generator().manual_seed(seed), device=device,
    )
    return _task_trainer(model, graph_regression_loss, name, seed, lr, trainer_kw)


def build_cpd_trainer(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 9,
    lr: float = 1e-4,
    autoregressive: bool = True,
    dropout: float = 0.2,
    num_decoder_layers: int = 3,
    accumulate_grad_batches: int = CPD_ACCUMULATE,
    **trainer_kw,
) -> Trainer:
    """The CPD model of the experiment ``gcpnet_cpd`` (:func:`cpd_configs`,
    the autoregressive decoder unless ``autoregressive`` is false) with
    weights drawn from ``seed`` on ``device`` (``None``: the card), in a
    :class:`Trainer` (:func:`_task_trainer`) with Adam at ``lr``, weight
    decay 1e-8 and ``accumulate_grad_batches``."""
    model = GCPNetCPD(
        *cpd_configs(num_encoder_layers, num_decoder_layers, dropout), autoregressive_decoder=autoregressive,
        generator=torch.Generator().manual_seed(seed), device=device,
    )
    return _task_trainer(
        model, cpd_loss, "GCPNetCPD", seed, lr, trainer_kw,
        weight_decay=CPD_WEIGHT_DECAY, accumulate_grad_batches=accumulate_grad_batches,
    )


def build_eq_trainer(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 5,
    lr: float = 1e-4,
    dropout: float = 0.1,
    **trainer_kw,
) -> Trainer:
    """The EQ model of the experiment ``gcpnet_eq`` (:func:`eq_configs`) with
    weights drawn from ``seed`` on ``device`` (``None``: the card), in a
    :class:`Trainer` (:func:`_task_trainer`) with Adam at ``lr``."""
    model = GCPNetEQ(
        *eq_configs(num_encoder_layers, dropout), generator=torch.Generator().manual_seed(seed), device=device,
    )
    return _task_trainer(model, eq_loss, "GCPNetEQ", seed, lr, trainer_kw)


def build_ar_trainer(
    seed: int = 42,
    device: DeviceLike = None,
    num_encoder_layers: int = 4,
    lr: float = 1e-4,
    dropout: float = 0.0,
    **trainer_kw,
) -> Trainer:
    """The AR model of the experiment ``gcpnet_ar`` (:func:`ar_configs`) with
    weights drawn from ``seed`` on ``device`` (``None``: the card), in a
    :class:`Trainer` (:func:`_task_trainer`) with Adam at ``lr``."""
    model = GCPNetAR(
        *ar_configs(num_encoder_layers, dropout), generator=torch.Generator().manual_seed(seed), device=device,
    )
    return _task_trainer(model, ar_loss, "GCPNetAR", seed, lr, trainer_kw)


class JsonLines:
    """A trainer logger: one JSON line of metrics on standard output."""

    def log_metrics(self, metrics, step=None) -> None:
        print(json.dumps({**metrics, "step": step}), flush=True)


# per task: the experiment's batch size, encoder depth, epoch bounds and
# precision (the ATOM3D experiments take configs/trainer/default.yaml's 16)
FIT_DEFAULTS = {
    "nms": dict(batch_size=100, num_encoder_layers=4, min_epochs=100, max_epochs=12000, precision=32),
    "rs": dict(batch_size=64, num_encoder_layers=8, min_epochs=1, max_epochs=1000, precision=32),
    "psr": dict(batch_size=16, num_encoder_layers=5, min_epochs=1, max_epochs=1000, precision=16),
    "lba": dict(batch_size=16, num_encoder_layers=8, min_epochs=1, max_epochs=1000, precision=16),
    "cpd": dict(batch_size=8, num_encoder_layers=9, min_epochs=1, max_epochs=1000, precision=16),
    "eq": dict(batch_size=1, num_encoder_layers=5, min_epochs=1, max_epochs=1000, precision=16),
    "ar": dict(batch_size=1, num_encoder_layers=4, min_epochs=1, max_epochs=1000, precision=16),
}


def _main_fit(args) -> None:
    device = resolve_device(args.device)
    if args.task == "nms":
        dm = NMSDataModule(
            data_root=args.data_root, data_mode=args.data_mode, batch_size=args.batch_size,
            num_train=args.num_train, num_valid=args.num_valid, num_test=args.num_test, sim_device=device,
        )
        build = build_nms_trainer
    elif args.task in ("psr", "lba"):
        dm = ATOM3DDataModule(
            task=args.task, data_dir=args.data_dir or "data/ATOM3D", lba_split=args.lba_split,
            batch_size=args.batch_size,
        )
        build = functools.partial(build_atom3d_trainer, args.task)
    elif args.task == "cpd":
        dm = CATHDataModule(data_dir=args.data_dir or "data/CATH", batch_size=args.batch_size)
        build = functools.partial(build_cpd_trainer, autoregressive=args.autoregressive)
    elif args.task == "eq":
        dm = EQDataModule.from_data_dir(args.data_dir or "data/EQ", batch_size=args.batch_size)
        build = build_eq_trainer
    elif args.task == "ar":
        dm = ARDataModule.from_data_dir(args.data_dir or "data/AR", batch_size=args.batch_size)
        build = build_ar_trainer
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
    if args.task == "cpd":
        metrics = evaluate_cpd(
            trainer.model, dm.named_graphs("test"), custom_splits=dm.custom_splits,
            num_samples=args.num_samples, max_nodes=dm.max_nodes_per_batch, compute_recovery=args.autoregressive,
        )
        print(json.dumps(metrics), flush=True)


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
    parser.add_argument("--task", choices=("lba", "psr", "nms", "rs", "cpd", "eq", "ar"), default="lba")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--adaptive-clip", action="store_true")
    parser.add_argument("--seed", type=int, default=None, help="default: 0 (lba's bench steps), 42 (the fits)")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    lba = parser.add_argument_group("--task lba without --data-dir")
    lba.add_argument("--steps", type=int, default=6)
    lba.add_argument("--graphs", type=int, default=16)
    lba.add_argument("--nodes", type=int, default=448)
    lba.add_argument("--edges-per-node", type=int, default=28)
    lba.add_argument("--batches", type=int, default=1)
    lba.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    nms = parser.add_argument_group("--task nms")
    nms.add_argument("--data-root", default="data/NMS")
    nms.add_argument("--data-mode", default="small_20body")
    atom3d = parser.add_argument_group("--task psr, cpd, eq and ar, and --task lba with --data-dir")
    atom3d.add_argument("--data-dir", default=None,
                        help="the ATOM3D npz records (psr: default data/ATOM3D), the CATH files (cpd: data/CATH), "
                             "the EQ directories (eq: data/EQ), or the AR directories (ar: data/AR)")
    atom3d.add_argument("--lba-split", type=int, default=30, help="LBA's sequence-identity split")
    cpd = parser.add_argument_group("--task cpd")
    cpd.add_argument("--autoregressive", action=argparse.BooleanOptionalAction, default=True,
                     help="the autoregressive decoder (the experiment's), or the direct-shot MLP head")
    cpd.add_argument("--num-samples", type=int, default=100, help="sequences sampled a test chain for its recovery")
    fit = parser.add_argument_group("the fits: --task nms, rs, psr, cpd, eq, ar, and lba with --data-dir")
    fit.add_argument("--batch-size", type=int, default=None,
                     help="default: 100 (nms), 64 anchors (rs), 16 (psr, lba), 8 (cpd), 1 (eq, ar)")
    fit.add_argument("--num-train", type=int, default=None, help="default: 10,000 (nms), 4,096 (rs)")
    fit.add_argument("--num-valid", type=int, default=None, help="default: 2,000 (nms), 512 (rs)")
    fit.add_argument("--num-test", type=int, default=None, help="default: 2,000 (nms), 512 (rs)")
    fit.add_argument("--num-encoder-layers", type=int, default=None,
                     help="default: 4 (nms, ar), 8 (rs, lba), 5 (psr, eq), 9 (cpd)")
    fit.add_argument("--max-epochs", type=int, default=None,
                     help="default: 12,000 (nms), 1,000 (rs, psr, lba, cpd, eq, ar)")
    fit.add_argument("--min-epochs", type=int, default=None, help="default: 100 (nms), 1 (rs, psr, lba, cpd, eq, ar)")
    fit.add_argument("--checkpoint-dir", default=None)
    fit.add_argument("--resume", action="store_true", help="go on from --checkpoint-dir's last checkpoint")
    fit.add_argument("--precision", type=int, choices=(32, 16), default=None,
                     help="default: 32 (nms, rs), 16 (psr, lba, cpd, eq, ar): bf16 over float32 masters")
    fit.add_argument("--scan-chunk-size", type=int, default=1,
                     help="training and validation batches a dispatch (the JAX trainer.scan_chunk_size)")
    args = parser.parse_args(argv)
    bench_steps = args.task == "lba" and args.data_dir is None
    if args.seed is None:
        args.seed = 0 if bench_steps else 42
    if bench_steps:
        _main_lba(args)
        return
    for key, value in FIT_DEFAULTS[args.task].items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    _main_fit(args)
