"""What the data-parallel tests run in each process that
``gcpnet_torch.parallel.launch`` starts (gloo on the CPU).  It imports no
JAX, so each process starts in a few seconds; the tests hand it numpy
weights and graphs made by the JAX side and compare what rank 0 returns.
Every process runs on one torch thread."""

from __future__ import annotations

import torch

from gcpnet_torch import parallel, tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.ar import globalize_ar_residues
from gcpnet_torch.data.batching import Bucket, Shards, batches_from_dataset
from gcpnet_torch.data.eq import globalize_residues
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.ar import GCPNetAR, ar_loss
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.train.graphs import TrainSteps
from gcpnet_torch.train.step import train_step
from gcpnet_torch.train.trainer import Trainer
from gcpnet_torch.weights import from_jax_params

OPTIMIZER = {"_target_": "Adam", "lr": 1e-3}
NMS_SPLITS = dict(data_mode="small", num_train=32, num_valid=16, num_test=16)
NMS_MODEL = dict(
    h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=1, dropout=0.0,
)
# tests/test_parallel_eq_ar.py's trunk
N_ATOMS, N_RES, N_EDGES, H_DIM, E_DIM = 24, 6, 96, 8, 18
TRUNK_MODEL = dict(
    h_input_dim=H_DIM, chi_input_dim=2, e_input_dim=E_DIM, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=1, dropout=0.0, dense_dropout=0.0,
)
TRUNK_LAYER = dict(pre_norm=True, use_scalar_message_attention=True, aggregate_with_row=True)


def nms_model(params=None) -> GCPNetNMS:
    model = GCPNetNMS(ModelCfg(**NMS_MODEL), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
                      generator=torch.Generator().manual_seed(0), device="cpu")
    if params is not None:
        model.load_state_dict(from_jax_params(params))
    return model


def trunk_model(task: str, params=None):
    cls = GCPNetEQ if task == "eq" else GCPNetAR
    model = cls(ModelCfg(**TRUNK_MODEL), ModuleCfg(selected_gcp="GCP3"),
                LayerCfg(**TRUNK_LAYER, mp_cfg=MPCfg(num_message_layers=2)),
                generator=torch.Generator().manual_seed(0), device="cpu")
    if params is not None:
        model.load_state_dict(from_jax_params(params))
    return model


def nms_trainer(model, group=None) -> Trainer:
    return Trainer(model, nms_loss, optimizer_cfg=OPTIMIZER, early_stopping_patience=None, seed=3,
                   collect_fn=tasks.build_collect("GCPNetNMS"), metric_fns=tasks.build_metric_fns("GCPNetNMS"),
                   group=group)


def trunk_batch(task: str, graphs, shards):
    """This process's shard of the one batch of ``graphs`` (the JAX test's
    bucket: a shard's graphs and 8 spare nodes and rows)."""
    per = len(graphs) // shards.count
    bucket = Bucket(num_nodes=N_ATOMS * per + 8, num_edges=N_EDGES * per + 8, num_graphs=per + 1)
    (batch,) = batches_from_dataset([GraphData(**g) for g in graphs], bucket, shards=shards)
    max_res = N_RES * per + 2
    return globalize_residues(batch, max_res) if task == "eq" else globalize_ar_residues(batch, max_res)


def _group():
    torch.set_num_threads(1)
    return parallel.init_from_env("cpu")


def nms_worker(root: str, params, batch_size: int):
    """NMS in this process's group: the validation metrics of the given
    weights, two training steps' losses, and the validation after them."""
    group = _group()
    dm = NMSDataModule(data_root=root, batch_size=batch_size, shards=group.shards, **NMS_SPLITS)
    dm.setup()
    trainer = nms_trainer(nms_model(params), group)
    before = trainer.eval_epoch(dm.val_batches())
    losses = [
        float(train_step(trainer.model, trainer.state, b.to("cpu"), nms_loss, trainer.generator).loss)
        for b in dm.train_batches(seed=0)
    ]
    try:  # a captured step on this gloo group
        TrainSteps(trainer.model, trainer.state, nms_loss, trainer.generator)
        refused = "no error"
    except RuntimeError as exc:
        refused = str(exc)
    return {"val_before": before, "losses": losses, "val_after": trainer.eval_epoch(dm.val_batches()),
            "capture": refused}


def trunk_steps(task: str, params, graphs, group=None):
    """Two training steps of the EQ or AR trunk on this process's shard of
    one batch of ``graphs`` (all of it alone): their losses."""
    model = trunk_model(task, params)
    trainer = Trainer(model, eq_loss if task == "eq" else ar_loss, optimizer_cfg=OPTIMIZER, seed=11, group=group)
    batch = trunk_batch(task, graphs, group.shards if group else Shards()).to("cpu")
    return [float(train_step(model, trainer.state, batch, trainer.loss_fn, trainer.generator).loss) for _ in range(2)]


def trunk_worker(runs):
    """:func:`trunk_steps` of each ``(task, params, graphs)`` in this
    process's group."""
    group = _group()
    return [trunk_steps(task, params, graphs, group) for task, params, graphs in runs]


def failing_worker():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    group = _group()
    if group.rank == 1:
        raise ValueError("rank 1 gives up")
    parallel.barrier(group)


def rank_worker() -> int:
    """This process's rank, without a process group."""
    import os

    return int(os.environ["RANK"])
