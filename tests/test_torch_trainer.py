"""The port's fit/eval loop against the JAX ``Trainer``, on the CPU.

- Two epochs of NMS in the setup of ``tests/test_resume.py`` (5-body
  graphs, 32/16 trajectories, batch 16, Adam at 1e-3, seed 3), with no
  dropout and the same initial weights and batches: per-epoch
  ``train/loss``, ``val/loss``, ``val/RMSE`` and ``val/CosineSimilarity``
  at fp32 atol 1e-4.
- Resume: fitting two epochs and resuming for a third equals three epochs
  straight, bit for bit on the CPU (dropout on, so the generator's state is
  part of it); the restored step counter and weights equal the saved ones.
- The fit loop's control flow (early stopping after ``min_epochs``,
  ``check_val_every_n_epoch``, the plateau's ``lr_scale``) against the JAX
  ``Trainer`` on the same scripted validation losses; ``max_steps_per_epoch``
  and the epoch mean over every step against the JAX ``train_epoch`` on the
  same scripted step losses; ``save_top_k`` pruning and the best/last
  checkpoints against the JAX ``CheckpointManager``.
- The prefetch thread hands its exception to the caller.
"""

import json

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.nms import NMSDataModule as JNMSDataModule
from gcpnet_tpu.models import GCPNetNMS as JGCPNetNMS
from gcpnet_tpu.models import nms_loss as jnms_loss
from gcpnet_tpu.parallel import make_mesh
from gcpnet_tpu.train import Trainer as JTrainer
from gcpnet_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from gcpnet_tpu.train.state import TrainState as JTrainState
from gcpnet_torch import tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.train import trainer as trainer_module
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.train.step import StepResult
from gcpnet_torch.train.trainer import Trainer, prefetched
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4
SPLITS = dict(data_mode="small", batch_size=16, num_train=32, num_valid=16, num_test=16)
MODEL = dict(
    h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1, h_hidden_dim=16,
    chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=1,
)
OPTIMIZER = {"_target_": "Adam", "lr": 1e-3}
NMS_METRICS = ("train/loss", "val/loss", "val/RMSE", "val/CosineSimilarity")


@pytest.fixture(scope="module")
def nms_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nms"))
    JNMSDataModule(data_root=root, **SPLITS).prepare_data()
    return root


def _datamodule(root, cls=NMSDataModule):
    dm = cls(data_root=root, **SPLITS)
    dm.setup()
    return dm


def _port_model(dropout: float, params=None) -> GCPNetNMS:
    model = GCPNetNMS(
        ModelCfg(**MODEL, dropout=dropout), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    if params is not None:
        model.load_state_dict(from_jax_params(params))
    return model


def _port_trainer(model, **kw) -> Trainer:
    return Trainer(
        model, nms_loss, optimizer_cfg=OPTIMIZER, early_stopping_patience=None, seed=3,
        collect_fn=tasks.build_collect("GCPNetNMS"), metric_fns=tasks.build_metric_fns("GCPNetNMS"), **kw,
    )


def test_fit_matches_jax_trainer(nms_root):
    jdm = _datamodule(nms_root, JNMSDataModule)
    jtrainer = JTrainer(
        JGCPNetNMS(
            model_cfg=JModelCfg(**MODEL, dropout=0.0), module_cfg=JModuleCfg(),
            layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2)),
        ),
        jnms_loss, optimizer_cfg=OPTIMIZER, max_epochs=2, mesh=make_mesh(jax.devices()[:1]),
        early_stopping_patience=None, seed=3, collect_fn=jtasks.build_collect("GCPNetNMS"),
        metric_fns=jtasks.build_metric_fns("GCPNetNMS"),
    )
    jtrainer.init_state(jtrainer._put(next(iter(jdm.train_batches(seed=0)))))
    port = _port_trainer(_port_model(0.0, jtrainer.state.params), max_epochs=2)
    jtrainer.fit(jdm)
    port.fit(_datamodule(nms_root))
    assert port.state.step == int(jtrainer.state.step) == 4
    assert port.history["epoch"] == jtrainer.history["epoch"] == [0, 1]
    for name in NMS_METRICS:
        np.testing.assert_allclose(port.history[name], jtrainer.history[name], atol=ATOL, err_msg=name)
    assert port.history["val/loss"][1] < port.history["val/loss"][0]


def test_resume_continues_bit_for_bit(nms_root, tmp_path):
    dm = _datamodule(nms_root)
    straight = _port_trainer(
        _port_model(0.1), max_epochs=3, checkpoint_dir=str(tmp_path / "a"), log_dir=str(tmp_path / "logs")
    )
    straight.fit(dm)
    with open(tmp_path / "logs" / "metrics.csv") as f:
        rows = f.read().splitlines()
    assert len(rows) == 4 and rows[0].split(",") == sorted(["epoch", *NMS_METRICS, "train/steps_per_sec"])

    first = _port_trainer(_port_model(0.1), max_epochs=2, checkpoint_dir=str(tmp_path / "b"))
    first.fit(dm)
    resumed = _port_trainer(_port_model(0.1), max_epochs=3, checkpoint_dir=str(tmp_path / "b"))
    resumed.load_checkpoint_state(resumed.ckpt.restore_last())
    assert resumed.state.step == first.state.step == 4 and resumed.epoch == 2
    for (name, p), q in zip(first.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name

    resumed = _port_trainer(_port_model(0.1), max_epochs=3, checkpoint_dir=str(tmp_path / "b"))
    resumed.fit(dm, resume=True)
    assert resumed.history["epoch"] == [2] and resumed.state.step == straight.state.step == 6
    for name in NMS_METRICS:
        assert resumed.history[name] == straight.history[name][2:], name
    for (name, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
    assert resumed.ckpt.steps == [2, 4, 6] and straight.ckpt.steps == [2, 4, 6]
    # the best checkpoint holds the weights logged with its val/loss
    best = resumed.ckpt.best_step
    assert resumed.ckpt.metrics(best)["val/loss"] == min(straight.history["val/loss"])


class _Stub(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


class _Scripted:
    """A datamodule with no batches: train and eval epochs are scripted."""

    def train_batches(self, seed=0):
        return iter(())

    def val_batches(self):
        return iter(())


def _run_scripted(trainer, val_losses, jax_side: bool):
    """Fit with scripted epochs: each train epoch records the lr scale it
    ran at; each validation returns the next scripted loss."""
    seen = {"lr_scale": [], "validated": []}
    losses = iter(val_losses)

    def train_epoch(batches, epoch):
        scale = trainer.plateau.scale if trainer.plateau else 1.0
        seen["lr_scale"].append(scale)
        seen["validated"].append(False)
        return {"train/loss": 1.0}

    def eval_epoch(batches, prefix="val"):
        seen["validated"][-1] = True
        return {f"{prefix}/loss": next(losses)}

    trainer.train_epoch = train_epoch
    trainer.eval_epoch = eval_epoch
    if jax_side:
        trainer.state = JTrainState.create({"w": jnp.zeros(1)}, optax.adam(1e-3))
    trainer.fit(_Scripted())
    return seen


FIT_CASES = {
    "early_stop_after_min_epochs": dict(
        kw=dict(max_epochs=12, early_stopping_patience=2, min_epochs=6),
        losses=[1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0, 1.1, 1.2, 1.3, 1.4],
        epochs=7,  # patience ran out at epoch 3; the stop waits for epoch 6
    ),
    "validate_every_3rd_epoch": dict(
        kw=dict(max_epochs=10, early_stopping_patience=1, check_val_every_n_epoch=3),
        losses=[1.0, 0.8, 0.9, 0.95],
        epochs=10,
    ),
    "plateau": dict(
        kw=dict(
            max_epochs=9, early_stopping_patience=None,
            scheduler_cfg={"_target_": "ReduceLROnPlateau", "factor": 0.5, "patience": 1},
        ),
        losses=[1.0, 1.1, 1.2, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
        epochs=9,
    ),
    "max_mode": dict(
        kw=dict(max_epochs=8, early_stopping_patience=1, monitor_mode="max"),
        losses=[0.1, 0.3, 0.2, 0.25, 0.4, 0.1, 0.05, 0.01],
        epochs=4,
    ),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_control_flow_matches_jax_trainer(case):
    kw, losses = FIT_CASES[case]["kw"], FIT_CASES[case]["losses"]
    want = _run_scripted(JTrainer(None, None, mesh=make_mesh(jax.devices()[:1]), **kw), losses, True)
    port = Trainer(_Stub(), None, **kw)
    got = _run_scripted(port, losses, False)
    assert got == want
    assert len(got["lr_scale"]) == FIT_CASES[case]["epochs"]
    if case == "plateau":
        assert got["lr_scale"] == [1.0] * 3 + [0.5] * 3 + [0.25] * 2 + [0.125]


class _HostBatch:
    def to(self, device, non_blocking=False):
        return self


@pytest.mark.parametrize("max_steps", [None, 3])
def test_train_epoch_mean_over_every_step_matches_jax(monkeypatch, max_steps):
    """The epoch's loss is the mean over every step run (the JAX test
    test_epoch_loss_covers_every_step), cut at ``max_steps_per_epoch``."""
    jtrainer = JTrainer(None, None, mesh=make_mesh(jax.devices()[:1]), max_steps_per_epoch=max_steps)
    jlosses = iter(np.arange(1.0, 121.0, dtype=np.float32))
    jtrainer._train_step = lambda state, batch, rng, lr_scale: (state, jnp.float32(next(jlosses)), jnp.float32(0))
    jtrainer._put = lambda b: b
    jtrainer.state = JTrainState.create({"w": jnp.zeros(1)}, optax.adam(1e-3))
    want = jtrainer.train_epoch(({"i": i} for i in range(120)), epoch=0)

    losses = iter(np.arange(1.0, 121.0, dtype=np.float32))
    steps = []

    def fake_step(model, state, batch, loss_fn, generator=None, lr_scale=1.0):
        steps.append(batch)
        return StepResult(torch.tensor(next(losses)), torch.tensor(0.0), True)

    monkeypatch.setattr(trainer_module, "train_step", fake_step)
    port = Trainer(_Stub(), None, max_steps_per_epoch=max_steps)
    got = port.train_epoch((_HostBatch() for _ in range(120)), epoch=0)
    assert len(steps) == (120 if max_steps is None else 3)
    assert got["train/loss"] == pytest.approx(want["train/loss"]) == (60.5 if max_steps is None else 2.0)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_checkpoint_pruning_matches_jax(tmp_path, mode):
    """``save_top_k`` 3 over six monitored saves, then a step-frequency save
    without the monitored metric: the kept steps and the best step against
    the JAX manager; restore_best and restore_last give their states."""
    losses = [0.5, 0.9, 0.3, 0.7, 0.4, 0.8]
    jmgr = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=3, mode=mode)
    mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=3, mode=mode)
    tx = optax.adam(1e-3)
    for step, loss in enumerate(losses, start=1):
        jmgr.save(step, JTrainState.create({"w": jnp.full(2, float(step))}, tx), {"val/loss": loss})
        mgr.save(step, {"w": torch.full((2,), float(step))}, {"val/loss": loss, "epoch": step})
    assert mgr.steps == sorted(jmgr._mgr.all_steps())
    assert mgr.best_step == jmgr.best_step
    jmgr.close()
    assert mgr.restore_best()["w"][0].item() == mgr.best_step
    assert mgr.restore_last()["w"][0].item() == 6
    assert mgr.metrics(mgr.best_step)["val/loss"] == (min(losses) if mode == "min" else max(losses))
    mgr.save(7, {"w": torch.full((2,), 7.0)}, {"step": 7.0})  # kept besides the top 3
    worst = max(losses) if mode == "min" else min(losses)
    mgr.save(7, {"w": torch.full((2,), 7.0)}, {"val/loss": worst})  # still kept
    assert mgr.steps == sorted(jmgr._mgr.all_steps()) + [7]
    again = CheckpointManager(str(tmp_path / "port"), max_to_keep=3, mode=mode)  # the index persists
    assert again.steps == mgr.steps and again.best_step == mgr.best_step
    assert again.restore()["w"][0].item() == 7.0


def test_train_nms_cpu_entry_point(tmp_path, capsys):
    """``python -m gcpnet_torch.train --task nms`` on the CPU at a small
    size: one JSON line per epoch and one of test metrics; a second run with
    ``--resume`` goes on from the first's last checkpoint; no kernel runs."""
    from gcpnet_torch.ops.edge_map import edge_map, edge_map_backward
    from gcpnet_torch.ops.segment_sorted import segment_sum_sorted
    from gcpnet_torch.train import cli

    args = [
        "--task", "nms", "--device", "cpu", "--data-mode", "small", "--num-train", "8", "--num-valid", "4",
        "--num-test", "4", "--batch-size", "4", "--num-encoder-layers", "1", "--min-epochs", "0",
        "--data-root", str(tmp_path / "data"), "--checkpoint-dir", str(tmp_path / "ckpt"),
    ]
    launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
    cli.main([*args, "--max-epochs", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("epoch") for ln in lines] == [0, 1, None] and lines[1]["step"] == 4
    assert all(np.isfinite(ln["val/RMSE"]) and np.isfinite(ln["val/CosineSimilarity"]) for ln in lines[:2])
    assert np.isfinite(lines[2]["test/loss"]) and np.isfinite(lines[2]["test/CosineSimilarity"])
    cli.main([*args, "--max-epochs", "3", "--resume"])
    again = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("epoch") for ln in again] == [2, None] and again[0]["step"] == 6
    assert (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches) == launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(args[:2] + args[4:])


def test_metric_failure_is_logged_not_raised(nms_root, caplog):
    def boom(p, labels):
        raise FloatingPointError("no metric today")

    trainer = Trainer(
        _port_model(0.0), nms_loss, collect_fn=tasks.build_collect("GCPNetNMS"),
        metric_fns={"RMSE": tasks.build_metric_fns("GCPNetNMS")["RMSE"], "Boom": boom},
    )
    metrics = trainer.eval_epoch(_datamodule(nms_root).val_batches())
    assert set(metrics) == {"val/loss", "val/RMSE"} and np.isfinite(metrics["val/RMSE"])
    assert "metric Boom failed" in caplog.text and "no metric today" in caplog.text


def test_bf16_precision_keeps_float32_masters(nms_root):
    """``precision=16``: the steps compute in bf16 over float32 master
    weights, and the epoch's loss tracks the float32 fit's (bf16 keeps 8
    bits: within 2%)."""
    dm = _datamodule(nms_root)
    losses = {}
    for precision in (32, 16):
        trainer = _port_trainer(_port_model(0.0), max_epochs=1, precision=precision)
        assert trainer.state.compute_dtype == (torch.bfloat16 if precision == 16 else torch.float32)
        losses[precision] = trainer.fit(dm)["train/loss"]
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    np.testing.assert_allclose(losses[16], losses[32], rtol=2e-2)


def test_step_frequency_checkpoints(monkeypatch, tmp_path):
    """``checkpoint_every_n_steps`` 3 over 3 epochs of 2 steps: a pinned
    checkpoint at step 4 (the first epoch end 3 or more steps on) beside the
    single best monitored one (``save_top_k`` 1)."""

    def fake_step(model, state, batch, loss_fn, generator=None, lr_scale=1.0):
        state.step += 1
        return StepResult(torch.tensor(1.0), torch.tensor(0.0), True)

    class TwoBatches(_Scripted):
        def train_batches(self, seed=0):
            return iter([_HostBatch(), _HostBatch()])

    monkeypatch.setattr(trainer_module, "train_step", fake_step)
    trainer = Trainer(
        _Stub(), None, max_epochs=3, checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=3, save_top_k=1,
        early_stopping_patience=None,
    )
    losses = iter([0.5, 0.9, 0.7])
    trainer.eval_epoch = lambda batches, prefix="val": {f"{prefix}/loss": next(losses)}
    trainer.fit(TwoBatches())
    assert trainer.state.step == 6
    assert trainer.ckpt.steps == [2, 4] and trainer.ckpt.best_step == 2
    assert trainer.ckpt.restore_last()["step"] == 6 and trainer.ckpt.restore(4)["step"] == 4


def test_prefetch_thread_hands_on_its_exception():
    def items():
        yield 1
        raise KeyError("made in the thread")

    it = prefetched(items())
    assert next(it) == 1
    with pytest.raises(KeyError, match="made in the thread"):
        next(it)
    # closing early stops the thread
    it = prefetched(iter(range(100)))
    assert next(it) == 0
    it.close()
