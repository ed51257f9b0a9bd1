"""The port's config-driven entry points on the CPU, mirroring
``tests/test_cli.py`` on the tiny NMS setup with
``trainer.accelerator=cpu``: ``debug=fdr`` gives a finite test/loss,
``train=false`` skips training, ``-m seed=7,8`` gives two results,
``-m hparams_search=`` the best parameters; a run's checkpoints evaluated
by ``python -m gcpnet_torch.eval`` give its test/loss bit for bit; a run
resumed through ``ckpt_path`` goes on from its last checkpoint;
``trainer.devices`` above 1 and ``trainer.profiler`` without a trace
directory raise; ``--task``'s Trainer is the entry point's."""

import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest
import torch

from gcpnet_torch import eval as eval_entry
from gcpnet_torch import tasks
from gcpnet_torch.data.registry import build_datamodule
from gcpnet_torch.train import cli, entry

TINY = [
    "experiment=gcpnet_nms_small",
    "trainer.accelerator=cpu",
    "datamodule.num_train=32",
    "datamodule.num_valid=16",
    "datamodule.num_test=16",
    "datamodule.batch_size=16",
    "model.model_cfg.h_hidden_dim=16",
    "model.model_cfg.chi_hidden_dim=4",
    "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.num_encoder_layers=1",
    "model.layer_cfg.mp_cfg.num_message_layers=2",
    "extras.print_config=false",
]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    return TINY + [f"datamodule.data_dir={tmp_path}/nms"]


def test_fast_dev_run(tiny):
    metrics = entry.main(tiny + ["debug=fdr"])
    assert np.isfinite(metrics["test/loss"])


def test_train_flag_false_skips_training(tiny):
    metrics = entry.main(tiny + ["debug=fdr", "train=false"])
    assert "train/loss" not in metrics and np.isfinite(metrics["test/loss"])


def test_multirun_sweep(tiny):
    results = cli.main(["-m"] + tiny + ["debug=fdr", "seed=7,8"])
    assert len(results) == 2 and all(np.isfinite(r["test/loss"]) for r in results)
    assert results[0]["test/loss"] != results[1]["test/loss"]


def test_hparams_search(tiny):
    out = entry.main(["-m"] + tiny + ["debug=fdr", "hparams_search=nms_optuna", "hparams_search.n_trials=2"])
    assert set(out["best_params"]) == {"model.optimizer.lr", "model.model_cfg.dropout",
                                       "model.model_cfg.num_encoder_layers", "model.layer_cfg.mp_cfg.num_message_layers"}
    assert np.isfinite(out["best_value"])


def test_eval_reproduces_the_runs_test_loss(tiny, tmp_path):
    """Two epochs with checkpoints, then the eval entry point on them: the
    same best checkpoint's test/loss, bit for bit; a run resumed from the
    checkpoints through ckpt_path goes on at the third epoch."""
    trainers = []
    metrics = entry.main(tiny + ["trainer.max_epochs=2", "trainer.min_epochs=0", "logger=csv"], trainers=trainers)
    ckpt = tmp_path / "logs" / "train" / "runs" / "checkpoints"
    assert trainers[0].ckpt.directory == str(ckpt) and os.listdir(ckpt)
    assert (tmp_path / "logs" / "train" / "runs" / "csv" / "metrics.csv").exists()
    again = eval_entry.main(tiny + [f"ckpt_path={ckpt}"])
    assert again["test/loss"] == metrics["test/loss"]
    resumed = []
    entry.main(tiny + ["trainer.max_epochs=3", "trainer.min_epochs=0", f"ckpt_path={ckpt}",
                       f"callbacks.model_checkpoint.dirpath={tmp_path}/resumed"], trainers=resumed)
    assert resumed[0].history["epoch"] == [2] and resumed[0].state.step == 3 * 2


@pytest.mark.parametrize("override,error", [("trainer.devices=2", NotImplementedError),
                                            ("trainer.profiler=torch", ValueError)])
def test_unported_trainer_settings_raise(tiny, override, error):
    with pytest.raises(error, match=override.split("=")[0].split(".")[1]):
        entry.main(tiny + ["debug=fdr", override])


def test_profiler_writes_a_trace(tiny, tmp_path):
    entry.main(tiny + ["debug=profiler", "trainer.fast_dev_run=true"])
    assert (tmp_path / "logs" / "debug" / "runs" / "profile" / "trace.json").exists()


def test_eval_adds_cpds_design_metrics(tmp_path, monkeypatch):
    """The eval entry point on a CPD run's checkpoints adds the design
    metrics of the test chains (``cpd_num_samples`` sequences a chain,
    recovery with the autoregressive decoder)."""
    from gcpnet_torch.data.cath_synthetic import write_cath_chains

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    write_cath_chains(str(tmp_path / "cath"), chains={"train": 4, "validation": 2, "test": 2}, lengths=(20, 30))
    small = [
        "experiment=gcpnet_cpd", "trainer.accelerator=cpu", f"datamodule.data_dir={tmp_path}/cath",
        "datamodule.batch_size=2", "+datamodule.max_nodes_per_batch=128", "model.model_cfg.num_encoder_layers=1",
        "model.model_cfg.num_decoder_layers=1", "model.layer_cfg.mp_cfg.num_message_layers=2",
        "extras.print_config=false",
    ]
    entry.main(small + ["trainer.max_epochs=1"])
    metrics = eval_entry.main(small + [f"ckpt_path={tmp_path}/logs/train/runs/checkpoints", "+cpd_num_samples=2"])
    assert np.isfinite(metrics["test/loss"])
    assert {f"test/{s}_{m}" for s in ("all", "short", "single_chain") for m in ("perplexity", "recovery")} <= set(metrics)


def _settings(optimizer) -> dict:
    """An optimizer's plain settings (rates, betas, accumulation)."""
    return {k: v for k, v in vars(optimizer).items() if isinstance(v, (bool, int, float, str, tuple))}


TRAINER_SETTINGS = ("max_epochs", "min_epochs", "max_steps_per_epoch", "monitor", "monitor_mode",
                    "early_stopping_patience", "log_dir", "scan_chunk_size")


@pytest.mark.parametrize("task,overrides", [
    ("nms", {"precision": 32}),
    ("rs", {}),
    ("eq", {"limit_train_batches": 3}),
    ("ar", {"scan_chunk_size": 4}),
    ("cpd", {"accumulate_grad_batches": 1}),
])
def test_task_trainer_is_the_entry_points_trainer(task, overrides, tmp_path):
    """``cli.build_task_trainer`` is the training entry point's Trainer of
    the task's composed experiment: its precision, adaptive clip (EQ and
    AR's ``clip_gradients``), optimizer, epochs, stopping, checkpoint and
    log directory, with each ``trainer.`` keyword an override."""
    ckpt = str(tmp_path / "ckpt")
    got = cli.build_task_trainer(task, 3, "cpu", num_encoder_layers=1, lr=2e-4, checkpoint_dir=ckpt,
                                 max_epochs=2, **overrides)
    cfg = cli.experiment(task, [
        "model.model_cfg.num_encoder_layers=1", "seed=3", "model.optimizer.lr=2e-4", "trainer.max_epochs=2",
        *[f"trainer.{k}={v}" for k, v in overrides.items()], f"paths.output_dir={ckpt}",
        f"callbacks.model_checkpoint.dirpath={ckpt}",
    ])
    model, name = tasks.build_model(cfg["model"], seed=3, device="cpu")
    want = entry.build_trainer(cfg, model, tasks.build_loss(name), name)
    assert {k: getattr(got, k) for k in TRAINER_SETTINGS} == {k: getattr(want, k) for k in TRAINER_SETTINGS}
    assert got.state.compute_dtype == want.state.compute_dtype
    assert (got.state.ring is None) == (want.state.ring is None) == (task not in ("eq", "ar"))
    assert got.ckpt.directory == want.ckpt.directory == ckpt
    assert got.state.optimizer.param_groups[0]["lr"] == want.state.optimizer.param_groups[0]["lr"]
    assert type(got.state.optimizer) is type(want.state.optimizer)
    assert _settings(got.state.optimizer) == _settings(want.state.optimizer)
    assert all(torch.equal(p, q) for p, q in zip(got.model.parameters(), want.model.parameters()))


def test_rs_sizes_left_out_keep_the_datamodules_defaults():
    """``--task rs --num-train N`` sets the training split's size only; the
    other splits keep the datamodule's own sizes."""
    cfg = cli.experiment("rs", ["+datamodule.synthetic_sizes.train=8"])
    dm = build_datamodule(cfg["datamodule"], seed=0, device="cpu")
    assert dm.synthetic_sizes == {"train": 8, "valid": 512, "test": 512}
