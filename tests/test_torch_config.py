"""The port's config system against the JAX package's, on the CPU.

- ``gcpnet_torch.config.loader.compose`` equals ``gcpnet_tpu.config.loader.
  compose`` for ``train.yaml`` with each of the 20 experiments, for
  ``eval.yaml``, ``predict.yaml``, every ``debug=`` profile, the
  hyperparameter searches and the override cases of ``tests/test_config.py``
  (value overrides, group selection, deletion, ``+``/``++`` keys,
  interpolation with ``PROJECT_ROOT`` set); an unknown experiment raises in
  both.
- ``_target_`` strings resolve to the port's own classes by short name and
  import nothing; an unknown target raises an ``ImportError``.
- ``data.registry.build_datamodule`` builds each experiment's datamodule
  and refuses a key the port does not take; the loggers: CSV offline, a
  logger whose package is absent raises; the sweeps' sampler as the JAX one.
- No silent CPU: without a card the train, eval and predict entry points
  raise under the default ``trainer.accelerator``.
- EQ's prediction writer gives the JAX writer's PDB text and CSV rows.
- chip_smoke's resumed-step check counts each resumed epoch's own batches.
"""

import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest
import torch

import gcpnet_tpu.data.native as jnative
from gcpnet_tpu.config import loader as jloader
from gcpnet_tpu.data import eq as jeq
from gcpnet_tpu.utils import sweeps as jsweeps
from gcpnet_torch import eval as eval_entry
from gcpnet_torch import predict as predict_entry
from gcpnet_torch.config import loader
from gcpnet_torch.config.instantiate import instantiate, resolve_target
from gcpnet_torch.data import eq
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.data.registry import DATAMODULES, build_datamodule
from gcpnet_torch.models import MODEL_REGISTRY
from gcpnet_torch.nn.gcp import GCP3
from gcpnet_torch.nn.interactions import GCPInteractions2
from gcpnet_torch.tasks import model_name_from_target
from gcpnet_torch.train import entry
from gcpnet_torch.train.trainer import Trainer
from gcpnet_torch.utils import sweeps
from gcpnet_torch.utils.loggers import CSVLogger, instantiate_loggers

CONFIG_DIR = loader.CONFIG_DIR
EXPERIMENTS = sorted(f[: -len(".yaml")] for f in os.listdir(os.path.join(CONFIG_DIR, "experiment")))
CASES = (
    [("train.yaml", [f"experiment={e}"]) for e in EXPERIMENTS]
    + [("eval.yaml", ["ckpt_path=/tmp/ck"]), ("predict.yaml", ["ckpt_path=/tmp/ck"]), ("train.yaml", [])]
    + [("train.yaml", [f"debug={p}"]) for p in ("default", "fdr", "limit", "overfit", "profiler")]
    + [("train.yaml", [f"hparams_search={h}"]) for h in ("cpd_optuna", "lba_optuna", "nms_optuna", "psr_optuna")]
    + [
        ("train.yaml", ["trainer=cpu", "model.model_cfg.num_encoder_layers=3", "seed=7", "tags=[a,b]"]),
        ("train.yaml", ["~callbacks.early_stopping"]),
        ("train.yaml", ["experiment=gcpnet_nms_small", "datamodule.batch_size=16", "logger=csv"]),
        ("train.yaml", ["experiment=gcpnet_eq", "logger=many_loggers", "callbacks=none"]),
        ("train.yaml", ["+trainer.scan_chunk_size=4", "++model.extra=2", "trainer=gpu"]),
        ("eval.yaml", ["experiment=gcpnet_cpd", "ckpt_path=/tmp/ck", "+cpd_num_samples=3"]),
        ("predict.yaml", ["model=gcpnet_ar", "datamodule=ar", "ckpt_path=/tmp/ck", "datamodule.predict_true_dir=null"]),
    ]
)


@pytest.mark.parametrize("name,overrides", CASES, ids=[f"{n}:{' '.join(o)}" for n, o in CASES])
@pytest.mark.parametrize("project_root", [None, "/tmp/x"])
def test_compose_matches_jax(monkeypatch, name, overrides, project_root):
    if project_root is None:
        monkeypatch.delenv("PROJECT_ROOT", raising=False)
    else:
        monkeypatch.setenv("PROJECT_ROOT", project_root)
    got = loader.compose(CONFIG_DIR, name, overrides)
    assert got == jloader.compose(CONFIG_DIR, name, overrides)
    if project_root is not None:
        assert got["paths"]["output_dir"].startswith(project_root)


def test_unknown_experiment_raises_in_both():
    with pytest.raises(loader.ConfigError):
        loader.compose(CONFIG_DIR, "train.yaml", ["experiment=does_not_exist"])
    with pytest.raises(jloader.ConfigError):
        jloader.compose(CONFIG_DIR, "train.yaml", ["experiment=does_not_exist"])


def test_targets_resolve_to_the_port_by_short_name(tmp_path):
    assert resolve_target("gcpnet_tpu.nn.gcp.GCP3") is GCP3
    assert resolve_target("gcpnet_tpu.nn.GCPInteractions2") is GCPInteractions2
    assert resolve_target("gcpnet_tpu.train.Trainer") is Trainer
    assert resolve_target("gcpnet_tpu.data.eq.EQDataModule") is DATAMODULES["EQDataModule"]
    assert resolve_target("src.models.gcpnet_psr_module.GCPNetPSRLitModule") is MODEL_REGISTRY["GCPNetPSR"]
    assert model_name_from_target("src.models.gcpnet_psr_module.GCPNetPSRLitModule") == "GCPNetPSR"
    assert model_name_from_target("gcpnet_tpu.models.GCPNetRS") == "GCPNetRS"
    logger = instantiate({"_target_": "gcpnet_tpu.utils.loggers.CSVLogger", "save_dir": "unused"}, save_dir=str(tmp_path))
    assert isinstance(logger, CSVLogger)
    adam = instantiate({"_target_": "optax.adam", "_partial_": True, "lr": "1e-3"})
    opt = adam([torch.nn.Parameter(torch.zeros(2))])
    assert type(opt).__name__ == "Adam" and opt.base_lr == 1e-3


@pytest.mark.parametrize("target", ["gcpnet_tpu.models.GCPNetNope", "optax.lamb", "gcpnet_tpu.nn.gcp.GCP",
                                    "os.system"])
def test_unknown_target_raises_import_error(target):
    with pytest.raises(ImportError, match=target.rsplit(".", 1)[-1]):
        resolve_target(target)
    with pytest.raises(ImportError):
        instantiate({"_target_": target})


@pytest.mark.parametrize("experiment", [e for e in EXPERIMENTS if "ablations" not in e])
def test_every_experiments_datamodule_builds(experiment):
    cfg = loader.compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}"])
    dm = build_datamodule(cfg["datamodule"], device="cpu")
    assert type(dm).__name__ == cfg["datamodule"]["_target_"].rsplit(".", 1)[-1]


@pytest.mark.parametrize("override,match", [
    ("+datamodule.no_such_knob=1", "no_such_knob"),
    ("datamodule.python_exec_path=/usr/bin/python3", "python_exec_path"),
    ("datamodule.lddt_exec_path=/usr/bin/lddt", "lddt_exec_path"),
])
def test_datamodule_refuses_what_the_port_lacks(override, match):
    experiment = "gcpnet_eq" if "exec_path" in override else "gcpnet_lba"
    cfg = loader.compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}", override])
    # the port reads lddt_exec_path, and refuses a configured binary that is not there
    error = FileNotFoundError if "lddt_exec_path" in override else ValueError
    with pytest.raises(error, match=match):
        build_datamodule(cfg["datamodule"])


def test_loggers(tmp_path):
    cfg = loader.compose(CONFIG_DIR, "train.yaml", ["logger=csv", f"paths.output_dir={tmp_path}"])
    (csv_logger,) = instantiate_loggers(cfg["logger"])
    csv_logger.log_metrics({"a": 1.0}, step=1)
    csv_logger.log_metrics({"a": 2.0, "b": 3.0}, step=2)
    with open(tmp_path / "csv" / "metrics.csv") as f:
        assert f.read().splitlines()[0] == "a,step"
    for name, package in (("wandb", "wandb"), ("comet", "comet_ml"), ("mlflow", "mlflow"), ("neptune", "neptune")):
        try:
            __import__(package)
            continue
        except ImportError:
            pass
        cfg = loader.compose(CONFIG_DIR, "train.yaml", [f"logger={name}", f"paths.output_dir={tmp_path}"])
        with pytest.raises(ImportError, match=package):
            instantiate_loggers(cfg["logger"])


def test_sweep_sampler_matches_jax():
    params = {"model.optimizer.lr": "interval(1e-5, 1e-3)", "model.model_cfg.dropout": "choice(0.0, 0.05, 0.1)",
              "model.layer_cfg.mp_cfg.num_message_layers": "range(2, 9, 2)"}
    seen = []

    def objective(p):
        seen.append(p)
        return p["model.optimizer.lr"]

    got = sweeps.run_search(objective, params, n_trials=4, seed=3)
    jseen = []
    want = jsweeps.run_search(lambda p: jseen.append(p) or p["model.optimizer.lr"], params, n_trials=4, seed=3)
    assert got[:2] == want[:2] and seen == jseen


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present: the default device is valid")
@pytest.mark.parametrize("route", ["train", "eval", "predict"])
def test_entry_points_refuse_a_silent_cpu_run(tmp_path, route):
    """With the default trainer.accelerator (``tpu``: the card) and no card,
    each entry point raises before it builds anything."""
    common = [f"paths.output_dir={tmp_path}", "extras.print_config=false"]
    with pytest.raises(RuntimeError, match="trainer.accelerator=cpu"):
        if route == "train":
            entry.main(["experiment=gcpnet_nms_small", *common])
        elif route == "eval":
            eval_entry.main(["experiment=gcpnet_nms_small", f"ckpt_path={tmp_path}", *common])
        else:
            predict_entry.main(["model=gcpnet_eq", "datamodule=eq", *common])
    assert not os.path.exists(tmp_path / "checkpoints")


# --- EQ's prediction writer -----------------------------------------------------------


@pytest.fixture
def scipy_radius_graph(monkeypatch):
    def unavailable(*args, **kwargs):
        raise RuntimeError("the native radius graph is off in these tests")

    monkeypatch.setattr(jnative, "radius_graph_native", unavailable)


def test_eq_writer_matches_jax(tmp_path, scipy_radius_graph):
    """The same decoys and per-residue predictions: the port's
    ``record_predictions`` writes the JAX writer's PDB text and gives its
    CSV rows (the PDB paths under each writer's own directory); the port's
    ``predict_batches`` queues the decoys in name order."""
    root = str(tmp_path / "eq")
    write_eq_decoys(root, seed=4, targets={"train": 1, "valid": 1, "test": 1}, decoys=2, residues=(10, 20))
    natives = tmp_path / "natives"
    natives.mkdir()
    decoys = sorted(os.listdir(os.path.join(root, "decoy_model")))
    for name in decoys:  # each native under its decoy's name, so the rows carry the true lDDT
        with open(os.path.join(root, "true_model", name.split("_")[0] + ".pdb")) as src:
            (natives / name).write_text(src.read())
    port = eq.EQDataModule("", "", "", max_nodes_per_batch=512, max_residues_per_batch=64,
                           predict_input_dir=os.path.join(root, "decoy_model"), predict_true_dir=str(natives))
    jdm = jeq.EQDataModule("", "", "")
    rng = np.random.default_rng(0)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    batches = list(port.predict_batches())
    assert [os.path.basename(p) for p in port.predict_paths] == decoys
    for batch, name in zip(batches, decoys):
        preds = rng.uniform(0.0, 1.0, size=batch.extras["res_mask"].shape[0]).astype(np.float32)
        got = port.record_predictions(batch, preds, str(tmp_path / "port"))
        want = jdm.record_predictions(batch, preds, str(tmp_path / "jax"), decoy=os.path.join(root, "decoy_model", name))
        assert [{**r, "annotated_pdb": os.path.basename(r["annotated_pdb"])} for r in got] == \
               [{**r, "annotated_pdb": os.path.basename(r["annotated_pdb"])} for r in want]
        assert got[0]["global_lddt_true"] > 0.0
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert not port.predict_paths


# --- chip_smoke's resumed-step check ---------------------------------------------------


def test_resumed_step_counts_each_epochs_own_batches():
    """A fit of two epochs that packed 77 and 76 batches, resumed to a
    third of 77: the check wants 153 + 77 = 230 steps, not 153 x 3 / 2 =
    229; an epoch the resumed fit never asked for raises."""
    from chip_smoke import EpochBatches, PhaseError, resumed_step

    class Packed:
        val = "kept"

        def train_batches(self, seed=0):
            return iter(range(77 if seed % 2 == 0 else 76))

    counted = EpochBatches(Packed())
    fit_steps = sum(1 for e in range(2) for _ in Packed().train_batches(seed=e))
    assert fit_steps == 153
    assert sum(1 for _ in counted.train_batches(seed=2)) == 77 and counted.val == "kept"
    assert resumed_step(fit_steps, counted, 2, 3) == 230 != fit_steps * 3 // 2
    with pytest.raises(PhaseError, match=r"\[3\]"):
        resumed_step(fit_steps, counted, 2, 4)
