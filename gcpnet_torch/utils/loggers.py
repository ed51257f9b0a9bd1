"""Experiment loggers: the port's copy of ``gcpnet_tpu/utils/loggers.py``.

The CSV logger writes offline with nothing but the standard library.  The
TensorBoard, Weights & Biases, Comet, MLflow and Neptune loggers need their
packages: selecting one whose package is absent raises an ``ImportError``
naming it, rather than running without it.  The W&B and Comet loggers
default to their offline modes.
"""

from __future__ import annotations

import csv
import importlib
import json
import os
from typing import Dict, List, Optional


def _require(package: str, logger: str):
    try:
        return importlib.import_module(package)
    except ImportError as exc:
        raise ImportError(f"{logger} needs the {package!r} package, which is not installed") from exc


class BaseLogger:
    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        raise NotImplementedError

    def log_hyperparams(self, params: Dict):
        pass

    def finalize(self):
        pass


class CSVLogger(BaseLogger):
    """``<save_dir>/<name>/metrics.csv``, a column a metric (the columns
    grow as new metrics come), and ``hparams.json``."""

    def __init__(self, save_dir: str, name: str = "csv/", prefix: str = ""):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = prefix
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fieldnames: Optional[List[str]] = None

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        row = {f"{self.prefix}{k}": v for k, v in metrics.items()}
        if step is not None:
            row["step"] = step
        write_header = self._fieldnames is None and not os.path.exists(self.path)
        if self._fieldnames is None:
            self._fieldnames = sorted(row.keys())
        self._fieldnames += [k for k in row if k not in self._fieldnames]
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                writer.writeheader()
            writer.writerow(row)

    def log_hyperparams(self, params: Dict):
        with open(os.path.join(self.dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)


class TensorBoardLogger(BaseLogger):
    def __init__(self, save_dir: str, prefix: str = "", **kwargs):
        _require("tensorboard", "TensorBoardLogger")
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(save_dir, exist_ok=True)
        self.prefix = prefix
        self.writer = SummaryWriter(save_dir)

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(f"{self.prefix}{k}", v, global_step=step or 0)

    def finalize(self):
        self.writer.close()


class WandbLogger(BaseLogger):
    def __init__(self, offline: bool = True, project: str = "gcpnet-tpu", **kwargs):
        wandb = _require("wandb", "WandbLogger")
        keep = {k: v for k, v in kwargs.items() if k in ("id", "group", "tags", "job_type") and v}
        self.run = wandb.init(project=project, mode="offline" if offline else "online", **keep)

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        self.run.log(metrics, step=step)

    def log_hyperparams(self, params: Dict):
        self.run.config.update(params, allow_val_change=True)

    def log_molecule_table(self, name: str, rows, pdb_key: str = "annotated_pdb"):
        """A table of ``rows`` with each row's ``pdb_key`` PDB as a
        ``wandb.Molecule``."""
        import wandb

        if not rows:
            return
        columns = sorted(rows[0].keys())
        table = wandb.Table(columns=columns + ["molecule"])
        for row in rows:
            path = row.get(pdb_key)
            table.add_data(*[row.get(c) for c in columns], wandb.Molecule(path) if path else None)
        self.run.log({name: table})

    def finalize(self):
        self.run.finish()


class CometLogger(BaseLogger):
    def __init__(self, project_name: str = "GCPNet", offline: bool = True, save_dir: Optional[str] = None, **kwargs):
        comet_ml = _require("comet_ml", "CometLogger")
        cls = comet_ml.OfflineExperiment if offline else comet_ml.Experiment
        self.exp = cls(project_name=project_name, offline_directory=save_dir or ".")

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        self.exp.log_metrics(metrics, step=step)

    def log_hyperparams(self, params: Dict):
        self.exp.log_parameters(params)

    def finalize(self):
        self.exp.end()


class MLFlowLogger(BaseLogger):
    def __init__(self, tracking_uri: Optional[str] = None, experiment_name: str = "gcpnet-tpu", **kwargs):
        self.mlflow = _require("mlflow", "MLFlowLogger")
        if tracking_uri:
            self.mlflow.set_tracking_uri(tracking_uri)
        self.mlflow.set_experiment(experiment_name)
        self.mlflow.start_run()

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        self.mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_hyperparams(self, params: Dict):
        self.mlflow.log_params(params)

    def finalize(self):
        self.mlflow.end_run()


class NeptuneLogger(BaseLogger):
    def __init__(self, project: Optional[str] = None, **kwargs):
        neptune = _require("neptune", "NeptuneLogger")
        self.run = neptune.init_run(project=project)

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        for k, v in metrics.items():
            self.run[k].append(float(v), step=step)

    def log_hyperparams(self, params: Dict):
        self.run["parameters"] = params

    def finalize(self):
        self.run.stop()


LOGGER_CLASSES = {
    "CSVLogger": CSVLogger,
    "TensorBoardLogger": TensorBoardLogger,
    "WandbLogger": WandbLogger,
    "CometLogger": CometLogger,
    "MLFlowLogger": MLFlowLogger,
    "NeptuneLogger": NeptuneLogger,
}


def instantiate_loggers(logger_block: Optional[Dict]) -> list:
    """The loggers of the composed ``logger:`` block (each entry a
    ``_target_`` node); an unknown logger class raises an ``ImportError``."""
    loggers = []
    for key, sub in (logger_block or {}).items():
        if not isinstance(sub, dict) or "_target_" not in sub:
            continue
        name = str(sub["_target_"]).rsplit(".", 1)[-1]
        if name not in LOGGER_CLASSES:
            raise ImportError(f"cannot resolve logger _target_ '{sub['_target_']}'")
        loggers.append(LOGGER_CLASSES[name](**{k: v for k, v in sub.items() if not k.startswith("_")}))
    return loggers
