"""Task wiring: the metric collection of each task model.

The port's copy of the collect and metric functions of
``gcpnet_tpu/tasks.py`` for the task models ported so far (LBA, PSR, NMS,
RS, CPD, EQ and AR).
A collect function (:class:`Collect`) keeps what it reads of a batch and
adds the batch's host predictions and labels to a
:class:`~gcpnet_torch.train.metrics.Collector`; the metric functions run on
what it collected at the end of an evaluation epoch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import numpy as np

from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train import metrics as M

TASK_OF_MODEL = {"GCPNetLBA": "lba", "GCPNetPSR": "psr", "GCPNetNMS": "nms", "GCPNetRS": "rs", "GCPNetCPD": "cpd", "GCPNetEQ": "eq",
                 "GCPNetAR": "ar"}


def _task(model_name: str) -> str:
    if model_name not in TASK_OF_MODEL:
        raise NotImplementedError(f"task model {model_name!r} is not ported yet")
    return TASK_OF_MODEL[model_name]


class Collect(NamedTuple):
    """A task's collect function in two halves.  ``keep(batch)`` takes what
    ``add`` reads of an evaluation batch: a few small host arrays, which
    the fit loop keeps until the epoch's metrics in place of the batch
    (whose edge arrays are many times larger).  ``add(collector, out,
    kept)`` adds the batch's host predictions ``out`` and labels to the
    collector.  Called whole on a batch it does both, as the JAX collect
    function does."""

    keep: Callable[[GraphBatch], Dict[str, Any]]
    add: Callable[[M.Collector, np.ndarray, Dict[str, Any]], None]

    def __call__(self, collector: M.Collector, out: np.ndarray, batch: GraphBatch) -> None:
        self.add(collector, out, self.keep(batch))


def _graph_keep(batch: GraphBatch) -> Dict[str, Any]:
    return {"label": batch.extras["label"], "mask": batch.graph_pad_mask, "groups": batch.extras.get("target_id")}


def _node_pos_keep(batch: GraphBatch) -> Dict[str, Any]:
    return {"label": batch.extras["label"], "mask": np.repeat(np.asarray(batch.valid_node_mask()), 3), "groups": None}


def _residue_keep(batch: GraphBatch) -> Dict[str, Any]:
    return {"label": batch.extras["seq"], "mask": batch.valid_node_mask(), "groups": None}


def _eq_keep(batch: GraphBatch) -> Dict[str, Any]:
    """EQ: each residue slot's label, its mask the residue mask."""
    return {"label": batch.extras["label"], "mask": batch.extras["res_mask"], "groups": None}


def _add(collector: M.Collector, out: np.ndarray, kept: Dict[str, Any]) -> None:
    collector.add(out, kept["label"], mask=kept["mask"], groups=kept["groups"])


def _add_argmax(collector: M.Collector, logits: np.ndarray, kept: Dict[str, Any]) -> None:
    """CPD: the predicted residue of each node, ``argmax`` of its logits."""
    _add(collector, np.argmax(logits, axis=-1), kept)


def _recovery(p: np.ndarray, l: np.ndarray) -> float:
    return float((p.astype(int) == l.astype(int)).mean()) if p.size else float("nan")


def _cosine3(p: np.ndarray, l: np.ndarray) -> float:
    return M.cosine_similarity(p.reshape(-1, 3), l.reshape(-1, 3))


def build_collect(model_name: str) -> Collect:
    task = _task(model_name)
    if task == "cpd":
        return Collect(_residue_keep, _add_argmax)
    keep = {"lba": _graph_keep, "psr": _graph_keep, "nms": _node_pos_keep, "rs": _graph_keep, "eq": _eq_keep,
            "ar": _node_pos_keep}[task]
    return Collect(keep, _add)


def build_metric_fns(model_name: str) -> Dict[str, Callable]:
    return {
        "lba": {"RMSE": M.rmse, "PearsonCorrCoef": M.pearson, "SpearmanCorrCoef": M.spearman},
        # "grouped": the per-target (local_*) and global correlations
        "psr": {
            "RMSE": M.rmse, "PearsonCorrCoef": M.pearson, "SpearmanCorrCoef": M.spearman,
            "grouped": M.grouped_correlations,
        },
        "nms": {"RMSE": M.rmse, "CosineSimilarity": _cosine3},
        "rs": {"Accuracy": M.accuracy, "F1": M.f1},
        "cpd": {"recovery_argmax": _recovery},
        "eq": {"RMSE": M.rmse, "PearsonCorrCoef": M.pearson},
        "ar": {"RMSE": M.rmse},
    }[_task(model_name)]
