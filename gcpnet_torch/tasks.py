"""Task wiring: the metric collection of each task model.

The port's copy of the collect and metric functions of
``gcpnet_tpu/tasks.py`` for the task models ported so far (LBA, NMS and
RS).
A collect function adds one batch's host predictions and labels to a
:class:`~gcpnet_torch.train.metrics.Collector`; the metric functions run on
what it collected at the end of an evaluation epoch.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train import metrics as M

TASK_OF_MODEL = {"GCPNetLBA": "lba", "GCPNetNMS": "nms", "GCPNetRS": "rs"}


def _task(model_name: str) -> str:
    if model_name not in TASK_OF_MODEL:
        raise NotImplementedError(f"task model {model_name!r} is not ported yet")
    return TASK_OF_MODEL[model_name]


def _graph_collect(collector: M.Collector, out: np.ndarray, batch: GraphBatch) -> None:
    collector.add(
        out, batch.extras["label"], mask=batch.graph_pad_mask, groups=batch.extras.get("target_id")
    )


def _node_pos_collect(collector: M.Collector, out: np.ndarray, batch: GraphBatch) -> None:
    mask3 = np.repeat(np.asarray(batch.valid_node_mask()), 3)
    collector.add(out, batch.extras["label"], mask=mask3)


def _cosine3(p: np.ndarray, l: np.ndarray) -> float:
    return M.cosine_similarity(p.reshape(-1, 3), l.reshape(-1, 3))


def build_collect(model_name: str) -> Callable:
    return {"lba": _graph_collect, "nms": _node_pos_collect, "rs": _graph_collect}[_task(model_name)]


def build_metric_fns(model_name: str) -> Dict[str, Callable]:
    return {
        "lba": {"RMSE": M.rmse, "PearsonCorrCoef": M.pearson, "SpearmanCorrCoef": M.spearman},
        "nms": {"RMSE": M.rmse, "CosineSimilarity": _cosine3},
        "rs": {"Accuracy": M.accuracy, "F1": M.f1},
    }[_task(model_name)]
