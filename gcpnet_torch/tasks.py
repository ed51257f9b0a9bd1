"""Task wiring: composed config -> (model, loss, metric collection).

The port's copy of ``gcpnet_tpu/tasks.py``: ``build_model`` builds a task
model from the composed ``model:`` block (the four-level schema
``model_cfg``/``module_cfg``/``layer_cfg{mp_cfg}``), ``build_loss`` gives
its loss, and the collect and metric functions read its predictions.
A collect function (:class:`Collect`) keeps what it reads of a batch and
adds the batch's host predictions and labels to a
:class:`~gcpnet_torch.train.metrics.Collector`; the metric functions run on
what it collected at the end of an evaluation epoch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg
from gcpnet_torch.device import DeviceLike
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.models import LOSS_REGISTRY, MODEL_REGISTRY
from gcpnet_torch.nn.interactions import LAYER_CLASSES
from gcpnet_torch.train import metrics as M

TASK_OF_MODEL = {"GCPNetLBA": "lba", "GCPNetPSR": "psr", "GCPNetCPD": "cpd", "GCPNetNMS": "nms", "GCPNetRS": "rs",
                 "GCPNetEQ": "eq", "GCPNetAR": "ar"}
MODEL_OF_TASK = {v: k for k, v in TASK_OF_MODEL.items()}


def model_name_from_target(target: str) -> str:
    """A config ``_target_``'s registry name (not the class's
    ``__name__``: GCPNetPSR keeps PSR's metrics)."""
    short = target.rsplit(".", 1)[-1]
    if short in TASK_OF_MODEL:
        return short
    # the reference's targets: src.models.gcpnet_psr_module.GCPNetPSRLitModule
    for key in TASK_OF_MODEL:
        if key.lower().replace("gcpnet", "") in short.lower():
            return key
    from gcpnet_torch.config.instantiate import resolve_target

    return resolve_target(target).__name__


def build_model(model_block: Dict[str, Any], seed: int = 42, device: DeviceLike = None) -> Tuple[torch.nn.Module, str]:
    """The task model of the composed ``model:`` block with weights drawn
    from ``seed`` on ``device`` (``None``: the card), and its registry name.
    ``layer_class._target_`` picks the trunk's interaction layer, any task
    either class (``GCPInteractions`` where the block names none), as in
    the JAX function.  CPD takes it and builds its encoder of
    ``GCPInteractions`` whatever it says, as the JAX CPD does
    (``gcpnet_tpu/models/cpd.py:53, 73-83``)."""
    name = model_name_from_target(str(model_block["_target_"]))
    layer_class = "GCPInteractions"
    lc = model_block.get("layer_class", {})
    if isinstance(lc, dict) and "_target_" in lc:
        layer_class = str(lc["_target_"]).rsplit(".", 1)[-1]
    if layer_class not in LAYER_CLASSES:
        raise ValueError(f"unknown layer_class {layer_class!r}: the port has {sorted(LAYER_CLASSES)}")
    kwargs: Dict[str, Any] = dict(
        model_cfg=ModelCfg.from_dict(model_block.get("model_cfg", {})),
        module_cfg=ModuleCfg.from_dict(model_block.get("module_cfg", {})),
        layer_cfg=LayerCfg.from_dict(model_block.get("layer_cfg", {})),
    )
    if name == "GCPNetCPD":
        kwargs["autoregressive_decoder"] = bool(model_block.get("autoregressive_decoder", False))
        for key in ("node_input_dims", "edge_input_dims"):
            if key in model_block:
                kwargs[key] = tuple(model_block[key])
    else:
        kwargs["layer_class"] = layer_class
    if name in ("GCPNetLBA", "GCPNetPSR"):
        kwargs["num_atom_types"] = int(model_block.get("num_atom_types", 9))
    model = MODEL_REGISTRY[name](**kwargs, generator=torch.Generator().manual_seed(seed), device=device)
    return model, name


def build_loss(model_name: str) -> Callable:
    return LOSS_REGISTRY[model_name]


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
