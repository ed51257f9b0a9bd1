"""``_target_`` resolution: the port's copy of
``gcpnet_tpu/config/instantiate.py``.

``configs/`` names the JAX package's classes (``gcpnet_tpu.models.GCPNetLBA``,
``gcpnet_tpu.nn.gcp.GCP3``, ``gcpnet_tpu.data.atom3d.ATOM3DDataModule``,
``optax.adam``) and the reference's (``src.models.gcpnet_lba_module.
GCPNetLBALitModule``).  The port resolves each such string to its own class
by its short name, through its registries; it imports no module a target
names, so an unknown target raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict


def _optimizer(name: str) -> Callable:
    from gcpnet_torch.train.optim import build_optimizer

    def make(params, **cfg):
        return build_optimizer(params, {**cfg, "_target_": name})

    return make


def _targets() -> Dict[str, Any]:
    """Every class or factory a config may name, by short name."""
    from gcpnet_torch.data.registry import DATAMODULES
    from gcpnet_torch.models import MODEL_REGISTRY
    from gcpnet_torch.nn.gcp import GCP2, GCP3
    from gcpnet_torch.nn.interactions import LAYER_CLASSES
    from gcpnet_torch.train.trainer import Trainer
    from gcpnet_torch.utils.loggers import LOGGER_CLASSES

    return {
        **{name.rsplit(".", 1)[-1]: cls for name, cls in MODEL_REGISTRY.items()},
        "GCP2": GCP2, "GCP3": GCP3, **LAYER_CLASSES, **DATAMODULES, **LOGGER_CLASSES, "Trainer": Trainer,
        **{name: _optimizer(name) for name in ("adam", "adamw", "sgd", "Adam", "AdamW", "SGD")},
    }


def resolve_target(target: str):
    """The port's class (or factory) for ``target``, by its full string in
    the model registry or else by its last dotted component."""
    from gcpnet_torch.models import MODEL_REGISTRY

    if target in MODEL_REGISTRY:
        return MODEL_REGISTRY[target]
    short = target.rsplit(".", 1)[-1]
    known = _targets()
    if short not in known:
        raise ImportError(f"cannot resolve _target_ '{target}': the port has no {short!r}")
    return known[short]


def instantiate(cfg: Dict[str, Any], **kwargs):
    """Instantiate a config node carrying ``_target_`` (optionally
    ``_partial_``); its other values are passed through as they are."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        raise ValueError(f"instantiate() needs a dict with _target_, got {cfg!r}")
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    partial = bool(cfg.pop("_partial_", False))
    cls = resolve_target(str(target))
    cfg.update(kwargs)
    if partial:
        return functools.partial(cls, **cfg)
    return cls(**cfg)
