"""Datamodule construction from composed config blocks: the port's copy of
``gcpnet_tpu/data/registry.py``.

Maps the datamodule blocks of ``configs/datamodule/*.yaml`` onto the port's
NMS, ATOM3D (LBA and PSR), CATH, RS, EQ and AR datamodules, each reading
this process's shard of every global batch (``batching.Shards``, the JAX
function's ``num_shards``).  The torch loader knobs (``num_workers``, ``pin_memory``) mean
nothing to the port's host pipeline and are dropped, as the JAX function
drops them.  A key that switches off a feature of the JAX datamodules that
the port lacks is taken at that value only.  Any other key must be one the
port's datamodule takes: an unknown key raises, naming it.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

from gcpnet_torch.data.ar import ARDataModule
from gcpnet_torch.data.atom3d import ATOM3DDataModule
from gcpnet_torch.data.batching import Shards
from gcpnet_torch.data.cath import CATHDataModule
from gcpnet_torch.data.eq import EQDataModule
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.device import DeviceLike

DATAMODULES = {
    "NMSDataModule": NMSDataModule,
    "ATOM3DDataModule": ATOM3DDataModule,
    "CATHDataModule": CATHDataModule,
    "RSDataModule": RSDataModule,
    "EQDataModule": EQDataModule,
    "ARDataModule": ARDataModule,
}

# config keys under another name in the port's constructor
RENAMES = {"NMSDataModule": {"data_dir": "data_root", "frame_O": "frame_0"}, "RSDataModule": {"D_max": "d_max"}}
# read by the torch data loaders of the reference, or by the predict entry point
DROPPED = {"num_workers", "pin_memory", "predict_batch_size", "predict_pin_memory", "predict_output_dir"}
# keys of the JAX datamodules, at the value that leaves their feature off
INERT = {
    "python_exec_path": None, "pdbtools_dir": None, "force_process_data": False,
    "load_only_unprocessed_examples": False, "select_N_enantiomers": None,
}
# keys that neither package reads, taken at any value: AR's
# ``max_tmscore_metric_threshold``; RS's ``sample_1_conformer`` and
# ``mask_coordinates`` (the JAX datamodule stores them) and ``grouping``,
# ``stratified`` and ``without_replacement`` (the JAX registry passes them
# nowhere): both packages' samplers always draw stratified and without
# replacement, so ``stratified: false`` in ``configs/datamodule/rs.yaml``
# takes no effect
UNREAD = {
    "max_tmscore_metric_threshold", "sample_1_conformer", "mask_coordinates", "grouping", "stratified",
    "without_replacement",
}
# a datamodule's keys that the JAX registry does not pass on: NMS takes no
# unit budget
UNREAD_BY = {"NMSDataModule": {"max_units", "unit"}}


def _typed(value, default):
    """``value`` as the type of the constructor's ``default`` where that is
    a number (the YAML loader reads ``1e-4`` as a string)."""
    if isinstance(default, bool) or value is None:
        return value
    if isinstance(default, float):
        return float(value)
    if isinstance(default, int) and isinstance(value, str):
        return int(value)
    return value


def build_datamodule(block: Dict[str, Any], seed: int = 42, device: DeviceLike = None, shards: Shards = Shards()):
    """The port's datamodule of a composed ``datamodule:`` block; ``seed``
    where the block sets none, ``device`` for NMS's simulator and the ESM-2
    of EQ and AR, ``shards`` this process's share of each batch."""
    target = str(block.get("_target_", "")).rsplit(".", 1)[-1]
    if target not in DATAMODULES:
        raise ValueError(f"unknown datamodule target {target!r}")
    cls = DATAMODULES[target]
    params = inspect.signature(cls).parameters
    any_key = any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
    renames = RENAMES.get(target, {})
    kwargs: Dict[str, Any] = {}
    for key, value in block.items():
        if key.startswith("_") or key in DROPPED or key in UNREAD or key in UNREAD_BY.get(target, ()):
            continue
        if key in INERT:
            if value != INERT[key]:
                raise ValueError(f"{target}: {key}={value!r} is not ported (the port takes {key}={INERT[key]!r})")
            continue
        name = renames.get(key, key)
        if name not in params and not any_key:
            raise ValueError(f"{target} of the port takes no {key!r}")
        kwargs[name] = _typed(value, params[name].default) if name in params else value
    if "seed" in params and kwargs.get("seed") is None:
        kwargs["seed"] = seed
    for name in ("sim_device", "esm_device"):
        if name in params:
            kwargs.setdefault(name, device)
    return cls(**kwargs, shards=shards)
