"""Datamodule construction from composed config blocks: the port's copy of
``gcpnet_tpu/data/registry.py``.

Maps the datamodule blocks of ``configs/datamodule/*.yaml`` onto the port's
NMS, ATOM3D (LBA and PSR), CATH, RS, EQ and AR datamodules, for one
device.  The torch loader knobs (``num_workers``, ``pin_memory``) mean
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
    "max_units": 0, "python_exec_path": None, "pdbtools_dir": None, "lddt_exec_path": None,
    "subset_to_ca_atoms_only": False, "force_process_data": False, "load_only_unprocessed_examples": False,
    "sample_1_conformer": False, "select_N_enantiomers": None, "mask_coordinates": False, "grouping": "none",
    "stratified": False, "without_replacement": True,
}
# taken by the JAX datamodule and read by neither package
UNREAD = {"max_tmscore_metric_threshold"}


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


def build_datamodule(block: Dict[str, Any], seed: int = 42, device: DeviceLike = None):
    """The port's datamodule of a composed ``datamodule:`` block; ``seed``
    where the block sets none, ``device`` for NMS's simulator."""
    target = str(block.get("_target_", "")).rsplit(".", 1)[-1]
    if target not in DATAMODULES:
        raise ValueError(f"unknown datamodule target {target!r}")
    cls = DATAMODULES[target]
    params = inspect.signature(cls).parameters
    any_key = any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
    renames = RENAMES.get(target, {})
    kwargs: Dict[str, Any] = {}
    for key, value in block.items():
        if key.startswith("_") or key in DROPPED or key in UNREAD:
            continue
        if key in INERT or (key == "unit" and not block.get("max_units")):
            if key != "unit" and value != INERT[key]:
                raise ValueError(f"{target}: {key}={value!r} is not ported (the port takes {key}={INERT[key]!r})")
            continue
        name = renames.get(key, key)
        if name not in params and not any_key:
            raise ValueError(f"{target} of the port takes no {key!r}")
        kwargs[name] = _typed(value, params[name].default) if name in params else value
    if "seed" in params and kwargs.get("seed") is None:
        kwargs["seed"] = seed
    if "sim_device" in params:
        kwargs.setdefault("sim_device", device)
    return cls(**kwargs)
