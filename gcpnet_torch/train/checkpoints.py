"""Checkpoints with best-k retention.

Port of ``gcpnet_tpu/train/checkpoints.py:21-86`` in the port's own format:
each checkpoint is one ``torch.save`` file of the state dict the trainer
gives (model, optimizer, schedule, gradient-norm ring, step counter,
generator states), read back with ``weights_only=True``.  An index
(``checkpoints.json``) keeps each checkpoint's step and metrics.

- :meth:`CheckpointManager.save` keeps the ``max_to_keep`` best checkpoints
  by the ``monitor`` metric (``mode`` "min" or "max"); a checkpoint saved
  without that metric (the trainer's ``checkpoint_every_n_steps`` saves) is
  kept besides them, also when a later save of its step adds the metric;
- every save also writes ``last.pt``, which :meth:`restore_last` reads
  (and :meth:`write_last` writes it alone).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

INDEX = "checkpoints.json"
LAST = "last.pt"


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        max_to_keep: int = 30,
        monitor: str = "val/loss",
        mode: str = "min",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"CheckpointManager: mode {mode!r} is not 'min' or 'max'")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self._entries: List[dict] = []
        self.reload()

    def reload(self) -> None:
        """Read the index from the directory (another process may have
        saved since this one last did)."""
        path = os.path.join(self.directory, INDEX)
        if os.path.exists(path):
            with open(path) as f:
                self._entries = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def _ranked(self, pinned: bool = True) -> List[dict]:
        """The entries that carry the monitored metric, best first (without
        the pinned ones unless ``pinned``)."""
        ranked = [e for e in self._entries if self.monitor in e["metrics"] and (pinned or not e["pinned"])]
        return sorted(ranked, key=lambda e: e["metrics"][self.monitor], reverse=self.mode == "max")

    @property
    def steps(self) -> List[int]:
        return sorted(e["step"] for e in self._entries)

    @property
    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[0]["step"] if ranked else None

    def save(self, step: int, state: dict, metrics: dict) -> None:
        """Write ``state`` as the checkpoint of ``step`` with its finite
        numeric ``metrics``, prune to the best ``max_to_keep`` (checkpoints
        without the monitored metric are kept besides), and write
        ``last.pt``."""
        clean = {
            k: float(v)
            for k, v in metrics.items()
            if isinstance(v, (int, float, np.floating, np.integer)) and np.isfinite(v)
        }
        _atomic_save(state, self._path(step))
        old = [e for e in self._entries if e["step"] == step]
        pinned = self.monitor not in clean or any(e["pinned"] for e in old)
        self._entries = [e for e in self._entries if e["step"] != step]
        self._entries.append({"step": step, "metrics": clean, "pinned": pinned})
        for dropped in self._ranked(pinned=False)[self.max_to_keep :]:
            os.remove(self._path(dropped["step"]))
            self._entries.remove(dropped)
        with open(os.path.join(self.directory, INDEX), "w") as f:
            json.dump(self._entries, f)
        self.write_last(state)

    def write_last(self, state: dict) -> None:
        _atomic_save(state, os.path.join(self.directory, LAST))

    def _load(self, path: str, map_location) -> dict:
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore(self, step: Optional[int] = None, map_location=None) -> Optional[dict]:
        """The state saved at ``step`` (default: the latest kept), or None."""
        if step is None:
            if not self._entries:
                return None
            step = max(e["step"] for e in self._entries)
        return self._load(self._path(step), map_location)

    def restore_best(self, map_location=None) -> Optional[dict]:
        step = self.best_step
        return None if step is None else self.restore(step, map_location)

    def restore_last(self, map_location=None) -> Optional[dict]:
        path = os.path.join(self.directory, LAST)
        if not os.path.exists(path):
            return self.restore(map_location=map_location)
        return self._load(path, map_location)

    def metrics(self, step: int) -> Dict[str, float]:
        """The metrics saved with ``step``'s checkpoint."""
        return next(e["metrics"] for e in self._entries if e["step"] == step)
