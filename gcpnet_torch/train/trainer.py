"""The training orchestrator: epochs, evaluation, checkpoints, early stopping.

Port of ``gcpnet_tpu/train/trainer.py:137-712`` for one device (the device
of the model's parameters):

- ``train_epoch`` runs :func:`train_step` over the batches; the losses stay
  on the device and are fetched once, at the end of the epoch, for their
  mean (``train/loss``), beside ``train/steps_per_sec``;
- a host thread makes the next batch's tensors ahead of the step, in pinned
  memory, and starts their copy to the card without blocking; an exception
  in that thread reaches the caller;
- ``eval_epoch`` gives ``<prefix>/loss`` (the mean of the batch losses) and
  the task's metrics over the collected predictions; a metric that fails is
  logged, not raised;
- ``fit`` resumes from the last checkpoint when asked, validates every
  ``check_val_every_n_epoch`` epochs, keeps the best ``save_top_k``
  checkpoints by ``monitor``, feeds a ReduceLROnPlateau schedule
  (``lr_scale``) and stops early after ``min_epochs``;
- StepLR folds into the optimizer's schedule (``train.optim``), stepped
  once per applied update;
- ``precision`` 32 computes in float32, 16 in bf16 over float32 masters.

Two differences from the JAX trainer.  A resumed ``fit`` goes on from the
epoch after the checkpoint's (the JAX one counts its epochs from 0 again),
so that fitting two epochs and resuming for a third gives the three-epoch
run; and every epoch's end writes the last checkpoint, validated or not.
The JAX trainer's ``scan_chunk_size`` (one dispatch per chunk of steps) has
no counterpart yet: it comes with capturing the step in a CUDA graph.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch

from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.train.metrics import Collector
from gcpnet_torch.train.optim import PlateauController, build_optimizer, build_schedule
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import LossFn, eval_step, train_step

log = logging.getLogger(__name__)


def prefetched(items: Iterable, depth: int = 2) -> Iterator:
    """Yield from ``items``, which a background thread runs up to ``depth``
    items ahead; an exception raised there is raised here.  Closing the
    iterator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    errors: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as exc:  # re-raised in the consumer
            errors.append(exc)
        finally:
            put(done)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        thread.join()


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn: LossFn,
        optimizer_cfg: Optional[Dict[str, Any]] = None,
        scheduler_cfg: Optional[Dict[str, Any]] = None,
        max_epochs: int = 1,
        adaptive_clip: bool = False,
        clip_std_multiplier: float = 2.0,
        checkpoint_dir: Optional[str] = None,
        monitor: str = "val/loss",
        monitor_mode: str = "min",
        early_stopping_patience: Optional[int] = 10,
        save_top_k: int = 30,
        seed: int = 42,
        collect_fn: Optional[Callable] = None,
        metric_fns: Optional[Dict[str, Callable]] = None,
        log_dir: Optional[str] = None,
        max_steps_per_epoch: Optional[int] = None,
        min_epochs: int = 0,
        check_val_every_n_epoch: int = 1,
        loggers: Optional[list] = None,
        precision: int = 32,
        checkpoint_every_n_steps: Optional[int] = None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.loss_fn = loss_fn
        self.max_epochs = max_epochs
        self.min_epochs = min_epochs
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch)
        self.max_steps_per_epoch = max_steps_per_epoch
        self.monitor = monitor
        self.monitor_mode = monitor_mode
        self.early_stopping_patience = early_stopping_patience
        self.collect_fn = collect_fn
        self.metric_fns = metric_fns or {}
        self.log_dir = log_dir
        self.loggers = loggers or []

        optimizer_cfg = optimizer_cfg or {"_target_": "Adam", "lr": 1e-4}
        optimizer = build_optimizer(model.parameters(), optimizer_cfg)
        try:
            scheduler = build_schedule(optimizer, scheduler_cfg)
        except ValueError as exc:  # as the JAX trainer: an unknown schedule is left out
            log.warning(f"scheduler ignored: {exc}")
            scheduler = None
        self.plateau = None
        if scheduler_cfg and "plateau" in str(scheduler_cfg.get("_target_", "")).lower():
            self.plateau = PlateauController(
                factor=float(scheduler_cfg.get("factor", 0.1)),
                patience=int(scheduler_cfg.get("patience", 10)),
                mode=scheduler_cfg.get("mode", "min"),
            )
        half = precision in (16, "16", "bf16")
        self.state = TrainState(
            optimizer,
            ring=GradNormRing(device=self.device) if adaptive_clip else None,
            compute_dtype=torch.bfloat16 if half else torch.float32,
            clip_std_multiplier=clip_std_multiplier,
            scheduler=scheduler,
        )
        # dropout masks: one stream from the seed, carried in checkpoints
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)

        self.ckpt = None
        self.checkpoint_every_n_steps = checkpoint_every_n_steps
        if checkpoint_dir:
            self.ckpt = CheckpointManager(
                checkpoint_dir, max_to_keep=save_top_k, monitor=monitor, mode=monitor_mode
            )
        self._last_step_ckpt = 0
        self.epoch = 0  # the next epoch fit runs
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.history: Dict[str, list] = {}

    # ------------------------------------------------------------------
    def _device_batches(self, batches: Iterable[GraphBatch], limit: Optional[int] = None):
        """Host batches -> device batches, made in the prefetch thread."""

        def items():
            for i, batch in enumerate(batches):
                if limit is not None and i >= limit:
                    return
                yield batch, batch.to(self.device, non_blocking=True)

        return prefetched(items(), depth=2)

    def train_epoch(self, batches: Iterable[GraphBatch], epoch: int) -> Dict[str, float]:
        lr_scale = self.plateau.scale if self.plateau else 1.0
        losses = []
        t0 = time.perf_counter()
        for _, batch in self._device_batches(batches, self.max_steps_per_epoch):
            result = train_step(
                self.model, self.state, batch, self.loss_fn, self.generator, lr_scale=lr_scale
            )
            losses.append(result.loss)
        # step-frequency checkpoints (the reference's NStepModelCheckpoint)
        if self.ckpt is not None and self.checkpoint_every_n_steps:
            if self.state.step - self._last_step_ckpt >= self.checkpoint_every_n_steps:
                self._last_step_ckpt = self.state.step
                self.ckpt.save(self.state.step, self.checkpoint_state(), {"step": float(self.state.step)})
        # one fetch of the epoch's losses, which also waits for its steps
        mean = torch.stack(losses).mean().item() if losses else float("nan")
        dt = time.perf_counter() - t0
        return {"train/loss": mean, "train/steps_per_sec": len(losses) / max(dt, 1e-9)}

    def eval_epoch(self, batches: Iterable[GraphBatch], prefix: str = "val") -> Dict[str, float]:
        losses, outs = [], []
        for host, batch in self._device_batches(batches):
            loss, preds = eval_step(self.model, batch, self.loss_fn)
            losses.append(loss)
            outs.append((preds, host))
        metrics = {f"{prefix}/loss": torch.stack(losses).mean().item() if losses else float("nan")}
        if self.collect_fn is not None and self.metric_fns:
            collector = Collector()
            for preds, host in outs:
                self.collect_fn(collector, preds.float().cpu().numpy(), host)
            p, labels, groups = collector.cat()
            for name, fn in self.metric_fns.items():
                try:
                    if name == "grouped":
                        for k, v in fn(p, labels, groups).items():
                            metrics[f"{prefix}/{k}"] = v
                    else:
                        metrics[f"{prefix}/{name}"] = fn(p, labels)
                except Exception as exc:  # a metric's failure must not end the fit
                    log.warning(f"metric {name} failed: {exc!r}")
        return metrics

    # ------------------------------------------------------------------
    def checkpoint_state(self) -> dict:
        """Everything a resumed fit needs to go on as if never stopped."""
        ring = self.state.ring
        return {
            "step": self.state.step,
            "epoch": self.epoch,
            "model": self.model.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "scheduler": None if self.state.scheduler is None else self.state.scheduler.state_dict(),
            "ring": None if ring is None else {"buffer": ring.buffer, "count": ring.count, "head": ring.head},
            "generator": self.generator.get_state(),
            "best": self.best,
            "bad_epochs": self.bad_epochs,
            "plateau": None if self.plateau is None else dict(vars(self.plateau)),
            "last_step_ckpt": self._last_step_ckpt,
        }

    def load_checkpoint_state(self, ckpt: dict) -> None:
        self.model.load_state_dict(ckpt["model"])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        if self.state.scheduler is not None:
            self.state.scheduler.load_state_dict(ckpt["scheduler"])
        if self.state.ring is not None:
            ring = ckpt["ring"]
            self.state.ring.buffer.copy_(ring["buffer"])
            self.state.ring.count = ring["count"].to(self.device)
            self.state.ring.head = ring["head"].to(self.device)
        self.generator.set_state(ckpt["generator"].cpu())
        if self.plateau is not None:
            vars(self.plateau).update(ckpt["plateau"])
        self.state.step = ckpt["step"]
        self.epoch = ckpt["epoch"]
        self.best, self.bad_epochs = ckpt["best"], ckpt["bad_epochs"]
        self._last_step_ckpt = ckpt["last_step_ckpt"]

    def restore_best(self) -> Optional[int]:
        """Load the best checkpoint's state; its step, or None if there is none."""
        ckpt = None if self.ckpt is None else self.ckpt.restore_best(map_location=self.device)
        if ckpt is None:
            return None
        self.load_checkpoint_state(ckpt)
        return ckpt["step"]

    # ------------------------------------------------------------------
    def fit(self, datamodule, resume: bool = False) -> Dict[str, float]:
        if resume and self.ckpt is not None:
            ckpt = self.ckpt.restore_last(map_location=self.device)
            if ckpt is not None:
                self.load_checkpoint_state(ckpt)
                log.info(f"resumed from step {self.state.step}, epoch {self.epoch}")
        final: Dict[str, float] = {}
        for epoch in range(self.epoch, self.max_epochs):
            metrics = {**self.train_epoch(datamodule.train_batches(seed=epoch), epoch), "epoch": epoch}
            if epoch % self.check_val_every_n_epoch == 0:
                metrics.update(self.eval_epoch(datamodule.val_batches(), prefix="val"))
            self._log_metrics(metrics)
            final = metrics
            self.epoch = epoch + 1

            stop = False
            monitored = metrics.get(self.monitor)
            finite = monitored is not None and math.isfinite(monitored)
            if finite:
                if self.plateau is not None:
                    self.plateau.update(monitored)
                improved = self.best is None or (
                    monitored < self.best if self.monitor_mode == "min" else monitored > self.best
                )
                if improved:
                    self.best, self.bad_epochs = monitored, 0
                else:
                    self.bad_epochs += 1
                    stop = (
                        self.early_stopping_patience is not None
                        and epoch >= self.min_epochs
                        and self.bad_epochs > self.early_stopping_patience
                    )
            if self.ckpt is not None:
                if finite:
                    self.ckpt.save(self.state.step, self.checkpoint_state(), metrics)
                else:
                    self.ckpt.write_last(self.checkpoint_state())
            if stop:
                log.info(f"early stopping at epoch {epoch}")
                break
        return final

    def test(self, datamodule) -> Dict[str, float]:
        metrics = self.eval_epoch(datamodule.test_batches(), prefix="test")
        self._log_metrics(metrics)
        return metrics

    def _log_metrics(self, metrics: Dict[str, float]) -> None:
        log.info(" | ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}" for k, v in sorted(metrics.items())
        ))
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(v)
        for logger in self.loggers:
            try:
                logger.log_metrics(metrics, step=self.state.step)
            except Exception as exc:  # a logger's failure must not end the fit
                log.warning(f"logger failed: {exc!r}")
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, "metrics.csv")
            write_header = not os.path.exists(path)
            with open(path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=sorted(metrics.keys()))
                if write_header:
                    writer.writeheader()
                writer.writerow(metrics)
