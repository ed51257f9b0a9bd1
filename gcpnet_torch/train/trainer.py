"""The training orchestrator: epochs, evaluation, checkpoints, early stopping.

Port of ``gcpnet_tpu/train/trainer.py:137-712`` for one device (the device
of the model's parameters):

- ``train_epoch`` runs the training step over the batches, in chunks of
  ``scan_chunk_size`` as the JAX loops do (``trainer.py:450-533``): each
  full chunk of k batches is one dispatch of k steps and the tail runs
  step by step; the losses stay on the device and are fetched once, at
  the end of the epoch, for ``train/loss``, the average of the chunks'
  mean losses weighted by their steps, beside ``train/steps_per_sec``;
- on the card a dispatch is the replay of a CUDA graph that holds the
  chunk's steps (``train.graphs``; one graph per sequence of batch
  shapes), and the step reads nothing back to the host; on the CPU a
  chunk is its steps run eagerly (:func:`train_step`), with the same loop
  and weighting;
- a host thread makes the next batches' tensors ahead of the step, in
  pinned memory, from which a replay's input slots are filled without
  blocking (the eager steps copy them to the device themselves); an
  exception in that thread reaches the caller;
- ``eval_epoch`` gives ``<prefix>/loss`` (the mean of the batch losses)
  and the task's metrics over the collected predictions, chunked as
  ``train_epoch`` is (``trainer.py:565-610``); until the epoch's end it
  keeps each batch's predictions on the device and what the task's
  collect function keeps of the batch (``tasks.Collect.keep``), not the
  batch; a metric that fails is logged, not raised;
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
"""

from __future__ import annotations

import csv
import logging
import math
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.train.graphs import EvalSteps, TrainSteps
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
        scan_chunk_size: int = 1,
    ):
        """``scan_chunk_size`` as the JAX trainer's (``trainer.py:164-167``);
        ``collect_fn`` a task's :class:`~gcpnet_torch.tasks.Collect`."""
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
        self.scan_chunk_size = max(1, int(scan_chunk_size))

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
            lr_scale=torch.ones((), dtype=torch.float64, device=self.device),
        )
        # dropout masks: one stream from the seed, carried in checkpoints
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)
        self.train_graphs = self.eval_graphs = None
        if self.device.type == "cuda":
            self.train_graphs = TrainSteps(model, self.state, loss_fn, self.generator)
            self.eval_graphs = EvalSteps(model, loss_fn)

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
    def _staged(self, batches: Iterable[GraphBatch], limit: Optional[int] = None):
        """``(host batch, staged batch)`` pairs, made in the prefetch
        thread: pinned host tensors that a replay copies into its slots, or
        on the CPU the batch's tensors on the device."""

        def items():
            for i, batch in enumerate(batches):
                if limit is not None and i >= limit:
                    return
                if self.train_graphs is not None:
                    yield batch, batch.pinned()
                else:
                    yield batch, batch.to(self.device, non_blocking=True)

        return prefetched(items(), depth=2)

    def _chunks(self, items: Iterable) -> Iterator[List]:
        """Runs of ``scan_chunk_size`` consecutive items, then the tail's
        items one by one (the JAX loops' split)."""
        chunk: List = []
        for item in items:
            chunk.append(item)
            if len(chunk) == self.scan_chunk_size:
                yield chunk
                chunk = []
        for item in chunk:
            yield [item]

    def train_epoch(self, batches: Iterable[GraphBatch], epoch: int) -> Dict[str, float]:
        self.state.lr_scale.fill_(self.plateau.scale if self.plateau else 1.0)
        losses, weights = [], []
        t0 = time.perf_counter()
        for chunk in self._chunks(self._staged(batches, self.max_steps_per_epoch)):
            staged = [b for _, b in chunk]
            if self.train_graphs is not None:
                chunk_losses = self.train_graphs(staged).loss
            else:
                chunk_losses = torch.stack([
                    train_step(self.model, self.state, b, self.loss_fn, self.generator).loss for b in staged
                ])
            losses.append(chunk_losses.mean())
            weights.append(len(chunk))
        # step-frequency checkpoints (the reference's NStepModelCheckpoint)
        if self.ckpt is not None and self.checkpoint_every_n_steps:
            if self.state.step - self._last_step_ckpt >= self.checkpoint_every_n_steps:
                self._last_step_ckpt = self.state.step
                self.ckpt.save(self.state.step, self.checkpoint_state(), {"step": float(self.state.step)})
        # one fetch of the epoch's losses, which also waits for its steps
        mean = float(np.average(torch.stack(losses).cpu().numpy(), weights=weights)) if losses else float("nan")
        dt = time.perf_counter() - t0
        return {"train/loss": mean, "train/steps_per_sec": sum(weights) / max(dt, 1e-9)}

    def _eval_chunk(self, chunk: List) -> tuple:
        """A chunk's losses and, per batch, its predictions on the device
        with what the collect function keeps of its host batch (not the
        batch)."""
        staged = [b for _, b in chunk]
        if self.eval_graphs is not None:
            losses, preds = self.eval_graphs(staged)
        else:
            results = [eval_step(self.model, b, self.loss_fn) for b in staged]
            losses, preds = torch.stack([r[0] for r in results]), [r[1] for r in results]
        keep = self.collect_fn.keep if self.collect_fn is not None else (lambda host: None)
        return losses, list(zip(preds, (keep(host) for host, _ in chunk)))

    def eval_epoch(self, batches: Iterable[GraphBatch], prefix: str = "val") -> Dict[str, float]:
        losses, outs = [], []
        # no chunk outlives its step: the epoch keeps predictions and what
        # the collect function keeps of each batch
        for chunk_losses, kept in map(self._eval_chunk, self._chunks(self._staged(batches))):
            losses.append(chunk_losses)
            outs.extend(kept)
        metrics = {f"{prefix}/loss": float(np.mean(torch.cat(losses).cpu().numpy(), dtype=np.float64)) if losses else float("nan")}
        if self.collect_fn is not None and self.metric_fns:
            collector = Collector()
            for preds, kept in outs:
                self.collect_fn.add(collector, preds.float().cpu().numpy(), kept)
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
        """Copy ``ckpt`` into the live state, in place; the captured graphs
        are dropped and captured again at their next call."""
        self.model.load_state_dict(ckpt["model"])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        if self.state.scheduler is not None:
            self.state.scheduler.load_state_dict(ckpt["scheduler"])
        if self.state.ring is not None:
            ring = ckpt["ring"]
            self.state.ring.buffer.copy_(ring["buffer"])
            self.state.ring.count.copy_(ring["count"])
            self.state.ring.head.copy_(ring["head"])
        self.generator.set_state(ckpt["generator"].cpu())
        if self.plateau is not None:
            vars(self.plateau).update(ckpt["plateau"])
        self.state.step = ckpt["step"]
        self.epoch = ckpt["epoch"]
        self.best, self.bad_epochs = ckpt["best"], ckpt["bad_epochs"]
        self._last_step_ckpt = ckpt["last_step_ckpt"]
        for graphs in (self.train_graphs, self.eval_graphs):
            if graphs is not None:
                graphs.call.clear()

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
