"""Optimizer and LR-schedule factories.

Port of ``gcpnet_tpu/train/optim.py``: the reference's optimizer block
(``{_target_, lr, weight_decay, ...}``), StepLR, host-side
ReduceLROnPlateau, and ``accumulate_grad_batches``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch


class GradientAccumulation:
    """``optax.MultiSteps``: every call adds the gradients to a running sum;
    every ``every_k``-th call the wrapped optimizer steps once on their mean
    and the sum starts again.  :meth:`step` returns whether it applied an
    update, so that an LR schedule counts updates, not mini-steps."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = every_k
        self.mini_step = 0
        self._sums: Optional[list] = None

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        params = self._params()
        if self._sums is None:
            self._sums = [torch.zeros_like(p) for p in params]
        for total, p in zip(self._sums, params):
            if p.grad is not None:
                total.add_(p.grad)
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        for total, p in zip(self._sums, params):
            p.grad = total / self.every_k
            total.zero_()
        self.optimizer.step()
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {
            "optimizer": self.optimizer.state_dict(),
            "mini_step": self.mini_step,
            "sums": None if self._sums is None else [s.clone() for s in self._sums],
        }

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.mini_step = state["mini_step"]
        sums = state["sums"]
        self._sums = None if sums is None else [
            s.to(p.device) for s, p in zip(sums, self._params())
        ]


def build_optimizer(params: Iterable[torch.Tensor], cfg: Dict[str, Any]):
    """``cfg`` mirrors the reference optimizer block: ``{_target_, lr,
    weight_decay, beta1, beta2, momentum, accumulate_grad_batches}``."""
    name = str(cfg.get("_target_", "torch.optim.Adam")).rsplit(".", 1)[-1].lower()
    lr = float(cfg.get("lr", 1e-4))
    weight_decay = float(cfg.get("weight_decay", 0.0))
    params = list(params)
    if name == "adam":
        # coupled L2: the decay joins the gradient before the moments, as
        # optax's add_decayed_weights + adam does
        opt = torch.optim.Adam(
            params, lr=lr, weight_decay=weight_decay,
            betas=(float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999))),
        )
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=float(cfg.get("momentum", 0.0)))
    else:
        raise ValueError(f"unsupported optimizer {name!r}")
    accumulate = int(cfg.get("accumulate_grad_batches", 1) or 1)
    return GradientAccumulation(opt, accumulate) if accumulate > 1 else opt


def _eval_arith(value) -> float:
    """Simple arithmetic in config values (``step_size: 80 // 8``)."""
    if isinstance(value, (int, float)):
        return value
    text = str(value)
    if not all(c in "0123456789.+-*/() e" for c in text):
        raise ValueError(f"unsupported arithmetic expression {text!r}")
    return eval(text, {"__builtins__": {}}, {})  # noqa: S307 - sanitized


def build_schedule(
    optimizer: torch.optim.Optimizer, scheduler_cfg: Optional[Dict[str, Any]]
) -> Optional[torch.optim.lr_scheduler.StepLR]:
    """StepLR, stepped once per optimizer update (the optax schedule counts
    updates; under :class:`GradientAccumulation` the train step steps it
    only when the accumulated update was applied); ``None`` without a
    schedule or for ReduceLROnPlateau, which runs on the host
    (:class:`PlateauController`)."""
    if not scheduler_cfg:
        return None
    name = str(scheduler_cfg.get("_target_", "")).rsplit(".", 1)[-1].lower()
    if name == "steplr":
        inner = getattr(optimizer, "optimizer", optimizer)
        return torch.optim.lr_scheduler.StepLR(
            inner,
            step_size=int(_eval_arith(scheduler_cfg["step_size"])),
            gamma=float(scheduler_cfg.get("gamma", 0.9)),
        )
    if name == "reducelronplateau":
        return None
    raise ValueError(f"unsupported scheduler {name!r}")


class PlateauController:
    """Host-side ReduceLROnPlateau: tracks the monitored metric per epoch
    and yields the LR scale that the train step applies (``lr_scale``)."""

    def __init__(self, factor: float = 0.1, patience: int = 10, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, value: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale
