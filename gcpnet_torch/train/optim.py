"""Optimizer and LR-schedule factories whose state lives on the device.

Port of ``gcpnet_tpu/train/optim.py``: the reference's optimizer block
(``{_target_, lr, weight_decay, ...}``), StepLR, host-side
ReduceLROnPlateau, and ``accumulate_grad_batches``.

Every update is a function of device tensors only, as the JAX step's is
(``gcpnet_tpu/train/trainer.py:302-323``): the learning rate and its
scale, the step count, the moments, the schedule's count and the flag
``ok`` that says whether the step's loss and gradient norm were finite.
Nothing is read back to the host and every state tensor is updated in
place, so that a CUDA graph captured around a training step replays it
(``train.graphs``).  Adam, AdamW and SGD follow optax's formulas, which the
JAX package runs; a step that is not ``ok`` moves no parameter, moment,
count or schedule.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
from torch import Tensor


def _flag(ok: Optional[Tensor], like: Tensor) -> Tensor:
    """``ok`` as a boolean 0-d tensor on ``like``'s device (True when ``None``)."""
    if ok is None:
        return torch.ones((), dtype=torch.bool, device=like.device)
    return ok


def _move_toward(tensors: List[Tensor], targets: List[Tensor], weight: Tensor) -> None:
    """``t += weight * (target - t)`` for each pair, ``weight`` a 0-d device
    tensor (``targets`` finite: a weight of 0 leaves ``t`` as it is)."""
    diffs = torch._foreach_sub(targets, tensors)
    torch._foreach_mul_(diffs, weight)
    torch._foreach_add_(tensors, diffs)


class DeviceOptimizer:
    """One parameter group updated from the parameters' ``.grad`` by device
    tensors alone.  ``param_groups[0]["lr"]`` is the scheduled rate, a
    float64 0-d device tensor that a schedule writes in place; ``state``
    maps each parameter to its state tensors, as a torch optimizer's does."""

    def __init__(self, params: Iterable[Tensor], lr: float):
        self.params: List[Tensor] = list(params)
        if not self.params:
            raise ValueError("optimizer: no parameters")
        self.base_lr = float(lr)
        self.lr = torch.full((), self.base_lr, dtype=torch.float64, device=self.params[0].device)
        self.param_groups = [{"params": self.params, "lr": self.lr}]
        self.state: Dict[Tensor, Dict[str, Tensor]] = {p: {} for p in self.params}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, ok: Optional[Tensor] = None, lr_scale: Optional[Tensor] = None) -> Tensor:
        """Apply one update from the gradients where ``ok`` holds (always
        when ``None``), at the rate times ``lr_scale``; returns ``ok``.  The
        gradients of a step that is not ``ok`` must be finite (the train
        step zeroes them, as the JAX step does)."""
        ok = _flag(ok, self.lr)
        rate = self.lr if lr_scale is None else self.lr * lr_scale
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        self._update(grads, ok.float(), rate.float())
        return ok

    def _update(self, grads: List[Tensor], okf: Tensor, rate: Tensor) -> None:
        raise NotImplementedError

    def _apply(self, updates: List[Tensor], okf: Tensor, rate: Tensor) -> None:
        """``p += -rate * u`` where ``ok`` (``updates`` finite: ``0 * u`` is 0)."""
        torch._foreach_mul_(updates, -(rate * okf))
        torch._foreach_add_(self.params, updates)

    def _named_state(self) -> Dict[str, List[Tensor]]:
        names = sorted({k for s in self.state.values() for k in s if k != "step"})
        return {k: [self.state[p][k] for p in self.params] for k in names}

    def state_dict(self) -> dict:
        out = {"lr": self.lr.clone(), **{k: [t.clone() for t in v] for k, v in self._named_state().items()}}
        step = self.state[self.params[0]].get("step")
        if step is not None:
            out["step"] = step.clone()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` into the tensors this optimizer holds (a captured
        step keeps reading them)."""
        self.lr.copy_(state["lr"])
        for k, tensors in self._named_state().items():
            for t, saved in zip(tensors, state[k]):
                t.copy_(saved)
        if "step" in state:
            self.state[self.params[0]]["step"].copy_(state["step"])


class Adam(DeviceOptimizer):
    """``optax.adam`` (with ``weight_decay``, optax's ``add_decayed_weights``
    before it: coupled L2, as ``torch.optim.Adam`` applies it), or
    ``optax.adamw`` with ``decoupled``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        super().__init__(params, lr)
        self.betas, self.eps = (float(betas[0]), float(betas[1])), float(eps)
        self.weight_decay, self.decoupled = float(weight_decay), decoupled
        # one step count for all parameters, float32 as torch's capturable Adam keeps it
        step = torch.zeros((), dtype=torch.float32, device=self.params[0].device)
        for p in self.params:
            self.state[p] = {
                "step": step,
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }

    def _update(self, grads, okf, rate):
        b1, b2 = self.betas
        m = [self.state[p]["exp_avg"] for p in self.params]
        v = [self.state[p]["exp_avg_sq"] for p in self.params]
        step = self.state[self.params[0]]["step"]
        if self.weight_decay and not self.decoupled:
            grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        # the moments move by (1 - b) * ok of the way to g and g^2: m + 0 * (g - m)
        # is m (tensor weights go through mul: a foreach lerp or add would
        # read a tensor weight back to the host)
        _move_toward(m, grads, okf * (1 - b1))
        _move_toward(v, torch._foreach_mul(grads, grads), okf * (1 - b2))
        step.add_(okf)
        t = step.clamp(min=1.0)  # a step that is not ok may precede the first update
        u = torch._foreach_div(m, 1 - torch.pow(b1, t))
        denom = torch._foreach_div(v, 1 - torch.pow(b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        if self.weight_decay and self.decoupled:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        self._apply(u, okf, rate)


class SGD(DeviceOptimizer):
    """``optax.sgd``: with ``momentum``, the trace ``t = g + momentum * t``."""

    def __init__(self, params, lr: float, momentum: float = 0.0):
        super().__init__(params, lr)
        self.momentum = float(momentum)
        if self.momentum:
            for p in self.params:
                self.state[p] = {"momentum_buffer": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, grads, okf, rate):
        if not self.momentum:
            self._apply([g.clone() for g in grads], okf, rate)
            return
        bufs = [self.state[p]["momentum_buffer"] for p in self.params]
        new = torch._foreach_mul(bufs, self.momentum)
        torch._foreach_add_(new, grads)
        _move_toward(bufs, new, okf)  # the new trace where ok, the old one otherwise
        self._apply(new, okf, rate)


class GradientAccumulation:
    """``optax.MultiSteps``: every ``ok`` mini-step adds the gradients to a
    running sum; the ``every_k``-th of them applies the wrapped optimizer
    once to their mean and starts the sum again.  As in the JAX step, whose
    select keeps the MultiSteps state of a step that is not ``ok``, such a
    step neither adds nor counts.  The count is on the device, and
    :meth:`step` returns whether it applied an update, a device flag, so
    that an LR schedule counts updates, not mini-steps."""

    def __init__(self, optimizer: DeviceOptimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = every_k
        params = optimizer.params
        self.mini_step = torch.zeros((), dtype=torch.int64, device=params[0].device)
        self._sums = [torch.zeros_like(p) for p in params]

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    @torch.no_grad()
    def step(self, ok: Optional[Tensor] = None, lr_scale: Optional[Tensor] = None) -> Tensor:
        params = self.optimizer.params
        ok = _flag(ok, self.mini_step)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        torch._foreach_add_(self._sums, grads)  # 0 where not ok (see DeviceOptimizer.step)
        self.mini_step.add_(ok.long())
        apply = ok & (self.mini_step == self.every_k)
        for p, total in zip(params, self._sums):
            p.grad = total / self.every_k
        self.optimizer.step(apply, lr_scale)
        keep = ~apply
        torch._foreach_mul_(self._sums, keep.float())
        self.mini_step.mul_(keep.long())
        return apply

    def state_dict(self) -> dict:
        return {
            "optimizer": self.optimizer.state_dict(),
            "mini_step": self.mini_step.clone(),
            "sums": [s.clone() for s in self._sums],
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.mini_step.copy_(state["mini_step"])
        for total, saved in zip(self._sums, state["sums"]):
            total.copy_(saved)


def build_optimizer(params: Iterable[torch.Tensor], cfg: Dict[str, Any]):
    """``cfg`` mirrors the reference optimizer block: ``{_target_, lr,
    weight_decay, beta1, beta2, momentum, accumulate_grad_batches}``."""
    name = str(cfg.get("_target_", "torch.optim.Adam")).rsplit(".", 1)[-1].lower()
    lr = float(cfg.get("lr", 1e-4))
    weight_decay = float(cfg.get("weight_decay", 0.0))
    params = list(params)
    if name == "adam":
        opt = Adam(
            params, lr, betas=(float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999))),
            weight_decay=weight_decay,
        )
    elif name == "adamw":
        opt = Adam(params, lr, weight_decay=weight_decay, decoupled=True)
    elif name == "sgd":
        opt = SGD(params, lr, momentum=float(cfg.get("momentum", 0.0)))
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


class StepSchedule:
    """StepLR as optax's staircase ``exponential_decay``: the rate of
    update ``c`` (counted from 0) is ``lr * gamma ** (c // step_size)``.
    The count of applied updates is a device tensor, and :meth:`step`
    writes the optimizer's rate in place."""

    def __init__(self, optimizer: DeviceOptimizer, step_size: int, gamma: float):
        self.optimizer, self.step_size, self.gamma = optimizer, int(step_size), float(gamma)
        self.count = torch.zeros((), dtype=torch.int64, device=optimizer.lr.device)

    @torch.no_grad()
    def step(self, applied: Optional[Tensor] = None) -> None:
        """Count one update where ``applied`` holds (always when ``None``)."""
        self.count.add_(_flag(applied, self.count).long())
        self._write_rate()

    def _write_rate(self) -> None:
        decays = torch.div(self.count, self.step_size, rounding_mode="floor").double()
        self.optimizer.lr.copy_(self.optimizer.base_lr * torch.pow(self.gamma, decays))

    def state_dict(self) -> dict:
        return {"count": self.count.clone()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count.copy_(state["count"])
        self._write_rate()


def build_schedule(optimizer, scheduler_cfg: Optional[Dict[str, Any]]) -> Optional[StepSchedule]:
    """StepLR, stepped once per applied optimizer update (the optax schedule
    counts updates; under :class:`GradientAccumulation` the train step
    passes it the accumulation's applied flag); ``None`` without a schedule
    or for ReduceLROnPlateau, which runs on the host
    (:class:`PlateauController`)."""
    if not scheduler_cfg:
        return None
    name = str(scheduler_cfg.get("_target_", "")).rsplit(".", 1)[-1].lower()
    if name == "steplr":
        return StepSchedule(
            getattr(optimizer, "optimizer", optimizer),
            step_size=int(_eval_arith(scheduler_cfg["step_size"])),
            gamma=float(scheduler_cfg.get("gamma", 0.9)),
        )
    if name == "reducelronplateau":
        return None
    raise ValueError(f"unsupported scheduler {name!r}")


class PlateauController:
    """Host-side ReduceLROnPlateau: tracks the monitored metric per epoch
    and yields the LR scale that the train step applies (the trainer writes
    it into the train state's ``lr_scale`` between epochs)."""

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
