"""One training step (loss, gradients, adaptive clip, optimizer update) and
one evaluation step.

Port of ``Trainer._build_train_step`` and ``_build_eval_step``
(``gcpnet_tpu/train/trainer.py:260-330, 369-386``) for one device, for any
task: the loss is the task's ``loss_fn(preds, batch) -> (loss, labels)``.

- the float32 parameters of ``model`` are the masters; with a bfloat16
  ``compute_dtype`` the forward and backward run on bf16 copies of them and
  of the batch's float arrays (``_to_bf16``, ``trainer.py:48-55``), through
  ``torch.func.functional_call``, and the gradients reach the masters in
  float32 (every op runs in bf16, as in the JAX package; ``torch.autocast``
  would keep the elementwise work in float32 and is not this policy);
- the loss is taken in float32 against the float32 labels;
- the global gradient norm, then the optional adaptive clip from the
  ``GradNormRing``, then the update with the learning rate times ``lr_scale``;
- a non-finite loss or norm leaves the parameters, the optimizer's moments
  and the schedule as they were, while the step counter advances;
- the LR schedule counts real updates: under gradient accumulation it steps
  only when the accumulated gradients were applied (``optax.MultiSteps``
  wraps the whole chain, schedule included).

One deliberate difference from the JAX package: the ring takes a norm only
from a finite step.  The JAX step pushes ``min(gnorm, thr)`` before its
finite check, so one NaN norm makes every later threshold NaN, and the clip
scale with it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train.state import TrainState

LossFn = Callable[[Tensor, GraphBatch], Tuple[Tensor, Tensor]]


@dataclasses.dataclass
class StepResult:
    loss: Tensor  # float32 scalar on the device
    grad_norm: Tensor  # float32 scalar on the device, before the clip
    ok: bool  # the update was applied (finite loss and norm)


def global_norm(tensors) -> Tensor:
    """``optax.global_norm``: the L2 norm of all entries together, in float32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def train_step(
    model: torch.nn.Module,
    state: TrainState,
    batch: GraphBatch,
    loss_fn: LossFn,
    generator: Optional[torch.Generator] = None,
    lr_scale: float = 1.0,
    deterministic: bool = False,
) -> StepResult:
    """One update of ``model``'s float32 parameters for the task loss
    ``loss_fn`` on ``batch`` (a float32 batch on the model's device).
    Dropout masks come from ``generator`` (on the same device) unless
    ``deterministic``."""
    params = dict(model.named_parameters())
    state.optimizer.zero_grad(set_to_none=True)
    kwargs = dict(deterministic=deterministic, generator=generator)
    if state.compute_dtype == torch.float32:
        preds = model(batch, **kwargs)
    else:
        apply_params = {name: p.to(state.compute_dtype) for name, p in params.items()}
        apply_batch = batch.to(batch.x.device, state.compute_dtype)
        preds = torch.func.functional_call(model, apply_params, (apply_batch,), kwargs)
    loss, _ = loss_fn(preds.float(), batch)
    loss.backward()

    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]
    for p, g in zip(params.values(), grads):
        p.grad = g
    gnorm = global_norm(grads)
    thr = None
    if state.ring is not None:
        thr = state.ring.clip_threshold(state.clip_std_multiplier)
        scale = torch.clamp(thr / torch.clamp(gnorm, min=1e-12), max=1.0)
        torch._foreach_mul_(grads, scale)
    ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
    if ok:
        if state.ring is not None:
            state.ring.push(torch.minimum(gnorm, thr))
        lrs = [group["lr"] for group in state.optimizer.param_groups]
        for group in state.optimizer.param_groups:
            group["lr"] = group["lr"] * lr_scale
        applied = state.optimizer.step()
        for group, lr in zip(state.optimizer.param_groups, lrs):
            group["lr"] = lr
        # GradientAccumulation.step says whether it applied the update; a
        # torch optimizer's step returns None and always applies it
        if state.scheduler is not None and applied is not False:
            state.scheduler.step()
    state.step += 1
    return StepResult(loss.detach(), gnorm.detach(), ok)


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: GraphBatch, loss_fn: LossFn) -> Tuple[Tensor, Tensor]:
    """``(loss, preds)`` of ``model`` in its deterministic mode on ``batch``,
    both on the device (``trainer.py:369-386``)."""
    preds = model(batch, deterministic=True)
    loss, _ = loss_fn(preds.float(), batch)
    return loss, preds
