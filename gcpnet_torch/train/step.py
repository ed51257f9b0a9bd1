"""One training step (loss, gradients, adaptive clip, optimizer update) and
one evaluation step.

Port of ``Trainer._build_train_step`` and ``_build_eval_step``
(``gcpnet_tpu/train/trainer.py:260-330, 369-386``), for any task: the loss
is the task's ``loss_fn(preds, batch) -> (loss, labels)``.

- the float32 parameters of ``model`` are the masters; with a bfloat16
  ``compute_dtype`` the forward and backward run on bf16 copies of them and
  of the batch's float arrays (``_to_bf16``, ``trainer.py:48-55``), through
  ``torch.func.functional_call``, and the gradients reach the masters in
  float32 (every op runs in bf16, as in the JAX package; ``torch.autocast``
  would keep the elementwise work in float32 and is not this policy);
- the loss is taken in float32 against the float32 labels;
- under data parallelism (``state.group``) each process has stepped on its
  own shard, and the loss and the gradients are averaged over the
  processes before anything reads them, as the JAX step ``pmean``s them:
  one all-reduce of one flat float32 buffer, divided by the world size.
  So the loss is the mean of the shards' losses (not the global batch's
  loss, where a loss does not decompose so), and the norm, the clip,
  ``ok`` and the update are the same on every process.  The all-reduce is
  part of the step, so a CUDA graph of the step holds it (NCCL only:
  ``parallel.check_capturable``); the model is not wrapped in
  ``DistributedDataParallel``, whose hooks and eager warm-up iterations
  do not fit a captured step;
- the global gradient norm, then the optional adaptive clip from the
  ``GradNormRing``, then the update with the learning rate times the
  state's ``lr_scale``;
- as the JAX step selects (``trainer.py:302-323``), so does this one, on
  the device: ``ok`` is a device flag (finite loss and norm), the
  gradients are zeroed where it fails, and the parameters, the optimizer's
  moments and count and the schedule's count move only where it holds
  (``train.optim``); nothing is read back to the host, so a CUDA graph
  captured around :func:`apply_step` replays it (``train.graphs``);
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
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import Tensor

from gcpnet_torch import parallel
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train.state import TrainState

LossFn = Callable[[Tensor, GraphBatch], Tuple[Tensor, Tensor]]


@dataclasses.dataclass
class StepResult:
    loss: Tensor  # float32 scalar on the device
    grad_norm: Tensor  # float32 scalar on the device, before the clip
    ok: Tensor  # bool scalar on the device: the update was applied (finite loss and norm)


def global_norm(tensors) -> Tensor:
    """``optax.global_norm``: the L2 norm of all entries together, in float32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def loss_and_grads(
    model: torch.nn.Module,
    state: TrainState,
    batch: GraphBatch,
    loss_fn: LossFn,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
) -> Tuple[Tensor, list]:
    """This process's float32 loss on ``batch`` and the gradients of the
    float32 parameters (zeros where a parameter got none), in
    ``model.named_parameters()`` order."""
    params = dict(model.named_parameters())
    state.optimizer.zero_grad()
    kwargs = dict(deterministic=deterministic, generator=generator)
    if state.compute_dtype == torch.float32:
        preds = model(batch, **kwargs)
    else:
        apply_params = {name: p.to(state.compute_dtype) for name, p in params.items()}
        apply_batch = batch.to(batch.x.device, state.compute_dtype)
        preds = torch.func.functional_call(model, apply_params, (apply_batch,), kwargs)
    loss, _ = loss_fn(preds.float(), batch)
    loss.backward()
    return loss.detach(), [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]


def flatten(loss: Tensor, grads: Sequence[Tensor]) -> Tensor:
    """One float32 buffer: the gradients, then the loss."""
    return torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])


def unflatten_(flat: Tensor, grads: Sequence[Tensor]) -> Tensor:
    """Copy a :func:`flatten` buffer's gradients back into ``grads`` (the
    tensors themselves, so that what reads them next sees the same
    storage as without the buffer); its loss."""
    start = 0
    for g in grads:
        g.copy_(flat[start : start + g.numel()].view_as(g))
        start += g.numel()
    return flat[start]


def apply_step(
    model: torch.nn.Module,
    state: TrainState,
    batch: GraphBatch,
    loss_fn: LossFn,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
) -> StepResult:
    """The device work of one training step: :func:`train_step` without
    counting the step on the host."""
    loss, grads = loss_and_grads(model, state, batch, loss_fn, generator, deterministic)
    if state.group is not None:
        if loss.is_cuda and torch.cuda.is_current_stream_capturing():
            parallel.check_capturable(state.group)
        loss = unflatten_(parallel.mean_(flatten(loss, grads), state.group), grads)
    return update(model, state, loss, grads)


def update(model: torch.nn.Module, state: TrainState, loss: Tensor, grads: list) -> StepResult:
    """The rest of the step from the (averaged) loss and gradients: the
    norm, the clip, the device-side finite check and the update."""
    params = dict(model.named_parameters())
    gnorm = global_norm(grads)
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    if state.ring is not None:
        thr = state.ring.clip_threshold(state.clip_std_multiplier)
        scale = torch.clamp(thr / torch.clamp(gnorm, min=1e-12), max=1.0)
        torch._foreach_mul_(grads, scale)
        state.ring.push(torch.minimum(gnorm, thr), ok)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    for p, g in zip(params.values(), grads):
        p.grad = torch.where(ok, g, zero)
    applied = state.optimizer.step(ok, state.lr_scale)
    if state.scheduler is not None:
        state.scheduler.step(applied)
    return StepResult(loss, gnorm.detach(), ok)


def train_step(
    model: torch.nn.Module,
    state: TrainState,
    batch: GraphBatch,
    loss_fn: LossFn,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
) -> StepResult:
    """One update of ``model``'s float32 parameters for the task loss
    ``loss_fn`` on ``batch`` (a float32 batch on the model's device), run
    eagerly.  Dropout masks come from ``generator`` (on the same device)
    unless ``deterministic``.  The step counter advances whether or not
    the update was applied."""
    result = apply_step(model, state, batch, loss_fn, generator, deterministic)
    state.step += 1
    return result


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: GraphBatch, loss_fn: LossFn) -> Tuple[Tensor, Tensor]:
    """``(loss, preds)`` of ``model`` in its deterministic mode on ``batch``,
    both on the device (``trainer.py:369-386``)."""
    preds = model(batch, deterministic=True)
    loss, _ = loss_fn(preds.float(), batch)
    return loss, preds
