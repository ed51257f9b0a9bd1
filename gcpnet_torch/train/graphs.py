"""One dispatch per step: the training step, the evaluation step and the
serving forward (``predict.Predictor``) captured as CUDA graphs and
replayed.

Port of the JAX trainer's compiled step and its scan over a chunk of
same-shape batches (``gcpnet_tpu/train/trainer.py:260-410``): XLA compiles
a step, or ``scan_chunk_size`` steps, into one executable that one
dispatch runs.  Here a CUDA graph (``torch.cuda.CUDAGraph``) holds the same
work, captured once per sequence of batch shapes, and one ``replay()``
runs it:

- the batches are copied into static input slots (:class:`BatchSlots`, one
  set per batch shape and position in the chunk) on the current stream,
  from pinned host tensors, without blocking; the replay follows on the
  same stream, so no slot is overwritten before the replay that reads it;
- the first chunk of a sequence of shapes runs eagerly on a side stream,
  as its real steps and the warm-up in one, and then the graph is captured
  (a capture runs nothing); every later chunk of those shapes replays it;
  the graphs of one :class:`CapturedCall` share its side stream and one
  memory pool, as they replay one at a time on one stream;
- a step reads and writes, in place, only device tensors that outlive it
  (parameters, moments, counts, the gradient-norm ring, the rate and its
  scale: ``train.optim``, ``train.state``), and reads nothing back to the
  host; dropout draws from a generator registered with each graph, so
  that a replay draws new masks and advances its offset as the eager step
  does;
- the outputs are cloned after a replay, as the next replay overwrites them;
- a kernel wrapper counts its launches in Python: the warm-up's, and the
  capture's, which records them into the graph; a replay runs no Python,
  so what it launches is read from the graph's kernel nodes
  (:meth:`CapturedCall.kernel_names`, with ``CapturedCall.keep_graphs``);
- a failed capture or replay raises; nothing runs eagerly in its place.

A graph fixes the host values it was captured with (the kernels' layer
tables and row counts, the slots' addresses): it stays valid while the
state is updated in place, and is dropped (:meth:`CapturedCall.clear`)
wherever state is loaded.  Graphs and slots are kept for every sequence of
shapes seen, without a limit: bucketed batches (one shape, and a tail)
keep them few, while batches of ever new shapes would capture and keep a
graph each.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from gcpnet_torch import parallel
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.train.state import TrainState
from gcpnet_torch.train.step import LossFn, StepResult, apply_step, eval_step

def batch_key(batch: GraphBatch) -> tuple:
    """Every array's name, shape and dtype (``None`` where absent)."""
    return tuple(
        (name, None if t is None else (tuple(t.shape), t.dtype)) for name, t in batch.tensors().items()
    )


class BatchSlots:
    """Static device tensors shaped as the torch batch ``like``."""

    def __init__(self, like: GraphBatch, device: torch.device):
        def empty(t):
            return None if t is None else torch.empty(t.shape, dtype=t.dtype, device=device)

        fields = {f.name: empty(getattr(like, f.name)) for f in dataclasses.fields(like) if f.name != "extras"}
        fields["extras"] = {k: empty(v) for k, v in like.extras.items()}
        self.batch = GraphBatch(**fields)

    def fill(self, src: GraphBatch) -> None:
        """Copy ``src`` (pinned host tensors of the slots' shapes) in on the
        current stream, without blocking."""
        for dst, t in zip(self.batch.tensors().values(), src.tensors().values()):
            if dst is not None:
                dst.copy_(t, non_blocking=True)


# CUgraphNodeType (cuda.h)
_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4


def graph_kernel_names(raw_graph: int) -> Dict[str, int]:
    """The kernel nodes of a ``cudaGraph_t`` (child graphs included) by
    function name, as the driver gives it (``cuFuncGetName``, mangled):
    what one replay of the graph launches."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise RuntimeError(f"graph_kernel_names: {fn} failed with CUresult {err}")

    get_params = "cuGraphKernelNodeGetParams_v2" if hasattr(cu, "cuGraphKernelNodeGetParams_v2") \
        else "cuGraphKernelNodeGetParams"
    counts: Dict[str, int] = {}
    pending = [raw_graph]
    while pending:
        graph = ctypes.c_void_p(pending.pop())
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", graph, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
        for node in nodes:
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int()
            call("cuGraphNodeGetType", node, ctypes.byref(kind))
            if kind.value == _CHILD_GRAPH_NODE:
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", node, ctypes.byref(child))
                pending.append(child.value)
            elif kind.value == _KERNEL_NODE:
                # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction at byte 0, the
                # CUkernel (read where no CUfunction is set) at byte 56
                params = (ctypes.c_uint64 * 16)()
                call(get_params, node, params)
                name = ctypes.c_char_p()
                if params[0]:
                    call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params[0]))
                else:
                    call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params[7]))
                key = name.value.decode()
                counts[key] = counts.get(key, 0) + 1
    return counts


class CapturedCall:
    """``fn(batches) -> tuple of tensors`` over lists of batches on the
    card, one CUDA graph per sequence of batch shapes (see the module's
    docstring).  ``generator``, when given, is the CUDA generator ``fn``
    draws from."""

    # keep each graph's cudaGraph_t beside its executable graph, so that
    # kernel_names can read its nodes (set before the capture)
    keep_graphs = False

    def __init__(self, fn: Callable, device, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CapturedCall: CUDA graphs run on the card, not on {self.device}")
        if generator is not None and generator.device.type != "cuda":
            raise ValueError("CapturedCall: the generator must be a CUDA generator")
        self.fn, self.generator = fn, generator
        self._side = torch.cuda.Stream(self.device)
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[tuple, Tuple[torch.cuda.CUDAGraph, Tuple[Tensor, ...]]] = {}
        self._slots: Dict[tuple, BatchSlots] = {}
        self.captures = 0  # graphs captured
        self.captured_batches = 0  # batches those graphs take, together
        self.replays = 0

    @property
    def num_graphs(self) -> int:
        """The graphs held now: one per sequence of batch shapes seen since
        the last :meth:`clear`."""
        return len(self._graphs)

    def kernel_names(self, batches: Sequence[GraphBatch]) -> Dict[str, int]:
        """The kernels that one replay for ``batches``' sequence of shapes
        launches, by name, read from its graph (captured with
        ``keep_graphs``)."""
        graph, _ = self._graphs[tuple(batch_key(b) for b in batches)]
        return graph_kernel_names(graph.raw_cuda_graph())

    def clear(self) -> None:
        """Drop every graph and slot: the next call captures again."""
        self._graphs.clear()
        self._slots.clear()

    def __call__(self, batches: Sequence[GraphBatch]) -> Tuple[Tensor, ...]:
        """Run ``fn`` over ``batches`` (pinned host batches) on the device:
        the first time for their sequence of shapes eagerly, then captured;
        afterwards by one replay.  The outputs are the caller's."""
        keys = tuple(batch_key(b) for b in batches)
        slots = []
        for i, (key, batch) in enumerate(zip(keys, batches)):
            slot = self._slots.get((key, i))
            if slot is None:
                slot = self._slots[(key, i)] = BatchSlots(batch, self.device)
            slot.fill(batch)
            slots.append(slot)
        captured = self._graphs.get(keys)
        if captured is None:
            return self._warm_up_and_capture(keys, [s.batch for s in slots])
        graph, outputs = captured
        graph.replay()
        self.replays += 1
        return tuple(t.clone() for t in outputs)

    def _warm_up_and_capture(self, keys: tuple, inputs: List[GraphBatch]) -> Tuple[Tensor, ...]:
        stream, side = torch.cuda.current_stream(self.device), self._side
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            outputs = tuple(self.fn(inputs))
        stream.wait_stream(side)
        for t in outputs:
            t.record_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True) if self.keep_graphs else torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # thread_local: the prefetch thread may pin host memory meanwhile
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            static = tuple(self.fn(inputs))
        if self.keep_graphs:
            graph.instantiate()  # a kept graph is not instantiated at the capture's end
        self._graphs[keys] = (graph, static)
        self.captures += 1
        self.captured_batches += len(inputs)
        return outputs


class TrainSteps:
    """Training steps of ``model`` from ``state`` on ``loss_fn``, captured:
    a call with k pinned host batches runs k steps of :func:`apply_step` in
    one replay (the JAX trainer's scan over a chunk), advances
    ``state.step`` by k, and returns their losses, gradient norms and
    ``ok`` flags, each ``[k]`` on the device.

    Under data parallelism the graph holds the step's NCCL all-reduce: the
    first call's eager run creates the communicator, which must exist
    before the capture; a process group of another backend raises here
    (``parallel.check_capturable``)."""

    def __init__(
        self,
        model: torch.nn.Module,
        state: TrainState,
        loss_fn: LossFn,
        generator: Optional[torch.Generator] = None,
    ):
        parallel.check_capturable(state.group)
        self.state = state

        def steps(batches):
            results = [apply_step(model, state, b, loss_fn, generator) for b in batches]
            return tuple(torch.stack([getattr(r, f) for r in results]) for f in ("loss", "grad_norm", "ok"))

        self.call = CapturedCall(steps, next(model.parameters()).device, generator)

    def __call__(self, batches: Sequence[GraphBatch]) -> StepResult:
        out = StepResult(*self.call(batches))
        self.state.step += len(batches)
        return out


class EvalSteps:
    """Evaluation steps of ``model`` on ``loss_fn``, captured: a call with k
    pinned host batches returns their losses ``[k]`` and then each batch's
    predictions, on the device."""

    def __init__(self, model: torch.nn.Module, loss_fn: LossFn):
        def steps(batches):
            results = [eval_step(model, b, loss_fn) for b in batches]
            return (torch.stack([loss for loss, _ in results]), *(preds for _, preds in results))

        self.call = CapturedCall(steps, next(model.parameters()).device)

    def __call__(self, batches: Sequence[GraphBatch]) -> Tuple[Tensor, List[Tensor]]:
        losses, *preds = self.call(batches)
        return losses, preds


