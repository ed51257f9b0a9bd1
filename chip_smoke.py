#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the four CUDA sources of gcpnet_torch/csrc (one nvcc each,
     started together; ptxas resource usage goes to <out-dir>/ptxas.txt);
  3. K1 (sorted segment sum) against its plain PyTorch version at the main
     path's shape, fp32 and bf16, on the tile-aligned and the CSR layouts,
     device time under torch.profiler in turns with torch.segment_reduce
     (library, kernel, kernel, library);
  4. K2 (fused message stack, on the tensor cores: bf16, and float32 as
     split TF32) against its plain version at the main path's shape, fp32
     and bf16;
  5. K3 (the fused stack's backward, on the tensor cores: bf16, and float32
     as split TF32) against its plain version (autograd through K2's) at
     the main path's shape, fp32 and bf16, leaf by leaf (d message, each
     weight matrix and bias);
  6. forward: the LBA forward at the benchmark's full width (16 graphs x 448
     atoms, 8 interaction layers x 8 message layers) through
     gcpnet_torch.predict, fp32 and bf16: launch counts, finiteness,
     latency, peak memory; then the fp32 predictions against the same
     weights and batch run on the CPU through the plain versions;
  7. train: the full-width LBA training step through gcpnet_torch.train
     (bf16 over fp32 masters, dropout 0.1, Adam at lr 1e-4), 6 steps on one
     batch: launches per step, finiteness, ms per step, graphs/s, peak
     memory;
  8. train-fp32: the same full-width training step in float32 (the JAX
     Trainer's default precision), 6 steps on one batch: the same checks
     (every K3 launch is one of the tensor-core kernel, K3's only one) and
     numbers, and one warm step under torch.profiler;
  9. train-check: one fp32 training step on the card against the same step
     on the CPU (2 interaction layers, 2 graphs, no dropout): loss, gradient
     norm, gradients and updated parameters; its launches of the fp32 K3;
 10. bf16-check: the bf16 training step's gradients against the fp32
     step's on the card (the train-check's size), through the kernels and
     through the plain stack in bf16;
 11. profile: one warm bf16 forward and one warm bf16 training step under
     torch.profiler (device busy and idle share, time by kernel);
 12. nms-data: the NMS small_20body splits (2,000 / 500 / 500 trajectories)
     simulated on the card by gcpnet_torch.data.nms_sim's "torch" integrator,
     as batches of 100 20-body graphs (2,000 nodes, 38,000 CSR edge rows);
 13. nms-kernels: K1, K2 and K3 at the NMS step's shape against their plain
     versions, fp32 and bf16, with their times, bounds and shares of them;
 14. nms-check: one fp32 NMS training step on the card against the CPU (2
     interaction layers, 10 graphs, no dropout);
 15. nms-fit: the NMS path, the full-width NMS model fitted by the Trainer
     (fp32, the experiment's defaults) for 3 epochs with checkpoints, then a
     new Trainer resumes to epoch 4 and tests the best checkpoint: every
     step's launches (4 of each kernel), per-epoch seconds, train graphs/s,
     val/loss and val/RMSE, peak memory, and one warm step under
     torch.profiler;
 16. rs-data: the RS splits, synthetic enantiomer pairs at the JAX module's
     sizes (4,096 / 512 / 512 graphs), and a paired training batch (64
     anchors and their enantiomers: 128 graphs, a bucket of 8,192 nodes and
     16,384 CSR edge rows, about 1,400 and 2,600 of them real);
 17. rs-kernels: K1, K2 and K3 at the RS step's shape against their plain
     versions, fp32 and bf16, the stack's leaky relu included, with their
     times, bounds and shares of them;
 18. rs-check: one fp32 RS training step on the card against the CPU (2
     interaction layers, a paired batch, no dropout);
 19. rs-fit: the RS path, the full-width RS model fitted by the Trainer
     (fp32, the experiment's defaults) for 3 epochs with checkpoints, then
     the best checkpoint's test: every step's launches, per-epoch seconds,
     train graphs/s, val/loss, val/Accuracy and val/F1, peak memory;
 20. rs-profile: one warm RS training step under torch.profiler.
Then the total time, one JSON line with every kernel's numbers (at the NMS
and RS shapes too), the nvidia-smi line, and the final status line.  Any failed phase exits non-zero; without a CUDA device
the script exits non-zero before printing any result.  Full measurements go
to <out-dir>/chip_smoke.json (``--out-dir``, default logs/chip_smoke).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.models.lba import graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch.nn import message_passing
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops import build as kernel_build
from gcpnet_torch.ops.edge_map import (
    KINK_MARGIN,
    edge_map,
    edge_map_backward,
    edge_map_backward_plain,
    edge_map_plain,
    max_kink_rows,
    kink_margins,
)
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch.predict import DTYPES, build_model, lba_configs, predict, synthetic_batches
from gcpnet_torch.train import trainer as trainer_module
from gcpnet_torch.train.cli import build_lba_training, build_nms_trainer, build_rs_trainer, nms_configs, rs_configs
from gcpnet_torch.train.optim import build_optimizer
from gcpnet_torch.train.state import TrainState
from gcpnet_torch.train.step import train_step

SEED = 0
GRAPHS, NODES, EDGES_PER_NODE = 16, 448, 28
FORWARD_BATCHES = 4  # the first is the cold one; latency is over the rest
TRAIN_STEPS = 6  # the first is the cold one; ms per step is over the rest
TRAIN_CHECK_GRAPHS, TRAIN_CHECK_LAYERS = 2, 2
# The NMS path: small_20body at the published widths and batch (100 graphs
# of 20 bodies: 2,000 nodes, 38,000 edge rows), its splits cut from the
# published 10,000 / 2,000 / 2,000 trajectories to fit the run's time.
NMS_SPLITS = {"num_train": 2000, "num_valid": 500, "num_test": 500}
NMS_BATCH = 100
NMS_EPOCHS, NMS_RESUME_EPOCHS = 3, 4
NMS_CHECK_GRAPHS, NMS_CHECK_LAYERS = 10, 2
# The RS path: the experiment gcpnet_rs at its published widths and batch
# (64 anchors, each with its opposite enantiomer: 128 graphs in a bucket of
# 8,192 nodes and 16,384 edge rows), on the synthetic splits at the JAX
# module's sizes (4,096 / 512 / 512 graphs), fitted for 3 of its up to
# 1,000 epochs; rs-check cuts to 2 interaction layers for the CPU.
RS_EPOCHS = 3
RS_CHECK_LAYERS = 2
# the best checkpoint's val/loss evaluated again against the value logged
# for it: the same weights and batches through the same kernels, but the
# node-frame means sum with index_add_, whose atomics on the card add in
# another order each run (float32: a few roundings of 2^-24 relative)
NMS_VAL_RTOL = 1e-5
# The published H100 SXM peaks (NVIDIA data sheet, dense): device memory
# rate, and the operation rate for each input type (bf16 on the tensor
# cores, fp32 on the CUDA cores), and TF32 on the tensor cores, the route
# of K2's and K3's float32 (split TF32: three products for each).
PEAK_BYTES_PER_S = 3.35e12
# The H100 SXM's L2 (50 MB): a kernel timed over and over on one input that
# fits in it reads the L2, not device memory; timed_inputs rotates copies.
L2_BYTES = 50 * 2**20
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS_PER_S = 495e12
# Tolerances, as max |kernel - plain| <= rel * max(1, max |plain|):
# K1 fp32: both sum in float32, only the order differs.
# K1 bf16: both sum in float32 and round once; the order can flip that
#   rounding by one bf16 step (2^-8 relative).
# K2 fp32: split TF32 keeps float32's precision in every product; the
#   summation order differs.
# K2 bf16: both take bf16 operands with float32 accumulators and round each
#   product's output to bf16 (as the JAX package's MM form does); the plain
#   version also rounds its elementwise work (squares, sums, bias additions)
#   to bf16, where the kernel rounds once after it: a few bf16 steps (2^-8
#   relative each) over 8 layers.  On the H100 the kernel reads 0.0106.
# K3, leaf by leaf (d message, and each weight matrix and bias of each
#   layer), in norm, ||kernel - plain|| <= rel * ||plain||: the derivative of
#   relu jumps at 0, and at 208,896 rows x 8 layers some pre-activations lie
#   within float32 rounding of 0, where the kernel and the plain version take
#   different sides; those few entries differ by O(1), so a max-abs bound
#   says nothing.
# K3 fp32: float32-grade products (split TF32) throughout.  On the H100 the
#   worst leaf reads 9.8e-4, and 9.5e-4 from the plain version in float64,
#   beside the plain fp32 version's own 7.2e-4 from it (kinks alone); the
#   plain version with its products on one TF32 pass, a control of lower
#   precision, reads 2.0e-2 (k3_breakdown.py).
# K3 bf16: the kernel computes as the JAX kernel does (bf16 operands, float32
#   accumulators, each product's output rounded to bf16), and so does the
#   plain bf16 version, which also rounds its elementwise work to bf16.  bf16
#   keeps 8 bits (2^-8 relative a rounding), and a leaf lies behind up to 16
#   rounded products and many more elementwise roundings, which add up like a
#   random walk.  On the H100 the kernel's leaves read at most 0.054 from the
#   float32 plain version on the same bf16 inputs and 0.066 from the plain
#   bf16 version (whose own leaves read up to 0.066 from float32), while a
#   build that misses a part of the work (k3_breakdown.py's cuts) reads at
#   least 0.16 on every leaf that part feeds.  The bounds sit between:
#   K3_UPCAST_TOL = 16 * 2^-8 against float32, 32 * 2^-8 against plain bf16.
K3_UPCAST_TOL = 16 * 2.0**-8
# At the RS shape a leaf sums 16,384 rows, not 208,896, and bf16's
# roundings average out less: on the H100 the plain bf16 version's own
# leaves read up to 0.071 from float32 there, and the kernel's 0.069 (the
# same leaf as the plain version's to 2e-6; measured on one H100).
# There the kernel is held to the card tests' 32 * 2^-8 against float32
# too, as against the plain bf16 version; a build that misses a part of
# the work reads at least 0.16 at the main path's shape.
K3_UPCAST_TOL_RS = 32 * 2.0**-8
# K3 fp32, the kink rule, at every path's shape: a few rows hold a
# pre-activation within float32 rounding of 0, where the kernel and the
# plain version take different sides of relu (or leaky relu, whose
# derivative steps by 1 - slope there) and the row's d message differs by
# O(1) while every other row agrees to ~1e-6; at the NMS shape a single
# such row of 38,000 moved a weight leaf past TOL.  Rows that part from the
# plain version by more than 1e-4 of scale must each hold a kink margin
# under KINK_MARGIN in the float64 recompute, and be no more than
# max_kink_rows allows (the card tests' limit; gcpnet_torch/ops/edge_map.py
# gives the reasons); with their cotangents set to 0 every leaf is held to
# K3_KINK_FREE_TOL (the card tests' bound).  At the main path's shape TOL
# holds as well, beside the rule; at the NMS and RS shapes the rule alone.
K3_KINK_FREE_TOL = 1e-4
TOL = {
    ("K1", "fp32"): 1e-5, ("K1", "bf16"): 1e-2,
    ("K2", "fp32"): 1e-4, ("K2", "bf16"): 2e-2,
    ("K3", "fp32"): 1e-3, ("K3", "bf16"): 32 * 2.0**-8,
}
# full-width fp32 forward, card vs CPU: summation order differs in every
# reduction and matmul of 8 x 8 layers
FORWARD_ATOL = 1e-3
# one fp32 training step, card vs CPU (2 x 8 layers, 2 x 448 atoms): the
# loss and the gradient norm in absolute terms; the gradients in norm
# (relu kinks, as for K3); the updated parameters in absolute terms, and the
# share of entries more than 1e-6 apart: Adam's first step moves each entry
# by lr * g / (|g| + 1e-8), so where a gradient is within rounding of 0 the
# two steps may differ by up to 2 lr (lr = 1e-4).
TRAIN_CHECK_ATOL = {
    "loss": 1e-4, "grad_norm": 1e-3, "grads_norm_rel": 1e-3, "params": 1e-4, "params_share_above_1e-6": 1e-3,
}
# The RS step at initialization: its loss sits at ln 2 and each enantiomer
# pair's gradients nearly cancel (gradient norm 0.016, against 5.9 for the
# LBA train-check's), so float32 rounding alone moves the gradient by ~1e-3
# in norm: on the CPU, the step with its weights multiplied by 1 + 3e-8 z
# parts from itself by 1.03e-3 (kink rows flipping), where the LBA and NMS
# steps part card from CPU by 1e-5 and 5e-7.  rs-check holds the loss and
# the gradient norm to TRAIN_CHECK_ATOL, and the gradients and updated
# parameters to TRAIN_CHECK_ATOL or to this factor times the CPU step's own
# spread under a float32 rounding's worth of weight noise, the larger.
ROUNDING_SPREAD_FACTOR = 2.0
RS_ROUNDING_DRAWS = 3
# one bf16 training step against the fp32 step, both on the card (the
# train-check's size): tests/test_torch_train.py's bounds for the same
# comparison on the CPU (bf16 keeps 8 bits).
BF16_STEP_TOL = {"loss_rel": 2e-2, "grad_norm_rel": 5e-2, "grads_cosine": 0.99}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls (CUDA events),
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 100, tries: int = 5) -> float:
    """Device time of ``fn`` per call under torch.profiler: for each CUDA
    kernel or copy ``fn`` runs, its mean time over ``calls`` calls, times
    the number of times a call runs it.  For calls as short as the host's
    launch of them, where CUDA events around a loop of calls time the host.
    The profiler can lose a device event now and then (at the NMS shape, 1
    of 100 of some of torch.segment_reduce's kernels; at the RS shape 2 of
    40 of a kernel the plain version runs twice a call); a window in which
    some kernel's count is more than 5% off its multiple of ``calls`` is
    measured again."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                times[e.name].append(e.time_range.elapsed_us())
        per_call = {name: max(1, round(len(t) / calls)) for name, t in times.items()}
        expected = {name: per_call[name] * calls for name in times}
        if times and all(abs(len(t) - expected[n]) <= 0.05 * expected[n] for n, t in times.items()):
            return sum(np.mean(t) * per_call[n] for n, t in times.items()) / 1e3
    counts = {name: len(t) for name, t in times.items()}
    raise PhaseError(f"device_ms: the profiler lost device events in {tries} windows (last: {counts})")


class timed_inputs:
    """An endless rotation of ``data`` and copies of it, enough that
    together they hold at least twice L2_BYTES: each call of a kernel timed
    over and over reads its input from device memory, as in the main path,
    where each call's input was just written by another kernel."""

    def __init__(self, data: torch.Tensor):
        self.count = max(1, math.ceil(2 * L2_BYTES / (data.numel() * data.element_size())))
        self._cycle = itertools.cycle([data] + [data.clone() for _ in range(self.count - 1)])

    def __next__(self) -> torch.Tensor:
        return next(self._cycle)


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    return err, err / scale


def norm_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    diff = torch.linalg.vector_norm(got.float() - ref.float())
    return (diff / torch.linalg.vector_norm(ref.float())).item()


def k3_leaf_errs(d_msg, d_w, ref_msg, ref_w, stack) -> dict:
    """K3's results leaf by leaf, each as its norm-relative error: d message,
    and each weight matrix and bias of each layer ("3.b_gate": layer 3's
    gate bias)."""
    errs = {"d_message": norm_rel_err(d_msg, ref_msg)}
    for i, (got, ref) in enumerate(zip(stack.layer_weights(d_w), stack.layer_weights(ref_w))):
        errs.update({f"{i}.{name}": norm_rel_err(got[name], w) for name, w in ref.items() if w is not None})
    return errs


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype, ops_per_s: float = 0.0):
    """The larger of the bytes' time and the operations' time, in ms; the
    operations at ``ops_per_s``, by default the peak of ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / (ops_per_s or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def route_bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    """bound_ms of a tensor-core kernel of the message stack (K2, K3) at its
    route, and the rate it was taken at: bf16 at the bf16 tensor-core peak;
    float32 as split TF32, three TF32 products for each."""
    if dtype == torch.float32:
        return (*bound_ms(nbytes, 3 * flops, dtype, PEAK_TF32_OPS_PER_S), "3 x flops at the TF32 tensor-core peak")
    return (*bound_ms(nbytes, flops, dtype), "flops at the bf16 tensor-core peak")


def phase_device() -> dict:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "nvidia_smi": smi}
    print(f"phase device: ok {info['kind']} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return info


def phase_build(out_dir: str) -> dict:
    t0 = time.perf_counter()
    outputs = kernel_build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, text in outputs.items():
            f.write(f"== {name}\n{text}\n")
    usage = {
        name: [ln.strip() for ln in text.splitlines() if "registers" in ln]
        for name, text in outputs.items()
    }
    print(f"phase build: ok {seconds:.1f}s " + json.dumps(usage))
    return {"seconds": seconds, "ptxas": usage}


def phase_k1(batches_by_tile, d_out: int = 100 + 3 * 16, name: str = "K1") -> dict:
    """K1 at a path's shape: [E, d_out] edge rows into N nodes (the main
    path's: [E, 148])."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for tile, batch in batches_by_tile.items():
        splits = torch.as_tensor(batch.edge_row_splits).cuda()
        n = batch.num_nodes
        lengths = (splits[1:] - splits[:-1]).long()
        end = int(batch.edge_row_splits[-1])
        rows = end - int(batch.edge_row_splits[0])
        for dname, dtype in DTYPES.items():
            data = torch.randn((batch.num_edges, d_out), generator=gen, device="cuda").to(dtype)
            got = segment_sum_sorted(data, splits, n)
            ref = segment_sum_sorted_plain(data, splits, n)
            err, rel = rel_err(got, ref)
            check(rel <= TOL[("K1", dname)], f"{name} tile={tile} {dname}: rel err {rel:.3g}")
            es = data.element_size()
            nbytes = rows * d_out * es + (n + 1) * 4 + n * d_out * es
            b_ms, b_by = bound_ms(nbytes, rows * d_out, dtype)
            copies = timed_inputs(data)
            kernel = lambda: segment_sum_sorted(next(copies), splits, n)  # noqa: E731
            library = lambda: torch.segment_reduce(next(copies)[:end], "sum", lengths=lengths, unsafe=True)  # noqa: E731
            # device time (a call is as short as its launch), in turns:
            # library, kernel, kernel, library
            lib_a, k_a, k_b, lib_b = (device_ms(fn) for fn in (library, kernel, kernel, library))
            results[f"tile{tile}_{dname}"] = {
                "max_abs_err": err,
                "ms": (k_a + k_b) / 2,
                "plain_ms": device_ms(lambda: segment_sum_sorted_plain(next(copies), splits, n), calls=20),
                "library_ms": (lib_a + lib_b) / 2,
                "ms_turns": [lib_a, k_a, k_b, lib_b],
                "timed_copies": copies.count,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "shape": [batch.num_edges, d_out, n],
            }
    print(f"phase {name}: ok " + json.dumps(results))
    return results


def stack_flops(stack) -> int:
    """Multiply-add operations (x2) per edge row of the message stack."""
    total = 0
    for layer in stack.layers:
        s_in, v_in, h, s_out, v_out = layer.dims
        gate = s_out * v_out if layer.w_gate is not None else 0
        total += 2 * (3 * v_in * (h + 3) + (s_in + h + 9) * s_out + 3 * h * v_out + gate)
    return total


def bench_message_passing() -> GCPMessagePassing:
    """One message passing layer of the benchmark's model (8 GCP2 layers,
    hidden 100/16, edges 32/4), random weights from the seed."""
    model_cfg, module_cfg, layer_cfg = lba_configs()
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def stack_for_source(stack, source):
    """``stack`` with the layer table that a K2 or K3 built from ``source``
    reads: a source whose ``edge_stack.cuh`` (beside it) predates the
    layers' slopes (it has no kSlopesPerLayer) takes the table without them
    (the layers' words are the same).  For k2_versions.py and
    k3_breakdown.py, which time a parent commit's sources."""
    header = pathlib.Path(source).with_name("edge_stack.cuh").read_text()
    if "kSlopesPerLayer" in header:
        return stack
    words = 2 + 15 * len(stack.layers)
    return dataclasses.replace(stack, meta=stack.meta[:words].copy(), images={})


def stack_inputs(batch, stack, dtype, gen):
    """Random messages (an eighth of the rows with all-zero vectors, where
    the norm's eps decides) and masked frames at the main path's shape."""
    e = batch.num_edges
    mask = torch.as_tensor(batch.edge_pad_mask).cuda()
    message = torch.randn((e, stack.in_dim), generator=gen, device="cuda")
    message[: e // 8, stack.layers[0].dims[0] :] = 0.0
    frames = torch.rand((e, 9), generator=gen, device="cuda") * 2 - 1
    return message.to(dtype), (frames * mask[:, None]).to(dtype)


def phase_k2(batch, mp: GCPMessagePassing, name: str = "K2") -> dict:
    """K2 at a path's shape with its message stack ``mp`` (the main path's:
    [E, 340] messages + [E, 9] frames -> [E, 148], the benchmark's 8 GCP2
    layers, hidden 100/16)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    e = batch.num_edges
    results = {}
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
            message, frames = stack_inputs(batch, stack, dtype, gen)
            got = edge_map(message, frames, stack)
            ref = edge_map_plain(message, frames, stack)
        check(bool(torch.isfinite(got).all()), f"{name} {dname}: non-finite output")
        err, rel = rel_err(got, ref)
        check(rel <= TOL[("K2", dname)], f"{name} {dname}: rel err {rel:.3g}")
        es = message.element_size()
        nbytes = e * (stack.in_dim + 9 + stack.out_dim) * es + stack.weights.numel() * 4
        flops = e * stack_flops(stack)
        b_ms, b_by, bound_rate = route_bound_ms(nbytes, flops, dtype)
        with torch.no_grad():
            ms = cuda_ms(lambda: edge_map(message, frames, stack), iters=10)
            plain_ms = cuda_ms(lambda: edge_map_plain(message, frames, stack), iters=5)
        results[dname] = {
            "max_abs_err": err,
            "rel_err": rel,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_rate": bound_rate,
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "shape": [e, stack.in_dim, stack.out_dim],
        }
    print(f"phase {name}: ok " + json.dumps(results))
    return results


def kink_rows(name, message, frames, stack, grad_out):
    """The rows where float32 K3's d message differs from the plain
    version's by more than 1e-4 of scale, checked to be kinks (relu or
    leaky relu): each with a kink margin under KINK_MARGIN in the float64
    recompute, and no more than max_kink_rows of them.  Recorded beside
    them: their margins, the share of all rows with such a margin (the
    chance that a row a fault hit would pass as a kink), the largest
    difference on the flagged rows and on all others, and the plain
    version's and the kernel's distance from float64 (d message, in
    norm)."""
    d_msg, _ = edge_map_backward(message, frames, stack, grad_out)
    ref_msg, _ = edge_map_backward_plain(message, frames, stack, grad_out)
    f64_msg, _ = edge_map_backward_plain(message.double(), frames.double(), stack, grad_out.double())
    scale = max(1.0, ref_msg.abs().max().item())
    row_err = (d_msg - ref_msg).abs().amax(dim=1)
    kinks = (row_err > 1e-4 * scale).nonzero().flatten()
    others = torch.ones_like(row_err, dtype=torch.bool)
    others[kinks] = False
    margins = kink_margins(message, frames, stack)
    info = {
        "kink_rows": kinks.tolist(),
        "kink_row_margins": margins[kinks].tolist(),
        "kink_margin": KINK_MARGIN,
        "max_kink_rows": max_kink_rows(message.shape[0]),
        "rows_under_kink_margin_share": (margins <= KINK_MARGIN).double().mean().item(),
        "kink_rows_max_abs": row_err[kinks].max().item() if kinks.numel() else 0.0,
        "other_rows_max_abs": row_err[others].max().item(),
        "plain_vs_float64_norm_rel": norm_rel_err(ref_msg, f64_msg),
        "kernel_vs_float64_norm_rel": norm_rel_err(d_msg, f64_msg),
    }
    print(f"phase {name} kinks: " + json.dumps(info), flush=True)
    check(kinks.numel() <= info["max_kink_rows"],
          f"{name}: {kinks.numel()} rows part from plain, at most {info['max_kink_rows']} may")
    check(all(m <= KINK_MARGIN for m in info["kink_row_margins"]),
          f"{name}: rows {info['kink_rows']} part from plain with kink margins {info['kink_row_margins']}")
    return kinks, info


def k3_leaves(message, frames, stack, grad_out, upcast: bool) -> dict:
    """K3 against its plain version on one cotangent: d message and d
    weights (max abs, norm, finite) and each leaf's norm-relative error,
    and with ``upcast`` (bf16) each leaf against the plain version in
    float32 on the same inputs, and the plain bf16 version's against it."""
    d_msg, d_w = edge_map_backward(message, frames, stack, grad_out)
    ref_msg, ref_w = edge_map_backward_plain(message, frames, stack, grad_out)
    torch.cuda.synchronize()
    res = {}
    for key, got, ref in (("d_message", d_msg, ref_msg), ("d_weights", d_w, ref_w)):
        err, rel = rel_err(got, ref)
        res[key] = {"max_abs_err": err, "rel_err": rel, "norm_rel_err": norm_rel_err(got, ref),
                    "finite": bool(torch.isfinite(got).all())}
    res["leaves"] = {leaf: {"vs_plain": err} for leaf, err in k3_leaf_errs(d_msg, d_w, ref_msg, ref_w, stack).items()}
    if upcast:
        up_msg, up_w = edge_map_backward_plain(message.float(), frames.float(), stack, grad_out.float())
        for leaf, err in k3_leaf_errs(d_msg, d_w, up_msg, up_w, stack).items():
            res["leaves"][leaf]["vs_upcast"] = err
        for leaf, err in k3_leaf_errs(ref_msg, ref_w, up_msg, up_w, stack).items():
            res["leaves"][leaf]["plain_vs_upcast"] = err
    return res


def phase_k3(batch, mp: GCPMessagePassing, name: str = "K3", full_bound: bool = True,
             upcast_tol: float = K3_UPCAST_TOL) -> dict:
    """K3 at a path's shape with its message stack ``mp``: the backward of
    K2's stack for a random cotangent -> d message and d weights (float32);
    the main path's: [E, 148] -> [E, 340].  Each leaf is held to TOL (in
    float32 only with ``full_bound``); the float32 kernel may part from the
    plain version on kink rows (kink_rows), and with their cotangents set
    to 0 every leaf is held to K3_KINK_FREE_TOL.  The bf16 kernel's leaves
    are also held to ``upcast_tol`` against the plain float32 version on
    the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    e = batch.num_edges
    results = {}
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
        message, frames = stack_inputs(batch, stack, dtype, gen)
        grad_out = torch.randn((e, stack.out_dim), generator=gen, device="cuda").to(dtype)
        full = full_bound or dtype == torch.bfloat16
        res = k3_leaves(message, frames, stack, grad_out, upcast=dtype == torch.bfloat16) if full else {}
        res["leaf_tol"] = TOL[("K3", dname)]
        if dtype == torch.float32:
            kinks, res["kinks"] = kink_rows(f"{name} {dname}", message, frames, stack, grad_out)
            kink_free = grad_out.clone()
            kink_free[kinks] = 0.0
            res["kink_free"] = k3_leaves(message, frames, stack, kink_free, upcast=False)
            res["kink_free"]["leaf_tol"] = K3_KINK_FREE_TOL
            del kink_free
        print(f"phase {name} {dname}: " + json.dumps(res), flush=True)
        es = message.element_size()
        nbytes = e * (2 * stack.in_dim + 9 + stack.out_dim) * es + 2 * stack.weights.numel() * 4
        flops = 3 * e * stack_flops(stack)
        b_ms, b_by, bound_rate = route_bound_ms(nbytes, flops, dtype)
        checked = res if full else res["kink_free"]
        results[dname] = {
            **res,
            "max_abs_err": max(checked["d_message"]["max_abs_err"], checked["d_weights"]["max_abs_err"]),
            "ms": cuda_ms(lambda: edge_map_backward(message, frames, stack, grad_out), iters=5, warmup=1),
            "plain_ms": cuda_ms(
                lambda: edge_map_backward_plain(message, frames, stack, grad_out), iters=3, warmup=1
            ),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_rate": bound_rate,
            # float32: the same work at the CUDA-core float32 peak, beside it
            **({"bound_ms_cuda_cores": bound_ms(nbytes, flops, dtype)[0]} if dtype == torch.float32 else {}),
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "shape": [e, stack.in_dim, stack.out_dim, stack.weights.numel()],
        }
    print(f"phase {name}: " + json.dumps({
        d: {k: v for k, v in r.items() if k not in ("d_message", "d_weights", "leaves", "kink_free")}
        for d, r in results.items()
    }), flush=True)
    for dname, res in results.items():
        for label, r in (("", res if "leaves" in res else None), (" kink-free", res.get("kink_free"))):
            if r is None:
                continue
            for key in ("d_message", "d_weights"):
                check(r[key]["finite"], f"{name} {dname}{label}: non-finite {key}")
            for leaf, errs in r["leaves"].items():
                check(errs["vs_plain"] <= r["leaf_tol"],
                      f"{name} {dname}{label} {leaf}: norm rel err {errs['vs_plain']:.3g} vs plain {dname}")
                if "vs_upcast" in errs:
                    check(errs["vs_upcast"] <= upcast_tol,
                          f"{name} {dname} {leaf}: norm rel err {errs['vs_upcast']:.3g} vs float32 plain")
    print(f"phase {name}: ok")
    return results


def phase_forward(batches) -> dict:
    """The main path: full-width LBA prediction through gcpnet_torch.predict
    on the card, fp32 then bf16, with every kernel count set to 0 just
    before and read just after."""
    results = {}
    reset_counts()
    for dname, dtype in DTYPES.items():
        model = build_model(SEED, "cuda", dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, preds = [], []
        for batch in batches:
            k1, k2 = segment_sum_sorted.launches, edge_map.launches
            t0 = time.perf_counter()
            out = predict(model, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launched = (segment_sum_sorted.launches - k1, edge_map.launches - k2)
            check(launched == (8, 8), f"forward {dname}: launches (K1, K2) = {launched}, want (8, 8)")
            check(out.shape == (GRAPHS,), f"forward {dname}: output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"forward {dname}: non-finite predictions")
            preds.append(out.float().cpu())
        results[dname] = {
            "first_ms": times[0],
            "ms_per_batch": float(np.median(times[1:])),
            "ms_all": times,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "predictions_batch0": preds[0].tolist(),
        }
        del model
    results["launches"] = dict(zip(KERNEL_COUNTS, launch_counts()))
    check(launch_counts()[2:] == (0, 0), "forward: the backward kernel ran during prediction")
    results["bf16_vs_fp32_max_abs"] = (
        torch.tensor(results["bf16"]["predictions_batch0"])
        - torch.tensor(results["fp32"]["predictions_batch0"])
    ).abs().max().item()

    # the same weights and first batch on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu_pred = predict(build_model(SEED, "cpu", torch.float32), batches[0])
    results["cpu_seconds"] = time.perf_counter() - t0
    err = (cpu_pred - torch.tensor(results["fp32"]["predictions_batch0"])).abs().max().item()
    results["cpu_vs_card_fp32_max_abs"] = err
    check(err <= FORWARD_ATOL, f"forward: card vs CPU fp32 max abs {err:.3g} > {FORWARD_ATOL}")
    print("phase forward: ok " + json.dumps(results))
    return results


KERNEL_COUNTS = ("K1", "K2", "K3_bf16", "K3_fp32")


def launch_counts():
    """Each kernel's launch count, K3 by dtype, in the order of KERNEL_COUNTS."""
    k3 = edge_map_backward.dtype_launches
    return (segment_sum_sorted.launches, edge_map.launches, k3[torch.bfloat16], k3[torch.float32])


def reset_counts() -> None:
    segment_sum_sorted.launches = edge_map.launches = edge_map_backward.launches = 0
    for dtype in edge_map_backward.dtype_launches:
        edge_map_backward.dtype_launches[dtype] = 0


def phase_train(batch, dtype: torch.dtype = torch.bfloat16) -> dict:
    """A training path: the full-width LBA training step through
    gcpnet_torch.train (bf16 compute over float32 masters, or float32
    throughout; dropout 0.1, Adam at lr 1e-4) for TRAIN_STEPS steps on one
    batch, as the JAX benchmark reuses its batch, with every kernel count set
    to 0 just before and read just after; in float32 then one warm step
    under torch.profiler."""
    name = "train" if dtype == torch.bfloat16 else "train-fp32"
    model, state = build_lba_training(SEED, "cuda", dtype, lr=1e-4, dropout=0.1)
    dev_batch = batch.to(torch.device("cuda"))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    want = (8, 8, 8, 0) if dtype == torch.bfloat16 else (8, 8, 0, 8)
    times, losses, norms = [], [], []
    for step in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        result = train_step(model, state, dev_batch, graph_regression_loss, generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched = tuple(a - b for a, b in zip(launch_counts(), before))
        check(launched == want, f"{name} step {step}: launches {KERNEL_COUNTS} = {launched}, want {want}")
        losses.append(result.loss.item())
        norms.append(result.grad_norm.item())
        check(result.ok and np.isfinite(losses[-1]) and np.isfinite(norms[-1]),
              f"{name} step {step}: loss {losses[-1]}, grad norm {norms[-1]}")
    ms = float(np.median(times[1:]))
    results = {
        "launches": dict(zip(KERNEL_COUNTS, launch_counts())),
        "ms_per_step": ms,
        "graphs_per_s": GRAPHS / ms * 1e3,
        "first_ms": times[0],
        "ms_all": times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses,
        "grad_norms": norms,
        "steps": TRAIN_STEPS,
    }
    if dtype == torch.float32:
        results["profile"] = device_profile(
            lambda: train_step(model, state, dev_batch, graph_regression_loss, generator)
        )
    print(f"phase {name}: ok " + json.dumps(results))
    return results


def _step_outcome(build, dev: str, batch, loss_fn, noise_seed=None) -> dict:
    """One float32 training step (no dropout) of ``build(dev)`` on ``batch``:
    seconds, loss, gradient norm, gradients and updated parameters.  With
    ``noise_seed`` every weight is first multiplied by 1 + 2^-24 z (z
    standard normal from that seed): a float32 rounding's worth of noise."""
    model, state = build(dev)
    if noise_seed is not None:
        gen = torch.Generator().manual_seed(noise_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0**-24 * torch.randn(p.shape, generator=gen).to(p.device))
    t0 = time.perf_counter()
    result = train_step(model, state, batch.to(torch.device(dev)), loss_fn, deterministic=True)
    if dev == "cuda":
        torch.cuda.synchronize()
    return {
        "seconds": time.perf_counter() - t0,
        "loss": result.loss.item(),
        "grad_norm": result.grad_norm.item(),
        "grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()]).cpu(),
        "params": torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu(),
    }


def _step_diffs(a: dict, b: dict) -> dict:
    """How far two step outcomes part, in TRAIN_CHECK_ATOL's terms."""
    param_diff = (a["params"] - b["params"]).abs()
    return {
        "grads_norm_rel": norm_rel_err(a["grads"], b["grads"]),
        "params": param_diff.max().item(),
        "params_share_above_1e-6": (param_diff > 1e-6).float().mean().item(),
    }


def card_vs_cpu_step(name: str, build, batch, loss_fn, layers: int, rounding_draws: int = 0) -> dict:
    """One float32 training step on the card against the same step on the
    CPU (plain versions): ``build(device) -> (model, state)`` gives both the
    same weights; the same host ``batch``, no dropout.  Held to
    TRAIN_CHECK_ATOL; the card's step launches the fp32 K3 once a layer.
    With ``rounding_draws``, the gradients and updated parameters may also
    part as far as ROUNDING_SPREAD_FACTOR times the CPU step parts from
    itself under a float32 rounding's worth of weight noise (the largest of
    that many draws): for a step whose gradient float32 rounding alone
    moves by more than TRAIN_CHECK_ATOL."""
    reset_counts()
    card = _step_outcome(build, "cuda", batch, loss_fn)
    fp32_k3 = launch_counts()[3]
    cpu = _step_outcome(build, "cpu", batch, loss_fn)
    param_diff = (card["params"] - cpu["params"]).abs()
    results = {
        "loss_card": card["loss"], "loss_cpu": cpu["loss"],
        "loss_abs_diff": abs(card["loss"] - cpu["loss"]),
        "grad_norm_card": card["grad_norm"], "grad_norm_cpu": cpu["grad_norm"],
        "grad_norm_abs_diff": abs(card["grad_norm"] - cpu["grad_norm"]),
        "grads_norm_rel_err": norm_rel_err(card["grads"], cpu["grads"]),
        "params_max_abs_diff": param_diff.max().item(),
        "params_share_above_1e-6": (param_diff > 1e-6).float().mean().item(),
        "num_params": int(param_diff.numel()),
        "card_seconds": card["seconds"], "cpu_seconds": cpu["seconds"],
        "launches": {"K3_fp32": fp32_k3},
    }
    bound = {k: TRAIN_CHECK_ATOL[k] for k in ("grads_norm_rel", "params", "params_share_above_1e-6")}
    if rounding_draws:
        draws = [_step_diffs(cpu, _step_outcome(build, "cpu", batch, loss_fn, noise_seed=i))
                 for i in range(rounding_draws)]
        spread = {k: max(d[k] for d in draws) for k in bound}
        results["cpu_rounding_spread"] = spread
        bound = {k: max(v, ROUNDING_SPREAD_FACTOR * spread[k]) for k, v in bound.items()}
        results["bound"] = bound
    print(f"phase {name}: " + json.dumps(results), flush=True)
    check(fp32_k3 == layers, f"{name}: fp32 K3 launches {fp32_k3}, want {layers}")
    check(results["loss_abs_diff"] <= TRAIN_CHECK_ATOL["loss"], f"{name}: loss differs")
    check(results["grad_norm_abs_diff"] <= TRAIN_CHECK_ATOL["grad_norm"], f"{name}: grad norm differs")
    check(results["grads_norm_rel_err"] <= bound["grads_norm_rel"], f"{name}: gradients differ")
    check(results["params_max_abs_diff"] <= bound["params"], f"{name}: parameters differ")
    check(results["params_share_above_1e-6"] <= bound["params_share_above_1e-6"],
          f"{name}: too many parameters differ")
    print(f"phase {name}: ok")
    return results


def phase_train_check() -> dict:
    """The LBA step on the card against the CPU: full width,
    TRAIN_CHECK_LAYERS interaction layers of 8-layer stacks,
    TRAIN_CHECK_GRAPHS graphs of 448 atoms."""
    batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0]
    return card_vs_cpu_step(
        "train-check",
        lambda dev: build_lba_training(
            SEED, dev, torch.float32, lr=1e-4, dropout=0.0, num_encoder_layers=TRAIN_CHECK_LAYERS
        ),
        batch, graph_regression_loss, TRAIN_CHECK_LAYERS,
    )


def _grad_step(batch, dtype) -> dict:
    """One training step at the train-check's size (no dropout) on the card
    in ``dtype``: loss, gradient norm and the float32 masters' gradients."""
    model, state = build_lba_training(
        SEED, "cuda", dtype, lr=1e-4, dropout=0.0, num_encoder_layers=TRAIN_CHECK_LAYERS
    )
    result = train_step(model, state, batch, graph_regression_loss, deterministic=True)
    return {
        "loss": result.loss.item(),
        "grad_norm": result.grad_norm.item(),
        "grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
    }


def phase_bf16_check() -> dict:
    """The bf16 training step's gradients against the fp32 step's, on the
    card: through the kernels (K2's forward and K3's recompute run the
    same bf16 layer body, so they round alike) and
    through the plain stack in bf16 (autograd through edge_map_plain, whose
    forward and backward also round alike)."""
    batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0].to(torch.device("cuda"))
    ref = _grad_step(batch, torch.float32)
    reset_counts()
    runs = {"kernels": _grad_step(batch, torch.bfloat16)}
    bf16_k3 = launch_counts()[2]
    real = message_passing.edge_map
    message_passing.edge_map = edge_map_plain
    try:
        runs["plain_stack"] = _grad_step(batch, torch.bfloat16)
    finally:
        message_passing.edge_map = real
    results = {
        name: {
            "loss_rel_diff": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm_rel_diff": abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            "grads_cosine": torch.nn.functional.cosine_similarity(r["grads"], ref["grads"], dim=0).item(),
            "grads_norm_rel_err": norm_rel_err(r["grads"], ref["grads"]),
        }
        for name, r in runs.items()
    }
    results["kernels_vs_plain_stack_grads_norm_rel_err"] = norm_rel_err(
        runs["kernels"]["grads"], runs["plain_stack"]["grads"]
    )
    results["launches"] = {"K3_bf16": bf16_k3}
    print("phase bf16-check: " + json.dumps(results), flush=True)
    check(bf16_k3 == TRAIN_CHECK_LAYERS, f"bf16-check: bf16 K3 launches {bf16_k3}")
    r = results["kernels"]
    check(r["loss_rel_diff"] <= BF16_STEP_TOL["loss_rel"], "bf16-check: loss differs")
    check(r["grad_norm_rel_diff"] <= BF16_STEP_TOL["grad_norm_rel"], "bf16-check: grad norm differs")
    check(r["grads_cosine"] >= BF16_STEP_TOL["grads_cosine"], "bf16-check: gradients differ")
    print("phase bf16-check: ok")
    return results


def device_profile(fn) -> dict:
    """Run ``fn`` once under torch.profiler: wall time, device busy time
    (the sum of the CUDA kernels' times; one stream, so they do not
    overlap), idle share and time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # user annotations (``Optimizer.step#Adam.step``) also appear on the
    # device's timeline, as ranges over the kernels they launched: not work
    kernels = [
        e for e in prof.events() if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    by_name = {}
    for e in kernels:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0][:80]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    labels = (
        ("K3 edge_map_backward", ("edge_map_bwd", "sum_partials")),
        ("K2 edge_map", ("edge_map_tc",)),
        ("K1 segment_sum_sorted", ("seg_sum",)),
    )
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if kernels else "not measured",
        "device_idle_share": 1 - busy_us / wall_us if kernels else "not measured",
        "kernel_launches": len(kernels),
        "share": {
            label: sum(v for k, v in by_name.items() if any(key in k for key in keys)) / busy_us
            if kernels else "not measured"
            for label, keys in labels
        },
        "top_ms": [[k, v / 1e3] for k, v in top],
    }


def phase_profile(batches) -> dict:
    """Where the time goes: one warm bf16 full-width forward, and one warm
    bf16 full-width training step, each under torch.profiler."""
    model = build_model(SEED, "cuda", torch.bfloat16)
    predict(model, batches[0])
    result = {"forward": device_profile(lambda: predict(model, batches[1]))}
    del model
    model, state = build_lba_training(SEED, "cuda", torch.bfloat16, lr=1e-4, dropout=0.1)
    dev_batch = batches[0].to(torch.device("cuda"))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    train_step(model, state, dev_batch, graph_regression_loss, generator)
    result["train_step"] = device_profile(
        lambda: train_step(model, state, dev_batch, graph_regression_loss, generator)
    )
    print("phase profile: ok " + json.dumps(result))
    return result


def nms_message_passing() -> GCPMessagePassing:
    """One message passing layer of the NMS model (8 GCP2 layers, hidden
    64/16, edges 32/4), random weights from the seed."""
    model_cfg, module_cfg, layer_cfg = nms_configs()
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def phase_nms_data(data_root: str):
    """The small_20body splits, simulated on the card by the "torch"
    integrator at NMS_SPLITS' counts (the published 10,000 / 2,000 / 2,000
    cut to fit the run's time), featurized into batches of 100 graphs."""
    t0 = time.perf_counter()
    dm = NMSDataModule(
        data_root=data_root, data_mode="small_20body", batch_size=NMS_BATCH, sim_device="cuda", **NMS_SPLITS
    )
    dm.prepare_data()
    seconds = time.perf_counter() - t0
    dm.setup()
    batch = next(dm.val_batches())
    shape = {"nodes": batch.num_nodes, "edges": batch.num_edges, "graphs": batch.num_graphs}
    check(shape == {"nodes": NMS_BATCH * 20, "edges": NMS_BATCH * 20 * 19, "graphs": NMS_BATCH},
          f"nms-data: batch shape {shape}")
    results = {"simulate_seconds": seconds, "splits": dict(NMS_SPLITS), "batch": shape}
    print("phase nms-data: ok " + json.dumps(results))
    return dm, results


def phase_nms_kernels(dm) -> dict:
    """K1, K2 and K3 at the NMS step's shape (a batch of 100 20-body graphs:
    38,000 receiver-sorted CSR rows into 2,000 nodes), fp32 and bf16."""
    batch = next(dm.val_batches())
    width = 64 + 3 * 16
    results = {
        "K1": phase_k1({1: batch}, d_out=width, name="nms-K1"),
        "K2": phase_k2(batch, nms_message_passing(), name="nms-K2"),
        "K3": phase_k3(batch, nms_message_passing(), name="nms-K3", full_bound=False),
    }
    for kernel, res in results.items():
        for key, r in res.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print("phase nms-kernels: ok " + json.dumps({
        k: {d: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms", "library_ms")}
            for d, r in res.items()}
        for k, res in results.items()
    }))
    return results


def phase_nms_check(data_root: str) -> dict:
    """One NMS training step on the card against the CPU: full width,
    NMS_CHECK_LAYERS interaction layers, NMS_CHECK_GRAPHS graphs."""
    dm = NMSDataModule(
        data_root=data_root, data_mode="small_20body", batch_size=NMS_CHECK_GRAPHS, **NMS_SPLITS
    )
    dm.setup()

    def build(dev):
        model = GCPNetNMS(
            *nms_configs(NMS_CHECK_LAYERS, dropout=0.0), generator=torch.Generator().manual_seed(SEED), device=dev
        )
        return model, TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}))

    return card_vs_cpu_step("nms-check", build, next(dm.val_batches()), nms_loss, NMS_CHECK_LAYERS)


class EpochClock:
    """A trainer logger that keeps each logged line with the seconds since
    the previous one (or since it was made)."""

    def __init__(self):
        self.last = time.perf_counter()
        self.lines = []

    def log_metrics(self, metrics, step=None) -> None:
        now = time.perf_counter()
        self.lines.append({**metrics, "step": step, "seconds": now - self.last})
        self.last = now


def phase_nms_fit(dm, ckpt_dir: str) -> dict:
    """The NMS path: the full-width NMS model with the experiment's defaults
    (fp32, dropout 0.1, Adam at 1e-4) fitted by the Trainer for NMS_EPOCHS
    epochs with checkpoints; a new Trainer resumes from the last checkpoint
    to epoch NMS_RESUME_EPOCHS and tests the best checkpoint; then one warm
    step under torch.profiler.  Every kernel count is set to 0 just before
    the fit and read just after it; each training step's launches are read
    around it."""
    per_step = []
    real_step = trainer_module.train_step

    def counted_step(*args, **kw):
        before = launch_counts()
        result = real_step(*args, **kw)
        per_step.append(tuple(a - b for a, b in zip(launch_counts(), before)))
        return result

    results = {}
    trainer_module.train_step = counted_step
    try:
        clock = EpochClock()
        trainer = build_nms_trainer(SEED, "cuda", max_epochs=NMS_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        clock.last = time.perf_counter()
        trainer.fit(dm)
        torch.cuda.synchronize()
        results["launches"] = dict(zip(KERNEL_COUNTS, launch_counts()))
        results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.state.step
        results["steps"] = steps
        results["launches_per_step"] = sorted(set(per_step))

        resumed_clock = EpochClock()
        resumed = build_nms_trainer(
            SEED + 1, "cuda", max_epochs=NMS_RESUME_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[resumed_clock]
        )
        resumed.load_checkpoint_state(resumed.ckpt.restore_last(map_location="cuda"))
        same = all(torch.equal(p, q) for p, q in zip(trainer.model.parameters(), resumed.model.parameters()))
        results["resumed_step"] = resumed.state.step
        results["resumed_weights_equal"] = same
        resumed.fit(dm, resume=True)
        best = resumed.restore_best()
        logged = resumed.ckpt.metrics(best)["val/loss"]
        again = resumed.eval_epoch(dm.val_batches())["val/loss"]
        test = resumed.test(dm)
        torch.cuda.synchronize()
    finally:
        trainer_module.train_step = real_step
    epochs = clock.lines + resumed_clock.lines[:-1]
    results.update({
        "epochs": [
            {k: line[k] for k in ("epoch", "seconds", "train/loss", "val/loss", "val/RMSE", "val/CosineSimilarity")}
            | {"train_graphs_per_s": line["train/steps_per_sec"] * NMS_BATCH}
            for line in epochs
        ],
        "best_step": best,
        "best_val_loss_logged": logged,
        "best_val_loss_again": again,
        "test": test,
        "final_step": resumed.state.step,
    })
    check(results["final_step"] == steps * NMS_RESUME_EPOCHS // NMS_EPOCHS, "nms-fit: resumed steps")
    batch = next(dm.train_batches(seed=0)).to(torch.device("cuda"))
    warm = lambda: train_step(resumed.model, resumed.state, batch, nms_loss, resumed.generator)  # noqa: E731
    warm()
    results["profile"] = device_profile(warm)
    print("phase nms-fit: " + json.dumps(results), flush=True)

    wanted = ("train/loss", "val/loss", "val/RMSE", "val/CosineSimilarity")
    for line in epochs:
        check(all(k in line and math.isfinite(line[k]) for k in wanted), f"nms-fit: epoch line {line}")
    check(all(k in test and math.isfinite(test[k]) for k in ("test/loss", "test/RMSE", "test/CosineSimilarity")),
          f"nms-fit: test metrics {test}")
    check([line["epoch"] for line in epochs] == list(range(NMS_RESUME_EPOCHS)), "nms-fit: epochs run")
    layers = nms_configs()[0].num_encoder_layers
    want = (layers, layers, 0, layers)
    check(results["launches_per_step"] == [want],
          f"nms-fit: launches {KERNEL_COUNTS} per step {results['launches_per_step']}, want {want}")
    check(results["launches"]["K3_fp32"] == layers * steps, f"nms-fit: K3 launches {results['launches']}")
    check(results["resumed_step"] == steps and same, "nms-fit: the resumed state is not the saved one")
    check(abs(again - logged) <= NMS_VAL_RTOL * abs(logged),
          f"nms-fit: best checkpoint's val/loss {again} against {logged} logged")
    print("phase nms-fit: ok")
    return results


def rs_message_passing() -> GCPMessagePassing:
    """One message passing layer of the RS model (8 GCP2 layers with leaky
    relu, hidden 100/16, edges 32/4: LBA's widths), random weights from the
    seed."""
    model_cfg, module_cfg, layer_cfg = rs_configs()
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def phase_rs_data():
    """The synthetic RS splits at the JAX module's sizes, and the shape of
    a paired training batch: the bucket's rows (what K2 and K3 see) and the
    real ones (what K1 sums)."""
    t0 = time.perf_counter()
    dm = RSDataModule(seed=42)
    dm.setup()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = next(dm.train_batches(seed=0))
    batch_seconds = time.perf_counter() - t0
    shape = {
        "nodes": batch.num_nodes, "edges": batch.num_edges, "graphs": batch.num_graphs,
        "real_nodes": int(batch.node_pad_mask.sum()), "real_edges": int(batch.edge_pad_mask.sum()),
        "real_graphs": int(batch.graph_pad_mask.sum()),
    }
    results = {
        "setup_seconds": seconds, "first_batch_seconds": batch_seconds,
        "graphs": {split: len(g) for split, g in dm.graphs.items()}, "batch": shape,
        "train_batches_per_epoch": len(dm.sampler("train")),
    }
    check(results["graphs"] == {"train": 4096, "valid": 512, "test": 512}, f"rs-data: splits {results['graphs']}")
    check(shape["graphs"] == shape["real_graphs"] == 128 and (shape["nodes"], shape["edges"]) == (8192, 16384),
          f"rs-data: batch shape {shape}")
    print("phase rs-data: ok " + json.dumps(results))
    return dm, results


def phase_rs_kernels(dm) -> dict:
    """K1, K2 and K3 at the RS training step's shape (a paired batch: the
    bucket's 16,384 edge rows into 8,192 nodes; K1 sums the real rows of
    its CSR splits), fp32 and bf16, the stack's leaky relu included."""
    batch = next(dm.train_batches(seed=0))
    results = {
        "K1": phase_k1({1: batch}, name="rs-K1"),
        "K2": phase_k2(batch, rs_message_passing(), name="rs-K2"),
        "K3": phase_k3(batch, rs_message_passing(), name="rs-K3", full_bound=False, upcast_tol=K3_UPCAST_TOL_RS),
    }
    for kernel, res in results.items():
        for key, r in res.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print("phase rs-kernels: ok " + json.dumps({
        k: {d: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms", "library_ms")}
            for d, r in res.items()}
        for k, res in results.items()
    }))
    return results


def phase_rs_check(dm) -> dict:
    """One RS training step on the card against the CPU: full width,
    RS_CHECK_LAYERS interaction layers, a paired training batch."""

    def build(dev):
        model = GCPNetRS(
            *rs_configs(RS_CHECK_LAYERS, dropout=0.0), generator=torch.Generator().manual_seed(SEED), device=dev
        )
        return model, TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}))

    return card_vs_cpu_step("rs-check", build, next(dm.train_batches(seed=0)), rs_loss, RS_CHECK_LAYERS,
                            rounding_draws=RS_ROUNDING_DRAWS)


def phase_rs_fit(dm, ckpt_dir: str):
    """The RS path: the full-width RS model with the experiment's defaults
    (fp32, dropout 0.1, Adam at 1e-4, seed 42) fitted by the Trainer for
    RS_EPOCHS epochs with checkpoints, then the best checkpoint's test.
    Every kernel count is set to 0 just before the fit and read just after;
    each training step's launches are read around it."""
    per_step = []
    real_step = trainer_module.train_step

    def counted_step(*args, **kw):
        before = launch_counts()
        result = real_step(*args, **kw)
        per_step.append(tuple(a - b for a, b in zip(launch_counts(), before)))
        return result

    clock = EpochClock()
    trainer = build_rs_trainer(42, "cuda", max_epochs=RS_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock])
    trainer_module.train_step = counted_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        clock.last = time.perf_counter()
        trainer.fit(dm)
        torch.cuda.synchronize()
        launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    finally:
        trainer_module.train_step = real_step
    steps = trainer.state.step
    best = trainer.restore_best()
    test = trainer.test(dm)
    graphs = dm.bucket().num_graphs
    results = {
        "launches": launches,
        "launches_per_step": sorted(set(per_step)),
        "steps": steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "epochs": [
            {k: line[k] for k in ("epoch", "seconds", "train/loss", "val/loss", "val/Accuracy", "val/F1")}
            | {"train_graphs_per_s": line["train/steps_per_sec"] * graphs}
            for line in clock.lines[:RS_EPOCHS]
        ],
        "best_step": best,
        "test": test,
    }
    print("phase rs-fit: " + json.dumps(results), flush=True)
    wanted = ("train/loss", "val/loss", "val/Accuracy", "val/F1")
    check([line["epoch"] for line in results["epochs"]] == list(range(RS_EPOCHS)), "rs-fit: epochs run")
    for line in clock.lines[:RS_EPOCHS]:
        check(all(k in line and math.isfinite(line[k]) for k in wanted), f"rs-fit: epoch line {line}")
    check(all(k in test and math.isfinite(test[k]) for k in ("test/loss", "test/Accuracy", "test/F1")),
          f"rs-fit: test metrics {test}")
    layers = rs_configs()[0].num_encoder_layers
    want = (layers, layers, 0, layers)
    check(results["launches_per_step"] == [want],
          f"rs-fit: launches {KERNEL_COUNTS} per step {results['launches_per_step']}, want {want}")
    check(results["steps"] == RS_EPOCHS * len(dm.sampler("train")), f"rs-fit: {results['steps']} steps")
    check(launches["K3_fp32"] == layers * results["steps"], f"rs-fit: K3 launches {launches}")
    print("phase rs-fit: ok")
    return trainer, results


def phase_rs_profile(trainer, dm) -> dict:
    """One warm RS training step of the fitted model under torch.profiler."""
    batch = next(dm.train_batches(seed=0)).to(torch.device("cuda"))
    warm = lambda: train_step(trainer.model, trainer.state, batch, rs_loss, trainer.generator)  # noqa: E731
    warm()
    results = device_profile(warm)
    print("phase rs-profile: ok " + json.dumps(results))
    return results


def kernel_line(report) -> dict:
    """The contract line: K1 and K2 at bf16 (the production precision) on
    the tile-aligned layout the main path uses, fp32 and K1's CSR layout
    beside them, launches from the bf16 training run (the prediction run's
    beside them); K3 as its two instantiations, bf16 (launched by the bf16
    training run) and fp32 (split TF32, launched by the fp32 training
    run).  Under "nms", each kernel at the NMS step's shape and its
    launches a step of the NMS fit, read by dtype (the fit is fp32, so the
    bf16 K3's count is 0); under "rs" the same at the RS step's shape and
    the RS fit."""
    k1, k2, k3 = report["K1"], report["K2"], report["K3"]
    forward, train, train_fp32 = report["forward"], report["train"], report["train_fp32"]
    nk, nms_steps = report["nms_kernels"], report["nms_fit"]["launches_per_step"][0]
    rk, rs_steps = report["rs_kernels"], report["rs_fit"]["launches_per_step"][0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    replaces_k3 = "gcpnet_tpu/ops/pallas_fused.py:175"

    def row(name, source, replaces, launches, main, dtype, **extra):
        return {
            "name": name, "route": "cuda", "source": f"gcpnet_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, **{k: main[k] for k in keys}, "dtype": dtype, **extra,
        }

    def nms(results, launches_per_step, **by_dtype):
        return {
            "shape": next(iter(results.values()))["shape"], "launches_per_step": launches_per_step,
            **{d: {k: results[key][k] for k in (*keys, "share_of_bound")} for d, key in by_dtype.items()},
        }

    return {
        "kernels": [
            row("segment_sum_sorted", "segment_sorted.cu", "gcpnet_tpu/ops/pallas_segment.py:160",
                train["launches"]["K1"], k1["tile128_bf16"], "bf16",
                forward_launches=forward["launches"]["K1"],
                **{f"fp32_{k}": k1["tile128_fp32"][k] for k in keys},
                **{f"csr_{k}": k1["tile1_bf16"][k] for k in keys},
                **{f"csr_fp32_{k}": k1["tile1_fp32"][k] for k in keys},
                nms=nms(nk["K1"], nms_steps[0], fp32="tile1_fp32", bf16="tile1_bf16"),
                rs=nms(rk["K1"], rs_steps[0], fp32="tile1_fp32", bf16="tile1_bf16")),
            row("edge_map", "edge_map_tc.cu", "gcpnet_tpu/ops/pallas_fused.py:117", train["launches"]["K2"],
                k2["bf16"], "bf16", forward_launches=forward["launches"]["K2"],
                bound_rate=k2["bf16"]["bound_rate"],
                **{f"fp32_{k}": k2["fp32"][k] for k in (*keys, "bound_rate")},
                nms=nms(nk["K2"], nms_steps[1], fp32="fp32", bf16="bf16"),
                rs=nms(rk["K2"], rs_steps[1], fp32="fp32", bf16="bf16")),
            row("edge_map_backward_tc", "edge_map_bwd_tc.cu", replaces_k3, train["launches"]["K3_bf16"],
                k3["bf16"], "bf16", forward_launches=forward["launches"]["K3_bf16"],
                bound_rate=k3["bf16"]["bound_rate"], nms=nms(nk["K3"], nms_steps[2], bf16="bf16"),
                rs=nms(rk["K3"], rs_steps[2], bf16="bf16")),
            row("edge_map_backward_tc_fp32", "edge_map_bwd_tc.cu", replaces_k3, train_fp32["launches"]["K3_fp32"],
                k3["fp32"], "fp32", bound_rate=k3["fp32"]["bound_rate"],
                bound_ms_cuda_cores=k3["fp32"]["bound_ms_cuda_cores"],
                nms=nms(nk["K3"], nms_steps[3], fp32="fp32"),
                rs=nms(rk["K3"], rs_steps[3], fp32="fp32")),
        ]
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out-dir", default=os.path.join("logs", "chip_smoke"),
        help="directory for the full measurements and the ptxas report",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's checks need the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    os.makedirs(args.out_dir, exist_ok=True)
    # the simulated NMS splits (~70 MB) and checkpoints are removed at the end
    work = tempfile.mkdtemp(prefix="chip_smoke_nms_")
    data_root, ckpt_dir = os.path.join(work, "data"), os.path.join(args.out_dir, "nms_checkpoints")
    rs_ckpt_dir = os.path.join(args.out_dir, "rs_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(rs_ckpt_dir, ignore_errors=True)
    report = {}
    try:
        report["device"] = phase_device()
        report["build"] = phase_build(args.out_dir)
        batches = synthetic_batches(FORWARD_BATCHES, GRAPHS, NODES, EDGES_PER_NODE, SEED)
        csr = synthetic_batches(1, GRAPHS, NODES, EDGES_PER_NODE, SEED, sort_tile=1)[0]
        report["K1"] = phase_k1({128: batches[0], 1: csr})
        report["K2"] = phase_k2(batches[0], bench_message_passing())
        report["K3"] = phase_k3(batches[0], bench_message_passing())
        report["forward"] = phase_forward(batches)
        report["train"] = phase_train(batches[0])
        report["train_fp32"] = phase_train(batches[0], torch.float32)
        report["train_check"] = phase_train_check()
        report["bf16_check"] = phase_bf16_check()
        report["profile"] = phase_profile(batches)
        dm, report["nms_data"] = phase_nms_data(data_root)
        report["nms_kernels"] = phase_nms_kernels(dm)
        report["nms_check"] = phase_nms_check(data_root)
        report["nms_fit"] = phase_nms_fit(dm, ckpt_dir)
        del dm
        rs_dm, report["rs_data"] = phase_rs_data()
        report["rs_kernels"] = phase_rs_kernels(rs_dm)
        report["rs_check"] = phase_rs_check(rs_dm)
        rs_trainer, report["rs_fit"] = phase_rs_fit(rs_dm, rs_ckpt_dir)
        report["rs_profile"] = phase_rs_profile(rs_trainer, rs_dm)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(rs_ckpt_dir, ignore_errors=True)
        report["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(f"chip_smoke: every phase ok in {report['seconds']:.1f} s")
    print(json.dumps(kernel_line(report)))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": report["device"]["kind"], "count": report["device"]["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
