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
  6. nms-data: the NMS small_20body splits (2,000 / 500 / 500 trajectories)
     simulated on the card by gcpnet_torch.data.nms_sim's "torch" integrator,
     as batches of 100 20-body graphs (2,000 nodes, 38,000 CSR edge rows);
  7. nms-kernels: K1, K2 and K3 at the NMS step's shape against their plain
     versions, fp32 and bf16, with their times, bounds and shares of them;
  8. rs-data: the RS splits, synthetic enantiomer pairs at the JAX module's
     sizes (4,096 / 512 / 512 graphs), and a paired training batch (64
     anchors and their enantiomers: 128 graphs, a bucket of 8,192 nodes and
     16,384 CSR edge rows, about 1,400 and 2,600 of them real);
  9. rs-kernels: K1, K2 and K3 at the RS step's shape against their plain
     versions, fp32 and bf16, the stack's leaky relu included, with their
     times, bounds and shares of them;
 10. forward: the LBA forward at the benchmark's full width (16 graphs x 448
     atoms, 8 interaction layers x 8 message layers) through
     gcpnet_torch.predict, fp32 and bf16, eager and served (Predictor: a
     CUDA graph captured at the first batch, replayed for the rest): launch
     counts, finiteness, latency, peak memory, the served predictions
     against the eager ones; then the fp32 predictions against the same
     weights and batch run on the CPU through the plain versions;
 11. train: the full-width LBA training step through gcpnet_torch.train
     (bf16 over fp32 masters, dropout 0.1, Adam at lr 1e-4, the adaptive
     clip, a StepLR schedule), 6 steps on one batch, twice eagerly and once
     captured (the first step runs eagerly and captures, 5 replays, each
     under torch.cuda.set_sync_debug_mode("error")): the wrappers' launches
     per step (a replay runs none), finiteness, ms per step, graphs/s, peak
     memory; the captured run's parameters, moments and losses against the
     eager run's; a batch with a NaN label replayed through the graph
     leaves the state as it was; one warm eager step and one replay under
     torch.profiler (device busy and idle share, kernels by name and count
     read from the trace, the host's CUDA API calls);
 12. train-fp32: the same in float32 (the JAX Trainer's default precision;
     every K3 launch is one of the tensor-core kernel, K3's only one);
 13. train-check: one fp32 training step on the card against the same step
     on the CPU (2 interaction layers, 2 graphs, no dropout): loss, gradient
     norm, gradients and updated parameters; its launches of the fp32 K3;
 14. bf16-check: the bf16 training step's gradients against the fp32
     step's on the card (the train-check's size), through the kernels and
     through the plain stack in bf16;
 15. profile: one warm bf16 forward, eager and replayed, under
     torch.profiler (device busy and idle share, time by kernel, the
     host's CUDA API calls);
 16. nms-check: one fp32 NMS training step on the card against the CPU (2
     interaction layers, 10 graphs, no dropout);
 17. nms-fit: the NMS path, the full-width NMS model fitted by the Trainer
     (fp32, the experiment's defaults) with scan_chunk_size 4 (4 batches a
     replay of a CUDA graph) for 3 epochs with checkpoints, then a new
     Trainer resumes to epoch 4 and tests the best checkpoint: the
     wrappers' launches (only the graphs' first calls run them),
     per-epoch seconds, train graphs/s, val/loss and val/RMSE, peak memory;
     the first epoch run eagerly step by step beside it (its losses held
     to the captured epoch's, the parameters' distance printed); 16 steps
     and the validation batches run captured and eagerly under
     torch.use_deterministic_algorithms, equal bit for bit; one warm eager
     step and one
     replay of a train and an eval chunk under torch.profiler, the kernels
     a step read from the trace (4 of each);
 18. rs-check: one fp32 RS training step on the card against the CPU (2
     interaction layers, a paired batch, no dropout);
 19. rs-fit: the RS path, the full-width RS model fitted by the Trainer
     (fp32, the experiment's defaults) with scan_chunk_size 4 for 3 epochs
     with checkpoints, then the best checkpoint's test: the wrappers'
     launches, per-epoch seconds, train graphs/s, val/loss, val/Accuracy
     and val/F1, peak memory; the first epoch run eagerly beside it, and
     the deterministic parity run, as nms-fit;
 20. rs-profile: one warm eager RS training step and one replay of a train
     and an eval chunk under torch.profiler; the rs-fit's checks.
Then the total time, one JSON line with every kernel's numbers (at the NMS
and RS shapes too), the nvidia-smi line, and the final status line.  Any failed phase exits non-zero; without a CUDA device
the script exits non-zero before printing any result.  Full measurements go
to <out-dir>/chip_smoke.json (``--out-dir``, default logs/chip_smoke).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
from gcpnet_torch.predict import DTYPES, Predictor, build_model, lba_configs, predict, synthetic_batches
from gcpnet_torch.train.cli import build_lba_training, build_nms_trainer, build_rs_trainer, nms_configs, rs_configs
from gcpnet_torch.train.graphs import TrainSteps
from gcpnet_torch.train.optim import build_optimizer, build_schedule
from gcpnet_torch.train.state import TrainState
from gcpnet_torch.train.step import eval_step, train_step
from gcpnet_torch.train.trainer import prefetched

SEED = 0
GRAPHS, NODES, EDGES_PER_NODE = 16, 448, 28
FORWARD_BATCHES = 4  # the first is the cold one; latency is over the rest
TRAIN_STEPS = 6  # the first is the cold one; ms per step is over the rest
# the train phases' schedule (beside the adaptive clip): a NaN replay must
# leave its count and rate as they were
TRAIN_SCHEDULE = {"_target_": "StepLR", "step_size": 2, "gamma": 0.9}
TRAIN_LR = 1e-4
# the fits' scan_chunk_size: 4 training or validation batches a replay
FIT_CHUNK = 4
FIT_LR = 1e-4  # the NMS and RS experiments' Adam rate
# kernel names in a profiler trace, by the kernel they belong to
KERNEL_NAMES = {"K1": "seg_sum", "K2": "edge_map_tc_kernel", "K3": "edge_map_bwd_tc_kernel"}
# the same in KERNEL_COUNTS' order, K3 by its instantiation
TRACE_NAMES = {
    "K1": "seg_sum", "K2": "edge_map_tc_kernel", "K3_bf16": "edge_map_bwd_tc_kernel<__nv_bfloat16>",
    "K3_fp32": "edge_map_bwd_tc_kernel<float>",
}
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
# The captured training steps against the eager ones, TRAIN_STEPS steps
# from the same weights and generator seed (the same dropout masks): the
# glue's index_add_ adds with atomics in another order on every run, so
# two eager runs part as well.  The parameters: Adam moves an entry by up
# to about lr a step whatever its gradient's size, so an entry whose
# gradient lies within rounding of 0 may go the other way in the other
# run, but few do; at most REPLAY_PARAM_SHARE of the entries may part by
# more than REPLAY_PARAM_ATOL_LR * lr, and none by more than 2 lr a step.
# A replay that skipped its update or read stale weights parts by about
# lr in nearly every entry: the share of entries the eager run moved that
# far from its start is printed beside the check (param_gap).  Adam's
# moments in norm-relative terms, each step's loss and gradient norm
# relative: the captured run may part from the first eager run by
# REPLAY_SPREAD_FACTOR times what the second eager run does, or by
# REPLAY_TOL where that is less.  On the H100 the bf16 runs agree bit for
# bit; in fp32 two eager runs part by 1.0e-4 and 2.6e-4 in the parameters
# (max abs), 3.6e-4 and 9.7e-4 in the first moment, 9e-7 and 3.2e-6 in
# the losses (two calls), and the captured run as far (up to 2.2 times the
# eager pair's distance); the floors are ten times the largest distance
# measured.
REPLAY_PARAM_ATOL_LR, REPLAY_PARAM_SHARE = 0.1, 0.01
REPLAY_TOL = {"exp_avg": 1e-2, "exp_avg_sq": 1e-3, "losses": 1e-4, "grad_norms": 1e-3}
REPLAY_SPREAD_FACTOR = 4.0
# A fit's first epoch, captured, against the same epoch run eagerly step by
# step (train_step, eval_step): the same weights, batches and dropout
# masks, the atomics' order apart.  The losses relative: NMS 1e-4 (on the
# H100 the two part by 4e-9); RS 1e-3, as its gradients at initialization
# are residuals of enantiomer pairs that nearly cancel, which float32
# rounding alone moves by ~1e-3 relative (rs-check's CPU spread).  The
# parameters after the epoch are printed (param_gap), not held: RS
# amplifies the atomics' order, so that on the H100 the captured and the
# eager RS epoch part by more than lr/10 in 97% of the entries, about as
# many as the epoch moves that far.  What holds the replays is
# FIT_PARITY_STEPS steps and the validation batches run both ways under
# torch.use_deterministic_algorithms, where the glue sums in a fixed
# order: the parameters, losses and generator must then be equal bit for
# bit (fit_parity).
FIT_EAGER_RTOL = {"nms-fit": 1e-4, "rs-fit": 1e-3}
FIT_PARITY_STEPS = 4 * FIT_CHUNK  # the first chunk runs eagerly and captures, 3 replay
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
    """The main path: full-width LBA prediction on the card, fp32 then
    bf16, eager (gcpnet_torch.predict.predict) and served
    (gcpnet_torch.predict.Predictor: a CUDA graph captured at the first
    batch and replayed for the rest), with every kernel count set to 0 just
    before and read just after (the wrappers count the eager launches and
    the capture's; phase_profile reads a replay's kernels from its trace);
    the served predictions against the eager ones; then the eager fp32
    predictions against the same weights and batch run on the CPU through
    the plain versions."""
    results = {}
    reset_counts()
    for dname, dtype in DTYPES.items():
        model = build_model(SEED, "cuda", dtype)
        predictor = Predictor(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = {}
        for mode, fn in (("eager", lambda b: predict(model, b)), ("captured", predictor)):
            times, preds = [], []
            for i, batch in enumerate(batches):
                before = launch_counts()
                t0 = time.perf_counter()
                out = fn(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                launched = tuple(a - b for a, b in zip(launch_counts(), before))[:2]
                # served: the first call runs eagerly and records the kernels
                # into its graph (both counted); a replay runs no wrapper
                want = (8, 8) if mode == "eager" else (16, 16) if i == 0 else (0, 0)
                check(launched == want, f"forward {dname} {mode}: launches (K1, K2) = {launched}, want {want}")
                check(out.shape == (GRAPHS,), f"forward {dname} {mode}: output shape {tuple(out.shape)}")
                check(bool(torch.isfinite(out).all()), f"forward {dname} {mode}: non-finite predictions")
                preds.append(out.float().cpu())
            runs[mode] = (times, preds)
        (times, preds), (cap_times, cap_preds) = runs["eager"], runs["captured"]
        call = predictor.graphs
        check((call.captures, call.replays) == (1, len(batches) - 1),
              f"forward {dname}: {call.captures} captures, {call.replays} replays")
        err = max((a - b).abs().max().item() for a, b in zip(cap_preds, preds))
        results[dname] = {
            "first_ms": times[0],
            "ms_per_batch": float(np.median(times[1:])),
            "ms_all": times,
            "captured_first_ms": cap_times[0],
            "captured_ms_per_batch": float(np.median(cap_times[1:])),
            "captured_ms_all": cap_times,
            "captured_vs_eager_max_abs": err,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "predictions_batch0": preds[0].tolist(),
        }
        check(err <= FORWARD_ATOL, f"forward {dname}: captured vs eager max abs {err:.3g} > {FORWARD_ATOL}")
        del model, predictor
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


def _lba_training(dtype: torch.dtype):
    """The full-width LBA training of the train phases: weights from SEED,
    dropout 0.1, Adam at lr 1e-4, the adaptive clip and TRAIN_SCHEDULE, and
    a dropout generator from SEED."""
    model, state = build_lba_training(SEED, "cuda", dtype, lr=TRAIN_LR, dropout=0.1, adaptive_clip=True)
    state.scheduler = build_schedule(state.optimizer, TRAIN_SCHEDULE)
    return model, state, torch.Generator(device="cuda").manual_seed(SEED)


def _train_state(model, state) -> dict:
    """Every tensor a step updates: the parameters, Adam's moments and
    count, the ring, the schedule's count and the rate, cloned."""
    opt = state.optimizer
    out = {
        "params": flat_params(model),
        "exp_avg": torch.cat([opt.state[p]["exp_avg"].reshape(-1) for p in model.parameters()]),
        "exp_avg_sq": torch.cat([opt.state[p]["exp_avg_sq"].reshape(-1) for p in model.parameters()]),
        "adam_step": opt.state[next(model.parameters())]["step"].clone(),
        "ring.buffer": state.ring.buffer.clone(), "ring.count": state.ring.count.clone(),
        "ring.head": state.ring.head.clone(), "schedule.count": state.scheduler.count.clone(),
        "lr": opt.lr.clone(),
    }
    return out


def _state_distance(a: dict, b: dict) -> dict:
    """How far two runs' states part: parameters in max abs, moments in
    norm-relative terms, losses and norms in max abs relative."""
    return {
        "params": (a["params"] - b["params"]).abs().max().item(),
        "exp_avg": norm_rel_err(a["exp_avg"], b["exp_avg"]),
        "exp_avg_sq": norm_rel_err(a["exp_avg_sq"], b["exp_avg_sq"]),
        "losses": float(np.max(np.abs(np.subtract(a["losses"], b["losses"])) / np.abs(b["losses"]))),
        "grad_norms": float(np.max(np.abs(np.subtract(a["grad_norms"], b["grad_norms"])) / np.abs(b["grad_norms"]))),
    }


def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def param_gap(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor, lr: float, steps: int) -> dict:
    """How far two runs' flat parameters part after ``steps`` updates at
    rate ``lr`` from ``start``: max abs beside its limit of 2 lr a step;
    the share of entries more than REPLAY_PARAM_ATOL_LR * lr apart; and the
    share of entries that ``want``'s run moved that far from ``start``
    (what a run that skipped its updates would part by)."""
    atol = REPLAY_PARAM_ATOL_LR * lr
    diff = (got - want).abs()
    return {
        "max_abs": diff.max().item(), "max_abs_limit": 2 * lr * steps, "atol": atol,
        "share_apart": (diff > atol).double().mean().item(),
        "moved_share": ((want - start).abs() > atol).double().mean().item(),
    }


def check_param_gap(name: str, gap: dict) -> None:
    check(gap["share_apart"] <= REPLAY_PARAM_SHARE and gap["max_abs"] <= gap["max_abs_limit"],
          f"{name}: the parameters part by {gap} (at most {REPLAY_PARAM_SHARE} of them beyond atol)")


def _train_run(batch, dtype: torch.dtype, captured: bool, want: tuple) -> dict:
    """TRAIN_STEPS training steps on one batch from _lba_training: eager
    (train_step) or captured (TrainSteps: the first call runs eagerly and
    captures, the rest replay, each replay under
    torch.cuda.set_sync_debug_mode("error")).  Each step's launches are
    read around it: ``want`` an eager step's; the captured first step
    counts them twice (its eager run and the capture's records), a replay
    runs no wrapper and counts none."""
    model, state, gen = _lba_training(dtype)
    start = flat_params(model)
    if captured:
        steps = TrainSteps(model, state, graph_regression_loss, gen)
        pinned = batch.pinned()
        run = lambda: steps([pinned])  # noqa: E731
    else:
        dev_batch = batch.to(torch.device("cuda"))
        run = lambda: train_step(model, state, dev_batch, graph_regression_loss, gen)  # noqa: E731
    name = "captured" if captured else "eager"
    torch.cuda.synchronize()
    times, losses, norms = [], [], []
    for step in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        if captured and step > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            result = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched = tuple(a - b for a, b in zip(launch_counts(), before))
        step_want = want if not captured else tuple(2 * n for n in want) if step == 0 else (0,) * len(want)
        check(launched == step_want, f"{name} step {step}: launches {KERNEL_COUNTS} = {launched}, want {step_want}")
        losses.append(result.loss.item())
        norms.append(result.grad_norm.item())
        check(bool(result.ok.all()) and np.isfinite(losses[-1]) and np.isfinite(norms[-1]),
              f"{name} step {step}: loss {losses[-1]}, grad norm {norms[-1]}")
    if captured:
        check((steps.call.captures, steps.call.replays) == (1, TRAIN_STEPS - 1),
              f"captured: {steps.call.captures} captures, {steps.call.replays} replays")
    ms = float(np.median(times[1:]))
    return {
        "ms_per_step": ms, "graphs_per_s": GRAPHS / ms * 1e3, "first_ms": times[0], "ms_all": times,
        "losses": losses, "grad_norms": norms, "state": _train_state(model, state), "start": start,
        "objects": (model, state, gen, steps if captured else None),
    }


def phase_train(batch, dtype: torch.dtype = torch.bfloat16) -> dict:
    """A training path: the full-width LBA training step (bf16 compute over
    float32 masters, or float32 throughout; _lba_training) for TRAIN_STEPS
    steps on one batch, as the JAX benchmark reuses its batch: twice eagerly
    (train_step), then captured as the CLI runs it (TrainSteps, one replay a
    step; every kernel count set to 0 just before and read just after).
    The captured run's parameters against the first eager run's
    (param_gap), its moments and per-step losses within what the two eager
    runs part by (REPLAY_TOL); a batch with a NaN label replayed through
    the graph must leave the state as it was, bit for bit; then one warm
    eager step and one replay under torch.profiler, which reads the
    replay's kernels from the trace."""
    name = "train" if dtype == torch.bfloat16 else "train-fp32"
    want = (8, 8, 8, 0) if dtype == torch.bfloat16 else (8, 8, 0, 8)
    eager = [_train_run(batch, dtype, False, want) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    captured = _train_run(batch, dtype, True, want)
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    peak = torch.cuda.max_memory_allocated() / 1e9

    def summary(run):
        keep = ("ms_per_step", "graphs_per_s", "first_ms", "ms_all", "losses", "grad_norms")
        return {k: run[k] for k in keep}

    spread = _state_distance({**eager[1]["state"], **summary(eager[1])}, {**eager[0]["state"], **summary(eager[0])})
    apart = _state_distance({**captured["state"], **summary(captured)}, {**eager[0]["state"], **summary(eager[0])})
    bound = {k: max(REPLAY_TOL[k], REPLAY_SPREAD_FACTOR * spread[k]) for k in REPLAY_TOL}
    gap = {
        run: param_gap(other["state"]["params"], eager[0]["state"]["params"], eager[0]["start"], TRAIN_LR, TRAIN_STEPS)
        for run, other in (("eager_again", eager[1]), ("captured", captured))
    }
    model, state, gen, steps = captured["objects"]
    results = {
        "launches": launches, **summary(eager[0]), "eager_again": summary(eager[1]),
        "captured": summary(captured), "peak_mem_gb_captured": peak, "steps": TRAIN_STEPS,
        "eager_spread": spread, "captured_vs_eager": apart, "bound": bound, "param_gap": gap,
        "replays": steps.call.replays,
    }

    # a NaN label through the same graph: nothing moves
    label = batch.extras["label"]
    bad = dataclasses.replace(batch, extras={**batch.extras, "label": np.full_like(label, np.nan)})
    bad_pinned = bad.pinned()
    before = _train_state(model, state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = steps([bad_pinned])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = _train_state(model, state)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    results["nan_replay"] = {"ok": bool(result.ok.all()), "changed": changed, "replays": steps.call.replays}

    pinned = batch.pinned()
    dev_batch = batch.to(torch.device("cuda"))
    emodel, estate, egen, _ = eager[0]["objects"]
    kernels = {"K1": 8, "K2": 8, "K3": 8}
    results["profile"] = profile_kernels(
        lambda: train_step(emodel, estate, dev_batch, graph_regression_loss, egen), kernels
    )
    results["profile_captured"] = profile_kernels(lambda: steps([pinned]), kernels)
    print(f"phase {name}: " + json.dumps(results), flush=True)
    for key, limit in bound.items():
        check(apart[key] <= limit, f"{name}: captured vs eager {key} {apart[key]:.3g} > {limit:.3g}")
    check_param_gap(f"{name} captured vs eager", gap["captured"])
    check(not results["nan_replay"]["ok"] and not changed and results["nan_replay"]["replays"] == TRAIN_STEPS,
          f"{name}: the NaN replay {results['nan_replay']}")
    for prof in (results["profile"], results["profile_captured"]):
        check(prof["kernels"] == kernels, f"{name}: profiled kernels {prof['kernels']}, want 8 of each")
    print(f"phase {name}: ok")
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
    overlap), idle share, time by kernel, the launches of K1, K2 and K3
    read from the trace (those a graph's replay runs included), and the
    host's calls into the CUDA runtime and driver."""
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
    # the host's calls into the CUDA runtime and driver (cudaLaunchKernel,
    # cudaGraphLaunch, cudaMemcpyAsync, ...): what the host pays per call
    api = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(("cuda", "cu")):
            api[e.name] = api.get(e.name, 0) + 1
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
        "kernels": {label: sum(1 for e in kernels if key in e.name) for label, key in KERNEL_NAMES.items()},
        "launches": {label: sum(1 for e in kernels if key in e.name) for label, key in TRACE_NAMES.items()},
        "cuda_api_calls": sum(api.values()),
        "cuda_api_by_name": api,
        "share": {
            label: sum(v for k, v in by_name.items() if any(key in k for key in keys)) / busy_us
            if kernels else "not measured"
            for label, keys in labels
        },
        "top_ms": [[k, v / 1e3] for k, v in top],
    }


def profile_kernels(fn, want: dict, tries: int = 3) -> dict:
    """device_profile of ``fn``, taken again (up to ``tries`` times) while
    the K1/K2/K3 counts read from the trace differ from ``want``: the
    profiler can lose a device event now and then (see device_ms).  The
    last profile, with the number of tries it took; a kernel missing from
    every try fails the caller's check."""
    for i in range(tries):
        prof = device_profile(fn)
        if prof["kernels"] == want:
            break
    prof["tries"] = i + 1
    return prof


def phase_profile(batches) -> dict:
    """Where the time goes in prediction: one warm bf16 full-width forward,
    eager and replayed, each under torch.profiler (the training steps are
    profiled in their phases)."""
    model = build_model(SEED, "cuda", torch.bfloat16)
    predictor = Predictor(model)
    predict(model, batches[0])
    predictor(batches[0])
    kernels = {"K1": 8, "K2": 8, "K3": 0}
    result = {
        "forward": profile_kernels(lambda: predict(model, batches[1]), kernels),
        "forward_captured": profile_kernels(lambda: predictor(batches[1]), kernels),
    }
    print("phase profile: ok " + json.dumps(result))
    for key, prof in result.items():
        check(prof["kernels"] == kernels, f"profile {key}: kernels {prof['kernels']}")
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
    the previous one (or since it was made), and ``model``'s flat
    parameters as the first line is logged (after the first epoch)."""

    def __init__(self, model=None):
        self.last = time.perf_counter()
        self.lines = []
        self.model, self.first_params = model, None

    def log_metrics(self, metrics, step=None) -> None:
        now = time.perf_counter()
        self.lines.append({**metrics, "step": step, "seconds": now - self.last})
        if self.model is not None and self.first_params is None:
            self.first_params = flat_params(self.model)
        self.last = now


def _eager_epoch(build, dm, loss_fn, graphs_per_batch: int) -> dict:
    """The first epoch of a fit run eagerly, step by step, on the Trainer
    ``build(max_epochs=1)`` makes (so the fit's weights, batches and dropout
    masks): train_step over the training batches, then eval_step over the
    validation batches, each batch copied to the card in a prefetch thread.
    Its seconds, train graphs/s, losses, and the parameters before and
    after it."""
    trainer = build(max_epochs=1)
    model, state, gen, dev = trainer.model, trainer.state, trainer.generator, trainer.device

    def staged(batches):
        return prefetched((b.to(dev, non_blocking=True) for b in batches), depth=2)

    start = flat_params(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(model, state, b, loss_fn, gen).loss for b in staged(dm.train_batches(seed=0))]
    train_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
    train_seconds = time.perf_counter() - t0
    val = torch.stack([eval_step(model, b, loss_fn)[0] for b in staged(dm.val_batches())]).cpu().numpy()
    return {
        "seconds": time.perf_counter() - t0, "train/loss": train_loss,
        "val/loss": float(np.mean(val, dtype=np.float64)), "steps": len(losses),
        "train_graphs_per_s": len(losses) * graphs_per_batch / train_seconds,
        "start": start, "params": flat_params(model),
    }


def fit_parity(build, dm, loss_fn) -> dict:
    """The first FIT_PARITY_STEPS training steps of a fit and its
    validation batches, captured (a Trainer from ``build`` with
    scan_chunk_size FIT_CHUNK: a chunk's first call runs eagerly and
    captures, the rest replay) and run eagerly step by step (train_step,
    eval_step) from the same weights and generator seed, both under
    torch.use_deterministic_algorithms (main sets CUBLAS_WORKSPACE_CONFIG,
    which it needs): whether the parameters, the generators' states, the
    training losses (averaged as the Trainer does) and the validation loss
    (evaluated twice, the second time all replays) are equal bit for bit,
    and the parameters' distance besides."""
    torch.use_deterministic_algorithms(True)
    try:
        eager = build(max_epochs=1)
        dev = eager.device
        start = flat_params(eager.model)
        batches = itertools.islice(dm.train_batches(seed=0), FIT_PARITY_STEPS)
        losses = [train_step(eager.model, eager.state, b.to(dev), loss_fn, eager.generator).loss for b in batches]
        chunks = [torch.stack(losses[i : i + FIT_CHUNK]).mean() for i in range(0, len(losses), FIT_CHUNK)]
        eager_train = float(np.average(torch.stack(chunks).cpu().numpy(), weights=[FIT_CHUNK] * len(chunks)))
        val = torch.stack([eval_step(eager.model, b.to(dev), loss_fn)[0] for b in dm.val_batches()])
        eager_val = float(np.mean(val.cpu().numpy(), dtype=np.float64))
        captured = build(max_epochs=1, scan_chunk_size=FIT_CHUNK, max_steps_per_epoch=FIT_PARITY_STEPS)
        train = captured.train_epoch(dm.train_batches(seed=0), 0)["train/loss"]
        val_loss = [captured.eval_epoch(dm.val_batches())["val/loss"] for _ in range(2)]
        calls = captured.train_graphs.call, captured.eval_graphs.call
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    got, want = flat_params(captured.model), flat_params(eager.model)
    return {
        "steps": len(losses), "train_replays": calls[0].replays, "eval_replays": calls[1].replays,
        "params_equal": torch.equal(got, want),
        "generator_equal": torch.equal(captured.generator.get_state(), eager.generator.get_state()),
        "train_loss": [train, eager_train], "val_loss": [*val_loss, eager_val],
        "param_gap": param_gap(got, want, start, FIT_LR, len(losses)),
    }


def _fit_checks(name: str, results: dict, layers: int, first_epoch: dict) -> None:
    """What every captured fit must show: the wrappers counted the kernels
    of each graph's first call only (its eager run and the capture's
    records: twice a layer's K1, K2 and fp32 K3 launches for each training
    batch captured, K1 and K2 for each evaluation batch), so every other
    chunk ran as a replay; the traced replays of a train chunk and an eval
    chunk run K1, K2 and the fp32 K3 once a layer a step (K3 not in
    evaluation), as the profiled eager step does; the parity run's
    captured steps equal its eager ones bit for bit (fit_parity), with
    replays among them; the first epoch's losses are the eager epoch's
    within FIT_EAGER_RTOL[name]."""
    g = results["graphs"]
    train, evals = 2 * layers * g["train_captured_batches"], 2 * layers * g["eval_captured_batches"]
    want = {"K1": train + evals, "K2": train + evals, "K3_bf16": 0, "K3_fp32": train}
    check(results["launches"] == want, f"{name}: launches {results['launches']}, want {want} (graphs {g})")
    chunk = layers * FIT_CHUNK
    traced = {
        "profile": {"K1": layers, "K2": layers, "K3_bf16": 0, "K3_fp32": layers},
        "profile_captured": {"K1": chunk, "K2": chunk, "K3_bf16": 0, "K3_fp32": chunk},
        "profile_eval_captured": {"K1": chunk, "K2": chunk, "K3_bf16": 0, "K3_fp32": 0},
    }
    for key, want in traced.items():
        check(results[key]["launches"] == want, f"{name}: {key} launches {results[key]['launches']}, want {want}")
    parity = results["parity"]
    check(parity["params_equal"] and parity["generator_equal"] and parity["train_loss"][0] == parity["train_loss"][1]
          and len(set(parity["val_loss"])) == 1 and parity["train_replays"] > 0
          and parity["eval_replays"] > 0 and parity["steps"] == FIT_PARITY_STEPS,
          f"{name}: deterministic parity, captured vs eager: {parity}")
    eager = results["eager_epoch"]
    for k in ("train/loss", "val/loss"):
        rel = abs(first_epoch[k] - eager[k]) / abs(eager[k])
        check(rel <= FIT_EAGER_RTOL[name], f"{name}: epoch 0 {k} {first_epoch[k]} captured, {eager[k]} eager")


def _fit_record(trainer, clock: EpochClock, eager: dict, lr: float) -> dict:
    """A captured fit's kernel counts (read by the caller), its graphs, and
    its first epoch's parameters against the eager epoch's."""
    train, evals = trainer.train_graphs.call, trainer.eval_graphs.call
    eager = dict(eager)
    start, params = eager.pop("start"), eager.pop("params")
    return {
        "eager_epoch": eager,
        "graphs": {
            "train_captures": train.captures, "train_captured_batches": train.captured_batches,
            "train_replays": train.replays, "eval_captures": evals.captures,
            "eval_captured_batches": evals.captured_batches, "eval_replays": evals.replays,
        },
        "param_gap": param_gap(clock.first_params, params, start, lr, eager["steps"]),
    }


def _profile_steps(trainer, dm, loss_fn, layers: int) -> dict:
    """One warm eager training step, and one replay each of the trainer's
    captured train chunk and eval chunk (FIT_CHUNK batches of the fit's
    shapes), each under torch.profiler, which reads the kernels each ran
    from its trace (profile_kernels)."""
    train = [b.pinned() for b in itertools.islice(dm.train_batches(seed=0), FIT_CHUNK)]
    val = [b.pinned() for b in itertools.islice(dm.val_batches(), FIT_CHUNK)]
    dev_batch = next(dm.train_batches(seed=0)).to(torch.device("cuda"))
    eager = lambda: train_step(trainer.model, trainer.state, dev_batch, loss_fn, trainer.generator)  # noqa: E731
    replay = lambda: trainer.train_graphs(train)  # noqa: E731
    replay_eval = lambda: trainer.eval_graphs(val)  # noqa: E731
    for fn in (eager, replay, replay_eval):  # warm, and captured where the graphs were dropped
        fn()
    chunk = layers * FIT_CHUNK
    return {
        "chunk_steps": FIT_CHUNK,
        "profile": profile_kernels(eager, {"K1": layers, "K2": layers, "K3": layers}),
        "profile_captured": profile_kernels(replay, {"K1": chunk, "K2": chunk, "K3": chunk}),
        "profile_eval_captured": profile_kernels(replay_eval, {"K1": chunk, "K2": chunk, "K3": 0}),
    }


def phase_nms_fit(dm, ckpt_dir: str) -> dict:
    """The NMS path: the full-width NMS model with the experiment's defaults
    (fp32, dropout 0.1, Adam at 1e-4) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK (each full chunk of training or validation
    batches one replay of a CUDA graph) for NMS_EPOCHS epochs with
    checkpoints; a new Trainer resumes from the last checkpoint to epoch
    NMS_RESUME_EPOCHS and tests the best checkpoint; beside it the first
    epoch of the same fit run eagerly (_eager_epoch); then one warm eager
    step and one replay of a train and an eval chunk under torch.profiler
    (_profile_steps).  Every kernel count is set to 0 just before the fit
    and read just after it (_fit_checks)."""
    layers = nms_configs()[0].num_encoder_layers
    build = lambda seed=SEED, **kw: build_nms_trainer(seed, "cuda", lr=FIT_LR, **kw)  # noqa: E731
    eager = _eager_epoch(build, dm, nms_loss, NMS_BATCH)
    parity = fit_parity(build, dm, nms_loss)
    clock = EpochClock()
    trainer = build(max_epochs=NMS_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    clock.model = trainer.model
    gc.collect()  # the eager and parity runs' trainers: their memory is not the fit's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock.last = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    results = {"launches": dict(zip(KERNEL_COUNTS, launch_counts()))}
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    steps = trainer.state.step
    results["steps"] = steps
    results.update(_fit_record(trainer, clock, eager, FIT_LR), parity=parity)

    resumed_clock = EpochClock()
    resumed = build(
        seed=SEED + 1, max_epochs=NMS_RESUME_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[resumed_clock],
        scan_chunk_size=FIT_CHUNK,
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
    results.update(_profile_steps(resumed, dm, nms_loss, layers))
    print("phase nms-fit: " + json.dumps(results), flush=True)

    wanted = ("train/loss", "val/loss", "val/RMSE", "val/CosineSimilarity")
    for line in epochs:
        check(all(k in line and math.isfinite(line[k]) for k in wanted), f"nms-fit: epoch line {line}")
    check(all(k in test and math.isfinite(test[k]) for k in ("test/loss", "test/RMSE", "test/CosineSimilarity")),
          f"nms-fit: test metrics {test}")
    check([line["epoch"] for line in epochs] == list(range(NMS_RESUME_EPOCHS)), "nms-fit: epochs run")
    _fit_checks("nms-fit", results, layers, epochs[0])
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
    (fp32, dropout 0.1, Adam at 1e-4, seed 42) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK for RS_EPOCHS epochs with checkpoints, then
    the best checkpoint's test; beside it the first epoch of the same fit
    run eagerly (_eager_epoch).  Every kernel count is set to 0 just before
    the fit and read just after; rs-profile checks them (_fit_checks)."""
    build = lambda **kw: build_rs_trainer(42, "cuda", lr=FIT_LR, **kw)  # noqa: E731
    graphs = dm.bucket().num_graphs
    eager = _eager_epoch(build, dm, rs_loss, graphs)
    parity = fit_parity(build, dm, rs_loss)
    clock = EpochClock()
    trainer = build(max_epochs=RS_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    clock.model = trainer.model
    gc.collect()  # the eager and parity runs' trainers: their memory is not the fit's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock.last = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    steps = trainer.state.step
    results = {
        "launches": launches,
        **_fit_record(trainer, clock, eager, FIT_LR),
        "parity": parity,
        "steps": steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "epochs": [
            {k: line[k] for k in ("epoch", "seconds", "train/loss", "val/loss", "val/Accuracy", "val/F1")}
            | {"train_graphs_per_s": line["train/steps_per_sec"] * graphs}
            for line in clock.lines[:RS_EPOCHS]
        ],
    }
    results["best_step"] = trainer.restore_best()
    results["test"] = test = trainer.test(dm)
    print("phase rs-fit: " + json.dumps(results), flush=True)
    wanted = ("train/loss", "val/loss", "val/Accuracy", "val/F1")
    check([line["epoch"] for line in results["epochs"]] == list(range(RS_EPOCHS)), "rs-fit: epochs run")
    for line in clock.lines[:RS_EPOCHS]:
        check(all(k in line and math.isfinite(line[k]) for k in wanted), f"rs-fit: epoch line {line}")
    check(all(k in test and math.isfinite(test[k]) for k in ("test/loss", "test/Accuracy", "test/F1")),
          f"rs-fit: test metrics {test}")
    check(results["steps"] == RS_EPOCHS * len(dm.sampler("train")), f"rs-fit: {results['steps']} steps")
    print("phase rs-fit: ok")
    return trainer, results


def phase_rs_profile(trainer, dm, fit: dict) -> dict:
    """One warm eager RS training step of the fitted model and one replay
    of its captured train and eval chunks under torch.profiler; then the
    rs-fit's checks that read them (_fit_checks)."""
    layers = rs_configs()[0].num_encoder_layers
    results = _profile_steps(trainer, dm, rs_loss, layers)
    print("phase rs-profile: " + json.dumps(results), flush=True)
    _fit_checks("rs-fit", {**fit, **results}, layers, fit["epochs"][0])
    print("phase rs-profile: ok")
    return results


def kernel_line(report) -> dict:
    """The contract line: K1 and K2 at bf16 (the production precision) on
    the tile-aligned layout the main path uses, fp32 and K1's CSR layout
    beside them; ``launches`` the wrappers' count over the captured bf16
    training run (its first step's eager launches and the capture's
    records), ``replay_launches_traced`` the kernels one replay of that
    graph ran, read from its trace, beside the run's ``replays``; the
    prediction run's count beside them; K3 as its two instantiations, bf16
    (the bf16 training run) and fp32 (split TF32, the fp32 training run).
    Under "nms", each kernel at the NMS step's shape and its launches a
    step of the NMS fit, read from the trace of one replay of a train chunk
    (FIT_CHUNK steps) by instantiation (the fit is fp32, so the bf16 K3's
    count is 0); under "rs" the same at the RS step's shape and the RS
    fit."""
    k1, k2, k3 = report["K1"], report["K2"], report["K3"]
    forward, train, train_fp32 = report["forward"], report["train"], report["train_fp32"]
    nk, rk = report["nms_kernels"], report["rs_kernels"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    replaces_k3 = "gcpnet_tpu/ops/pallas_fused.py:175"

    def per_step(profiles):
        traced = profiles["profile_captured"]["launches"]
        return {k: n / profiles["chunk_steps"] for k, n in traced.items()}

    nms_steps, rs_steps = per_step(report["nms_fit"]), per_step(report["rs_profile"])

    def row(name, source, replaces, run, count, main, dtype, **extra):
        return {
            "name": name, "route": "cuda", "source": f"gcpnet_torch/csrc/{source}", "replaces": replaces,
            "launches": run["launches"][count], **{k: main[k] for k in keys}, "dtype": dtype,
            "replay_launches_traced": run["profile_captured"]["launches"][count], "replays": run["replays"],
            **extra,
        }

    def nms(results, launches_per_step, **by_dtype):
        return {
            "shape": next(iter(results.values()))["shape"], "launches_per_step": launches_per_step,
            **{d: {k: results[key][k] for k in (*keys, "share_of_bound")} for d, key in by_dtype.items()},
        }

    return {
        "kernels": [
            row("segment_sum_sorted", "segment_sorted.cu", "gcpnet_tpu/ops/pallas_segment.py:160", train, "K1",
                k1["tile128_bf16"], "bf16", forward_launches=forward["launches"]["K1"],
                **{f"fp32_{k}": k1["tile128_fp32"][k] for k in keys},
                **{f"csr_{k}": k1["tile1_bf16"][k] for k in keys},
                **{f"csr_fp32_{k}": k1["tile1_fp32"][k] for k in keys},
                nms=nms(nk["K1"], nms_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"),
                rs=nms(rk["K1"], rs_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16")),
            row("edge_map", "edge_map_tc.cu", "gcpnet_tpu/ops/pallas_fused.py:117", train, "K2",
                k2["bf16"], "bf16", forward_launches=forward["launches"]["K2"],
                bound_rate=k2["bf16"]["bound_rate"],
                **{f"fp32_{k}": k2["fp32"][k] for k in (*keys, "bound_rate")},
                nms=nms(nk["K2"], nms_steps["K2"], fp32="fp32", bf16="bf16"),
                rs=nms(rk["K2"], rs_steps["K2"], fp32="fp32", bf16="bf16")),
            row("edge_map_backward_tc", "edge_map_bwd_tc.cu", replaces_k3, train, "K3_bf16",
                k3["bf16"], "bf16", forward_launches=forward["launches"]["K3_bf16"],
                bound_rate=k3["bf16"]["bound_rate"], nms=nms(nk["K3"], nms_steps["K3_bf16"], bf16="bf16"),
                rs=nms(rk["K3"], rs_steps["K3_bf16"], bf16="bf16")),
            row("edge_map_backward_tc_fp32", "edge_map_bwd_tc.cu", replaces_k3, train_fp32, "K3_fp32",
                k3["fp32"], "fp32", bound_rate=k3["fp32"]["bound_rate"],
                bound_ms_cuda_cores=k3["fp32"]["bound_ms_cuda_cores"],
                nms=nms(nk["K3"], nms_steps["K3_fp32"], fp32="fp32"),
                rs=nms(rk["K3"], rs_steps["K3_fp32"], fp32="fp32")),
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
    # cuBLAS reads it when it makes its first handle; deterministic
    # algorithms (fit_parity) refuse cuBLAS without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        # every K1 timing (device_ms) before the first CUDA graph
        dm, report["nms_data"] = phase_nms_data(data_root)
        report["nms_kernels"] = phase_nms_kernels(dm)
        rs_dm, report["rs_data"] = phase_rs_data()
        report["rs_kernels"] = phase_rs_kernels(rs_dm)
        report["forward"] = phase_forward(batches)
        report["train"] = phase_train(batches[0])
        report["train_fp32"] = phase_train(batches[0], torch.float32)
        report["train_check"] = phase_train_check()
        report["bf16_check"] = phase_bf16_check()
        report["profile"] = phase_profile(batches)
        report["nms_check"] = phase_nms_check(data_root)
        report["nms_fit"] = phase_nms_fit(dm, ckpt_dir)
        del dm
        report["rs_check"] = phase_rs_check(rs_dm)
        rs_trainer, report["rs_fit"] = phase_rs_fit(rs_dm, rs_ckpt_dir)
        report["rs_profile"] = phase_rs_profile(rs_trainer, rs_dm, report["rs_fit"])
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
