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
  5. K3 (the fused stack's backward) against its plain version (autograd
     through K2's) at the main path's shape, leaf by leaf (d message, each
     weight matrix and bias): bf16 on the tensor-core kernel, fp32 on the
     CUDA-core one;
  6. forward: the LBA forward at the benchmark's full width (16 graphs x 448
     atoms, 8 interaction layers x 8 message layers) through
     gcpnet_torch.predict, fp32 and bf16: launch counts, finiteness,
     latency, peak memory; then the fp32 predictions against the same
     weights and batch run on the CPU through the plain versions;
  7. train: the full-width LBA training step through gcpnet_torch.train
     (bf16 over fp32 masters, dropout 0.1, Adam at lr 1e-4), 6 steps on one
     batch: launches per step, finiteness, ms per step, graphs/s, peak
     memory;
  8. train-check: one fp32 training step on the card against the same step
     on the CPU (2 interaction layers, 2 graphs, no dropout): loss, gradient
     norm, gradients and updated parameters; its launches of the fp32 K3;
  9. bf16-check: the bf16 training step's gradients against the fp32
     step's on the card (the train-check's size), through the kernels and
     through the plain stack in bf16;
 10. profile: one warm bf16 forward and one warm bf16 training step under
     torch.profiler (device busy and idle share, time by kernel).
Then one JSON line with every kernel's numbers, the nvidia-smi line, and the
final status line.  Any failed phase exits non-zero; without a CUDA device
the script exits non-zero before printing any result.  Full measurements go
to <out-dir>/chip_smoke.json (``--out-dir``, default logs/chip_smoke).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gcpnet_torch.nn import message_passing
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops import build as kernel_build
from gcpnet_torch.ops.edge_map import (
    edge_map,
    edge_map_backward,
    edge_map_backward_plain,
    edge_map_plain,
)
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch.predict import DTYPES, build_model, lba_configs, predict, synthetic_batches
from gcpnet_torch.train.cli import build_lba_training
from gcpnet_torch.train.step import train_step

SEED = 0
GRAPHS, NODES, EDGES_PER_NODE = 16, 448, 28
FORWARD_BATCHES = 4  # the first is the cold one; latency is over the rest
TRAIN_STEPS = 6  # the first is the cold one; ms per step is over the rest
TRAIN_CHECK_GRAPHS, TRAIN_CHECK_LAYERS = 2, 2
# The published H100 SXM peaks (NVIDIA data sheet, dense): device memory
# rate, and the operation rate for each input type (bf16 on the tensor
# cores, fp32 on the CUDA cores), and TF32 on the tensor cores, the route
# of K2's float32 (split TF32: three products for each).
PEAK_BYTES_PER_S = 3.35e12
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
# K3 fp32: float32 throughout.
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
    """Device time of ``fn`` per call: the summed times of the CUDA kernels
    and copies of ``calls`` calls under torch.profiler, over ``calls``.  For
    calls as short as the host's launch of them, where CUDA events around a
    loop of calls time the host.  The profiler can lose device events; a
    window in which some kernel was not seen a multiple of ``calls`` times
    is measured again."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts = Counter(e.name for e in events)
        if counts and all(c % calls == 0 for c in counts.values()):
            return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3
    raise PhaseError(f"device_ms: the profiler lost device events in {tries} windows (last: {dict(counts)})")


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


def phase_k1(batches_by_tile) -> dict:
    """K1 at the main path's shape: [E, 148] edge rows into N nodes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d_out = 100 + 3 * 16
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
            check(rel <= TOL[("K1", dname)], f"K1 tile={tile} {dname}: rel err {rel:.3g}")
            es = data.element_size()
            nbytes = rows * d_out * es + (n + 1) * 4 + n * d_out * es
            b_ms, b_by = bound_ms(nbytes, rows * d_out, dtype)
            kernel = lambda: segment_sum_sorted(data, splits, n)
            library = lambda: torch.segment_reduce(data[:end], "sum", lengths=lengths, unsafe=True)
            # device time (a call is as short as its launch), in turns:
            # library, kernel, kernel, library
            lib_a, k_a, k_b, lib_b = (device_ms(fn) for fn in (library, kernel, kernel, library))
            results[f"tile{tile}_{dname}"] = {
                "max_abs_err": err,
                "ms": (k_a + k_b) / 2,
                "plain_ms": device_ms(lambda: segment_sum_sorted_plain(data, splits, n), calls=20),
                "library_ms": (lib_a + lib_b) / 2,
                "ms_turns": [lib_a, k_a, k_b, lib_b],
                "bound_ms": b_ms,
                "bound_by": b_by,
                "shape": [batch.num_edges, d_out, n],
            }
    print("phase K1: ok " + json.dumps(results))
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


def stack_inputs(batch, stack, dtype, gen):
    """Random messages (an eighth of the rows with all-zero vectors, where
    the norm's eps decides) and masked frames at the main path's shape."""
    e = batch.num_edges
    mask = torch.as_tensor(batch.edge_pad_mask).cuda()
    message = torch.randn((e, stack.in_dim), generator=gen, device="cuda")
    message[: e // 8, stack.layers[0].dims[0] :] = 0.0
    frames = torch.rand((e, 9), generator=gen, device="cuda") * 2 - 1
    return message.to(dtype), (frames * mask[:, None]).to(dtype)


def phase_k2(batch) -> dict:
    """K2 at the main path's shape: [E, 340] messages + [E, 9] frames ->
    [E, 148], with the benchmark's stack (8 GCP2 layers, hidden 100/16)."""
    mp = bench_message_passing()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    e = batch.num_edges
    results = {}
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
            message, frames = stack_inputs(batch, stack, dtype, gen)
            got = edge_map(message, frames, stack)
            ref = edge_map_plain(message, frames, stack)
        check(bool(torch.isfinite(got).all()), f"K2 {dname}: non-finite output")
        err, rel = rel_err(got, ref)
        check(rel <= TOL[("K2", dname)], f"K2 {dname}: rel err {rel:.3g}")
        es = message.element_size()
        nbytes = e * (stack.in_dim + 9 + stack.out_dim) * es + stack.weights.numel() * 4
        flops = e * stack_flops(stack)
        if dtype == torch.float32:
            # the kernel's route: split TF32, three tensor-core products for each
            b_ms, b_by = bound_ms(nbytes, 3 * flops, dtype, PEAK_TF32_OPS_PER_S)
            bound_rate = "3 x flops at the TF32 tensor-core peak"
        else:
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            bound_rate = "flops at the bf16 tensor-core peak"
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
    print("phase K2: ok " + json.dumps(results))
    return results


def phase_k3(batch) -> dict:
    """K3 at the main path's shape: the backward of K2's stack for a random
    cotangent [E, 148] -> d message [E, 340] and d weights (float32)."""
    mp = bench_message_passing()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    e = batch.num_edges
    results = {}
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
        message, frames = stack_inputs(batch, stack, dtype, gen)
        grad_out = torch.randn((e, stack.out_dim), generator=gen, device="cuda").to(dtype)
        d_msg, d_w = edge_map_backward(message, frames, stack, grad_out)
        ref_msg, ref_w = edge_map_backward_plain(message, frames, stack, grad_out)
        torch.cuda.synchronize()
        res = {"d_message": {}, "d_weights": {}}
        for key, got, ref in (("d_message", d_msg, ref_msg), ("d_weights", d_w, ref_w)):
            err, rel = rel_err(got, ref)
            res[key] = {"max_abs_err": err, "rel_err": rel, "norm_rel_err": norm_rel_err(got, ref),
                        "finite": bool(torch.isfinite(got).all())}
        leaf_errs = k3_leaf_errs(d_msg, d_w, ref_msg, ref_w, stack)
        res["leaves"] = {leaf: {"vs_plain": err} for leaf, err in leaf_errs.items()}
        if dtype == torch.bfloat16:
            up_msg, up_w = edge_map_backward_plain(
                message.float(), frames.float(), stack, grad_out.float()
            )
            for leaf, err in k3_leaf_errs(d_msg, d_w, up_msg, up_w, stack).items():
                res["leaves"][leaf]["vs_upcast"] = err
            for leaf, err in k3_leaf_errs(ref_msg, ref_w, up_msg, up_w, stack).items():
                res["leaves"][leaf]["plain_vs_upcast"] = err
            del up_msg, up_w
        del ref_msg, ref_w
        print(f"phase K3 {dname}: " + json.dumps(res), flush=True)
        es = message.element_size()
        nbytes = e * (2 * stack.in_dim + 9 + stack.out_dim) * es + 2 * stack.weights.numel() * 4
        flops = 3 * e * stack_flops(stack)
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        results[dname] = {
            **res,
            "max_abs_err": max(res["d_message"]["max_abs_err"], res["d_weights"]["max_abs_err"]),
            "ms": cuda_ms(lambda: edge_map_backward(message, frames, stack, grad_out), iters=5, warmup=1),
            "plain_ms": cuda_ms(
                lambda: edge_map_backward_plain(message, frames, stack, grad_out), iters=3, warmup=1
            ),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "shape": [e, stack.in_dim, stack.out_dim, stack.weights.numel()],
        }
    print("phase K3: " + json.dumps({d: {k: v for k, v in r.items() if k not in ("d_message", "d_weights", "leaves")}
                                     for d, r in results.items()}), flush=True)
    for dname, res in results.items():
        for key in ("d_message", "d_weights"):
            check(res[key]["finite"], f"K3 {dname}: non-finite {key}")
        for leaf, r in res["leaves"].items():
            check(r["vs_plain"] <= TOL[("K3", dname)],
                  f"K3 {dname} {leaf}: norm rel err {r['vs_plain']:.3g} vs plain {dname}")
            if "vs_upcast" in r:
                check(r["vs_upcast"] <= K3_UPCAST_TOL,
                      f"K3 {dname} {leaf}: norm rel err {r['vs_upcast']:.3g} vs float32 plain")
    print("phase K3: ok")
    return results


def phase_forward(batches) -> dict:
    """The main path: full-width LBA prediction through gcpnet_torch.predict
    on the card, fp32 then bf16, with every kernel count set to 0 just
    before and read just after."""
    results = {}
    segment_sum_sorted.launches = 0
    edge_map.launches = 0
    edge_map_backward.launches = 0
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
    results["launches"] = {
        "K1": segment_sum_sorted.launches, "K2": edge_map.launches, "K3": edge_map_backward.launches
    }
    check(edge_map_backward.launches == 0, "forward: the backward kernel ran during prediction")
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


def launch_counts():
    return (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)


def phase_train(batch) -> dict:
    """The training path: the full-width LBA training step through
    gcpnet_torch.train (bf16 compute over float32 masters, dropout 0.1,
    Adam at lr 1e-4) for TRAIN_STEPS steps on one batch, as the JAX
    benchmark reuses its batch, with every kernel count set to 0 just before
    and read just after."""
    model, state = build_lba_training(SEED, "cuda", torch.bfloat16, lr=1e-4, dropout=0.1)
    dev_batch = batch.to(torch.device("cuda"))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segment_sum_sorted.launches = edge_map.launches = edge_map_backward.launches = 0
    edge_map_backward.tc_launches = 0
    times, losses, norms = [], [], []
    for step in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        result = train_step(model, state, dev_batch, generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched = tuple(a - b for a, b in zip(launch_counts(), before))
        check(launched == (8, 8, 8), f"train step {step}: launches (K1, K2, K3) = {launched}, want (8, 8, 8)")
        losses.append(result.loss.item())
        norms.append(result.grad_norm.item())
        check(result.ok and np.isfinite(losses[-1]) and np.isfinite(norms[-1]),
              f"train step {step}: loss {losses[-1]}, grad norm {norms[-1]}")
    check(edge_map_backward.tc_launches == edge_map_backward.launches,
          "train: the bf16 step's backward did not run on the tensor-core K3")
    ms = float(np.median(times[1:]))
    results = {
        "launches": dict(zip(("K1", "K2", "K3"), launch_counts())),
        "ms_per_step": ms,
        "graphs_per_s": GRAPHS / ms * 1e3,
        "first_ms": times[0],
        "ms_all": times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses,
        "grad_norms": norms,
        "steps": TRAIN_STEPS,
    }
    print("phase train: ok " + json.dumps(results))
    return results


def phase_train_check() -> dict:
    """One float32 training step on the card against the same step on the
    CPU (plain versions): same weights, same batch, no dropout; full width,
    TRAIN_CHECK_LAYERS interaction layers of 8-layer stacks,
    TRAIN_CHECK_GRAPHS graphs of 448 atoms."""
    batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0]
    out = {}
    for dev in ("cuda", "cpu"):
        model, state = build_lba_training(
            SEED, dev, torch.float32, lr=1e-4, dropout=0.0, num_encoder_layers=TRAIN_CHECK_LAYERS
        )
        edge_map_backward.launches = edge_map_backward.tc_launches = 0
        t0 = time.perf_counter()
        result = train_step(model, state, batch.to(torch.device(dev)), deterministic=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            fp32_k3 = edge_map_backward.launches - edge_map_backward.tc_launches
        out[dev] = {
            "seconds": time.perf_counter() - t0,
            "loss": result.loss.item(),
            "grad_norm": result.grad_norm.item(),
            "grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()]).cpu(),
            "params": torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu(),
        }
    card, cpu = out["cuda"], out["cpu"]
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
    print("phase train-check: " + json.dumps(results), flush=True)
    check(fp32_k3 == TRAIN_CHECK_LAYERS, f"train-check: fp32 K3 launches {fp32_k3}, want {TRAIN_CHECK_LAYERS}")
    check(results["loss_abs_diff"] <= TRAIN_CHECK_ATOL["loss"], "train-check: loss differs")
    check(results["grad_norm_abs_diff"] <= TRAIN_CHECK_ATOL["grad_norm"], "train-check: grad norm differs")
    check(results["grads_norm_rel_err"] <= TRAIN_CHECK_ATOL["grads_norm_rel"], "train-check: gradients differ")
    check(results["params_max_abs_diff"] <= TRAIN_CHECK_ATOL["params"], "train-check: parameters differ")
    check(results["params_share_above_1e-6"] <= TRAIN_CHECK_ATOL["params_share_above_1e-6"],
          "train-check: too many parameters differ")
    print("phase train-check: ok")
    return results


def _grad_step(batch, dtype) -> dict:
    """One training step at the train-check's size (no dropout) on the card
    in ``dtype``: loss, gradient norm and the float32 masters' gradients."""
    model, state = build_lba_training(
        SEED, "cuda", dtype, lr=1e-4, dropout=0.0, num_encoder_layers=TRAIN_CHECK_LAYERS
    )
    result = train_step(model, state, batch, deterministic=True)
    return {
        "loss": result.loss.item(),
        "grad_norm": result.grad_norm.item(),
        "grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
    }


def phase_bf16_check() -> dict:
    """The bf16 training step's gradients against the fp32 step's, on the
    card: through the kernels (K2's forward and the tensor-core K3's
    recompute run the same bf16 layer body, so they round alike) and
    through the plain stack in bf16 (autograd through edge_map_plain, whose
    forward and backward also round alike)."""
    batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0].to(torch.device("cuda"))
    ref = _grad_step(batch, torch.float32)
    edge_map_backward.launches = edge_map_backward.tc_launches = 0
    runs = {"kernels": _grad_step(batch, torch.bfloat16)}
    tc_launches = edge_map_backward.tc_launches
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
    results["launches"] = {"K3_tc": tc_launches}
    print("phase bf16-check: " + json.dumps(results), flush=True)
    check(tc_launches == TRAIN_CHECK_LAYERS, f"bf16-check: tensor-core K3 launches {tc_launches}")
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    train_step(model, state, dev_batch, generator)
    result["train_step"] = device_profile(lambda: train_step(model, state, dev_batch, generator))
    print("phase profile: ok " + json.dumps(result))
    return result


def kernel_line(k1, k2, k3, forward, train, train_check) -> dict:
    """The contract line: K1 and K2 at bf16 (the production precision) on
    the tile-aligned layout the main path uses, fp32 and K1's CSR layout
    beside them, launches from the training run (the prediction run's
    beside them); K3 as its two kernels, bf16 (tensor cores, launched by the
    bf16 training run) and fp32 (CUDA cores, launched by the fp32
    train-check step)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    replaces_k3 = "gcpnet_tpu/ops/pallas_fused.py:175"

    def row(name, source, replaces, launches, main, dtype, **extra):
        return {
            "name": name, "route": "cuda", "source": f"gcpnet_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, **{k: main[k] for k in keys}, "dtype": dtype, **extra,
        }

    return {
        "kernels": [
            row("segment_sum_sorted", "segment_sorted.cu", "gcpnet_tpu/ops/pallas_segment.py:160",
                train["launches"]["K1"], k1["tile128_bf16"], "bf16",
                forward_launches=forward["launches"]["K1"],
                **{f"fp32_{k}": k1["tile128_fp32"][k] for k in keys},
                **{f"csr_{k}": k1["tile1_bf16"][k] for k in keys},
                **{f"csr_fp32_{k}": k1["tile1_fp32"][k] for k in keys}),
            row("edge_map", "edge_map_tc.cu", "gcpnet_tpu/ops/pallas_fused.py:117", train["launches"]["K2"],
                k2["bf16"], "bf16", forward_launches=forward["launches"]["K2"],
                bound_rate=k2["bf16"]["bound_rate"],
                **{f"fp32_{k}": k2["fp32"][k] for k in (*keys, "bound_rate")}),
            row("edge_map_backward_tc", "edge_map_bwd_tc.cu", replaces_k3, train["launches"]["K3"],
                k3["bf16"], "bf16", forward_launches=forward["launches"]["K3"]),
            row("edge_map_backward", "edge_map_bwd.cu", replaces_k3, train_check["launches"]["K3_fp32"],
                k3["fp32"], "fp32"),
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
    os.makedirs(args.out_dir, exist_ok=True)
    report = {}
    try:
        report["device"] = phase_device()
        report["build"] = phase_build(args.out_dir)
        batches = synthetic_batches(FORWARD_BATCHES, GRAPHS, NODES, EDGES_PER_NODE, SEED)
        csr = synthetic_batches(1, GRAPHS, NODES, EDGES_PER_NODE, SEED, sort_tile=1)[0]
        report["K1"] = phase_k1({128: batches[0], 1: csr})
        report["K2"] = phase_k2(batches[0])
        report["K3"] = phase_k3(batches[0])
        report["forward"] = phase_forward(batches)
        report["train"] = phase_train(batches[0])
        report["train_check"] = phase_train_check()
        report["bf16_check"] = phase_bf16_check()
        report["profile"] = phase_profile(batches)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(kernel_line(report["K1"], report["K2"], report["K3"], report["forward"], report["train"],
                                 report["train_check"])))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": report["device"]["kind"], "count": report["device"]["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
