#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both CUDA kernels from gcpnet_torch/csrc (one nvcc each, started
     together; ptxas resource usage goes to <out-dir>/ptxas.txt);
  3. K1 (sorted segment sum) against its plain PyTorch version at the main
     path's shape, fp32 and bf16, on the tile-aligned and the CSR layouts;
  4. K2 (fused message stack) against its plain version at the main path's
     shape, fp32 and bf16;
  5. the LBA forward at the benchmark's full width (16 graphs x 448 atoms,
     8 interaction layers x 8 message layers) through gcpnet_torch.predict,
     fp32 and bf16: launch counts, finiteness, latency, peak memory; then the
     fp32 predictions against the same weights and batch run on the CPU
     through the plain versions;
  6. profile: one warm bf16 forward under torch.profiler (device busy and
     idle share, time by kernel).
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

from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops import build as kernel_build
from gcpnet_torch.ops.edge_map import edge_map, edge_map_plain
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch.predict import DTYPES, build_model, lba_configs, predict, synthetic_batches

SEED = 0
GRAPHS, NODES, EDGES_PER_NODE = 16, 448, 28
FORWARD_BATCHES = 4  # the first is the cold one; latency is over the rest
# The published H100 SXM peaks (NVIDIA data sheet, dense): device memory
# rate, and the operation rate for each input type (bf16 on the tensor
# cores, fp32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Tolerances, as max |kernel - plain| <= rel * max(1, max |plain|):
# K1 fp32: both sum in float32, only the order differs.
# K1 bf16: both sum in float32 and round once; the order can flip that
#   rounding by one bf16 step (2^-8 relative).
# K2 fp32: float32 throughout, summation order differs.
# K2 bf16: the plain version rounds every matmul output to bf16 (as the JAX
#   package's MM form does) while the kernel keeps float32 intermediates.
TOL = {("K1", "fp32"): 1e-5, ("K1", "bf16"): 1e-2, ("K2", "fp32"): 1e-4, ("K2", "bf16"): 5e-2}
# full-width fp32 forward, card vs CPU: summation order differs in every
# reduction and matmul of 8 x 8 layers
FORWARD_ATOL = 1e-3


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


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    return err, err / scale


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
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
            results[f"tile{tile}_{dname}"] = {
                "max_abs_err": err,
                "ms": cuda_ms(lambda: segment_sum_sorted(data, splits, n)),
                "plain_ms": cuda_ms(lambda: segment_sum_sorted_plain(data, splits, n)),
                "library_ms": cuda_ms(
                    lambda: torch.segment_reduce(data[:end], "sum", lengths=lengths, unsafe=True)
                ),
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


def phase_k2(batch) -> dict:
    """K2 at the main path's shape: [E, 340] messages + [E, 9] frames ->
    [E, 148], with the benchmark's stack (8 GCP2 layers, hidden 100/16)."""
    model_cfg, module_cfg, layer_cfg = lba_configs()
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    mp = GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    e = batch.num_edges
    mask = torch.as_tensor(batch.edge_pad_mask).cuda()
    results = {}
    for dname, dtype in DTYPES.items():
        stack = mp.to(dtype).packed_stack()
        message = torch.randn((e, stack.in_dim), generator=gen, device="cuda")
        # an eighth of the rows with all-zero vectors: the norm's eps decides there
        message[: e // 8, stack.layers[0].dims[0] :] = 0.0
        message = message.to(dtype)
        frames = torch.rand((e, 9), generator=gen, device="cuda") * 2 - 1
        frames = (frames * mask[:, None]).to(dtype)
        got = edge_map(message, frames, stack)
        ref = edge_map_plain(message, frames, stack)
        check(bool(torch.isfinite(got).all()), f"K2 {dname}: non-finite output")
        err, rel = rel_err(got, ref)
        check(rel <= TOL[("K2", dname)], f"K2 {dname}: rel err {rel:.3g}")
        es = message.element_size()
        nbytes = e * (stack.in_dim + 9 + stack.out_dim) * es + stack.weights.numel() * 4
        flops = e * stack_flops(stack)
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        results[dname] = {
            "max_abs_err": err,
            "rel_err": rel,
            "ms": cuda_ms(lambda: edge_map(message, frames, stack), iters=10),
            "plain_ms": cuda_ms(lambda: edge_map_plain(message, frames, stack), iters=5),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "shape": [e, stack.in_dim, stack.out_dim],
        }
    print("phase K2: ok " + json.dumps(results))
    return results


def phase_forward(batches) -> dict:
    """The main path: full-width LBA prediction through gcpnet_torch.predict
    on the card, fp32 then bf16, with every kernel count set to 0 just
    before and read just after."""
    results = {}
    segment_sum_sorted.launches = 0
    edge_map.launches = 0
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
    results["launches"] = {"K1": segment_sum_sorted.launches, "K2": edge_map.launches}
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


def phase_profile(batches) -> dict:
    """Where the time goes: one warm bf16 full-width forward under
    torch.profiler; device busy time is the sum of the CUDA kernels' times
    (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = build_model(SEED, "cuda", torch.bfloat16)
    predict(model, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(model, batches[1])
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
    result = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if kernels else "not measured",
        "device_idle_share": 1 - busy_us / wall_us if kernels else "not measured",
        "kernel_launches": len(kernels),
        "share": {
            label: sum(v for k, v in by_name.items() if key in k) / busy_us if kernels else "not measured"
            for label, key in (("K2 edge_map", "edge_map_kernel"), ("K1 segment_sum_sorted", "seg_sum"))
        },
        "top_ms": [[k, v / 1e3] for k, v in top],
    }
    print("phase profile: ok " + json.dumps(result))
    return result


def kernel_line(k1, k2, forward) -> dict:
    """The contract line: main numbers at bf16 (the production precision)
    on the tile-aligned layout the main path uses; fp32 beside them."""
    k1m, k1f = k1["tile128_bf16"], k1["tile128_fp32"]
    k2m, k2f = k2["bf16"], k2["fp32"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "kernels": [
            {
                "name": "segment_sum_sorted",
                "route": "cuda",
                "source": "gcpnet_torch/csrc/segment_sorted.cu",
                "replaces": "gcpnet_tpu/ops/pallas_segment.py:160",
                "launches": forward["launches"]["K1"],
                **{k: k1m[k] for k in keys},
                "dtype": "bf16",
                **{f"fp32_{k}": k1f[k] for k in keys},
            },
            {
                "name": "edge_map",
                "route": "cuda",
                "source": "gcpnet_torch/csrc/edge_map.cu",
                "replaces": "gcpnet_tpu/ops/pallas_fused.py:117",
                "launches": forward["launches"]["K2"],
                **{k: k2m[k] for k in keys},
                "dtype": "bf16",
                **{f"fp32_{k}": k2f[k] for k in keys},
            },
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
        report["forward"] = phase_forward(batches)
        report["profile"] = phase_profile(batches)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(kernel_line(report["K1"], report["K2"], report["forward"])))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": report["device"]["kind"], "count": report["device"]["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
