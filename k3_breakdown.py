#!/usr/bin/env python3
"""Where the bf16 K3's time goes: time the tensor-core backward kernel
(gcpnet_torch/csrc/edge_map_bwd_tc.cu) with parts of its work removed.

    python3 k3_breakdown.py

Needs the card.  Each variant is the kernel's source built with
``-DK3_CUT=<n>``, one of the kernel's ``Cut`` values, which removes one part
of the work (so its results are wrong by design): the weight-gradient
partials' loads and stores, the weight-gradient products (and bias sums),
the scratch traffic of the layers' input states, the forward sweep, the
reverse sweep's recompute, the backward's data products.  All are built
with nvcc at once, then each is timed through the wrapper's launch
(ops.edge_map.launch_backward) on the same bf16 inputs at the main path's
shape (CUDA events).  The differences to the whole kernel bound what each
part costs.  Prints one JSON line with the card's name and the
milliseconds of each variant.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from gcpnet_torch.ops import build
from gcpnet_torch.ops.edge_map import launch_backward
from gcpnet_torch.predict import synthetic_batches

SOURCE = build.CSRC / "edge_map_bwd_tc.cu"
OUT_DIR = os.path.join("logs", "k3_breakdown")
# variant -> the kernel's Cut enumerator and its value
CUTS = {
    "whole": ("kWhole", 0),
    "no_partials": ("kNoPartials", 1),
    "no_weight_grads": ("kNoWeightGrads", 2),
    "no_scratch": ("kNoScratch", 3),
    "no_forward_sweep": ("kNoForwardSweep", 4),
    "no_recompute": ("kNoRecompute", 5),
    "no_backward_products": ("kNoBackwardProducts", 6),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    src = SOURCE.read_text()
    for name, (enum, value) in CUTS.items():
        if f"{enum} = {value}" not in src:
            raise RuntimeError(f"{name}: the kernel no longer defines {enum} = {value}")
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (_, value) in CUTS.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-DK3_CUT={value}", "-o", os.path.join(OUT_DIR, f"lib{name}.so"),
               str(SOURCE)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")

    batch = synthetic_batches(1, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE, chip_smoke.SEED)[0]
    with torch.no_grad():
        stack = chip_smoke.bench_message_passing().to(torch.bfloat16).packed_stack()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
    message, frames = chip_smoke.stack_inputs(batch, stack, torch.bfloat16, gen)
    e = message.shape[0]
    grad_out = torch.randn((e, stack.out_dim), generator=gen, device="cuda").to(torch.bfloat16)
    ms = {}
    for name in procs:
        lib = build.bind(ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")), "edge_map_bwd_tc")
        ms[name] = chip_smoke.cuda_ms(
            lambda: launch_backward(message, frames, stack, grad_out, lib=lib), iters=5, warmup=1
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "dtype": "bf16", "shape": [e, stack.in_dim, stack.out_dim], "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
