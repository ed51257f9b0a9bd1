#!/usr/bin/env python3
"""Where K3's time goes: time the edge map's backward kernel
(gcpnet_torch/csrc/edge_map_bwd.cu) with parts of its work removed.

    python3 k3_breakdown.py

Needs the card.  Each variant is the kernel's source with one part cut out
(so its results are wrong by design): the weight-gradient partials' loads
and stores, the weight-gradient products, the scratch traffic of the
activations, the forward sweep.  All are built with nvcc at once, then each
is timed through the wrapper's launch (ops.edge_map.launch_backward) on the
same bf16 inputs at the main path's shape (CUDA events).
The differences to the whole kernel bound what each part costs.  Prints one
JSON line with the card's name and the milliseconds of each variant.
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

SOURCE = build.CSRC / "edge_map_bwd.cu"
OUT_DIR = os.path.join("logs", "k3_breakdown")

FORWARD_SWEEP = """      gcp::layer_forward<kTile>(s, st, L, W);
      if (l < nl - 1) {
        copy_intermediates(s, st, L, l > 0, stash + slot_offset(st, l), true);"""
CUTS = {
    # the partial starts at zero and is never stored
    "no_partials": [
        ("      if (k0 + i >= K) {\n", "      if (true) {\n"),
        ("      if (k0 + i >= K) break;", "      if (k0 + i >= K || !(acc[i][0] == -1.2345e30f)) break;"),
    ],
    "no_weight_grads": [
        ("  const int kg = (K + 3) >> 2, ng = (N + 3) >> 2;",
         "  if (K > 0) return;\n  const int kg = (K + 3) >> 2, ng = (N + 3) >> 2;"),
    ],
    "no_scratch": [
        ("        copy_intermediates(s, st, L, l > 0, stash + slot_offset(st, l), true);", ""),
        ("        copy_intermediates(s, st, L, l > 0, slot, false);", ""),
    ],
    "no_forward_sweep": [
        (FORWARD_SWEEP, """      if (l == nl - 1) gcp::layer_forward<kTile>(s, st, L, W);
      if (false) {"""),
    ],
}


def variant_sources():
    src = SOURCE.read_text()
    out = {"whole": src}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        src = os.path.join(OUT_DIR, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               os.path.join(OUT_DIR, f"lib{name}.so"), src]
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
        fn = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")).gcp_edge_map_bwd
        fn.argtypes = build.SIGNATURES["edge_map_bwd"]["gcp_edge_map_bwd"]
        fn.restype = ctypes.c_int
        ms[name] = chip_smoke.cuda_ms(
            lambda: launch_backward(fn, message, frames, stack, grad_out), iters=5, warmup=1
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "dtype": "bf16", "shape": [e, stack.in_dim, stack.out_dim], "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
