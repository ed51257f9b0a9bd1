#!/usr/bin/env python3
"""Where K2's time goes: time the forward kernel
(gcpnet_torch/csrc/edge_map_tc.cu) with parts of its work removed, in bf16
and in float32.

    python3 k2_breakdown.py
    python3 k2_breakdown.py path/to/edge_map_tc.cu   # another version with K2_CUT

Needs the card.  Each variant is the kernel's source built with
``-DK2_CUT=<n>``, one of the ``K2Cut`` values of ``edge_stack.cuh`` (beside
the source), which removes one part of the work (so its results are wrong by
design): the products, the elementwise passes (vnorm and scal9, the layer
output), the copies of the layers' weights into shared memory, all three at
once (what is left is the tile's input, its output and the barriers), and
the tile's input and output.  All are built with nvcc at once, then each is
timed by CUDA events on the same inputs at the main path's shape ([E, 340]
messages + [E, 9] frames -> [E, 148], the benchmark's 8-layer stack): the
cuts once each, the whole kernel before and after them.  The whole kernel is
held against the plain version (chip_smoke.TOL).  Prints one JSON line of
the whole kernel's ptxas register and spill report, then one JSON line per
dtype with the card's name and power limit, the milliseconds of each
variant, and each variant's microseconds per layer per tile (its time over
the tiles one block walks and the layers).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch

import chip_smoke
from gcpnet_torch.ops import build
from gcpnet_torch.ops.edge_map import edge_map_plain, k2_layout, launch_forward
from gcpnet_torch.predict import DTYPES, synthetic_batches

OUT_DIR = os.path.join("logs", "k2_breakdown")
# variant -> the K2Cut enumerator and its value
CUTS = {
    "whole": ("kK2Whole", 0),
    "no_products": ("kK2NoProducts", 1),
    "no_elementwise": ("kK2NoElementwise", 2),
    "no_weight_staging": ("kK2NoWeightStaging", 3),
    "barriers_only": ("kK2BarriersOnly", 4),
    "no_input_output": ("kK2NoInputOutput", 5),
}


def build_all(source: str) -> dict:
    """Every cut of ``source``: one nvcc each, all at once.  Returns the
    whole build's ptxas lines on registers and spills."""
    procs = {}
    for name, (_, value) in CUTS.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", f"-DK2_CUT={value}",
               "-o", os.path.join(OUT_DIR, f"lib{name}.so"), source]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    usage = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        usage[name] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    return usage["whole"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("source", nargs="?", default=str(build.CSRC / "edge_map_tc.cu"),
                        help="an edge_map_tc.cu whose edge_stack.cuh (beside it) defines K2Cut")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k2_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    header = os.path.join(os.path.dirname(args.source), "edge_stack.cuh")
    text = open(header).read()
    for name, (enum, value) in CUTS.items():
        if f"{enum} = {value}" not in text:
            raise RuntimeError(f"{name}: {header} does not define {enum} = {value}")
    os.makedirs(OUT_DIR, exist_ok=True)
    print(json.dumps({"source": args.source, "ptxas_whole": build_all(args.source)}), flush=True)
    libs = {name: build.bind(ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")), "edge_map_tc") for name in CUTS}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    batch = synthetic_batches(1, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE, chip_smoke.SEED)[0]
    mp = chip_smoke.bench_message_passing()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dname, dtype in DTYPES.items():
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 1)
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
            message, frames = chip_smoke.stack_inputs(batch, stack, dtype, gen)
            want = edge_map_plain(message, frames, stack)
        e = message.shape[0]
        rows, _, smem = k2_layout(stack, dtype, libs["whole"])
        stacks = {}
        with torch.no_grad():
            for name in CUTS:  # each build keeps its own weight images
                stacks[name] = mp.to(dtype).packed_stack() if name != "whole" else stack

            def call(name):
                return launch_forward(message, frames, stacks[name], lib=libs[name])

            got = call("whole")
            err, rel = chip_smoke.rel_err(got, want)
            chip_smoke.check(rel <= chip_smoke.TOL[("K2", dname)], f"whole {dname}: rel err {rel:.3g}")
            order = ["whole", *(n for n in CUTS if n != "whole"), "whole"]
            turns = {name: [] for name in CUTS}
            for name in order:
                turns[name].append(chip_smoke.cuda_ms(lambda: call(name), iters=10))
        ms = {name: sum(t) / len(t) for name, t in turns.items()}
        tiles_per_block = math.ceil(math.ceil(e / rows) / sms)
        layers = len(stack.layers)
        print(json.dumps({
            "card": smi, "dtype": dname, "shape": [e, stack.in_dim, stack.out_dim], "tile_rows": rows,
            "smem_bytes": smem, "tiles_per_block": tiles_per_block, "ms": ms, "ms_turns": turns,
            "us_per_layer_tile": {n: 1e3 * t / (tiles_per_block * layers) for n, t in ms.items()},
            "whole_max_abs_err": err, "whole_rel_err": rel,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
