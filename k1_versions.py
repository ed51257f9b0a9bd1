#!/usr/bin/env python3
"""Time K1 (gcpnet_torch/csrc/segment_sorted.cu) against other versions of
its source, such as a parent commit's.

    git archive <commit> gcpnet_torch/csrc | tar -x -C logs/parent
    python3 k1_versions.py logs/parent/gcpnet_torch/csrc/segment_sorted.cu

Needs the card.  Builds this tree's source and each given one with nvcc,
all at once (each with the headers beside it), then times each through its
C entry point at the main path's shape ([E, 148] edge rows into N nodes),
fp32 and bf16, on the tile-aligned and the CSR layouts, by device time under
the profiler (chip_smoke.device_ms), in turns: torch.segment_reduce, the
versions, the versions in reverse order, torch.segment_reduce.  Each result
is checked against the plain version.  Prints one JSON line per layout and
dtype (each version's mean of its two turns, and the turns), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from gcpnet_torch.ops import build
from gcpnet_torch.ops.segment_sorted import DTYPE_CODES, segment_sum_sorted_plain
from gcpnet_torch.predict import DTYPES, synthetic_batches

OUT_DIR = os.path.join("logs", "k1_versions")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", help="other versions of segment_sorted.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k1_versions: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    sources = {"this": str(build.CSRC / "segment_sorted.cu")}
    sources.update({f"v{i}": path for i, path in enumerate(args.sources, 1)})
    procs = {}
    for name, path in sources.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(OUT_DIR, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{err}")
    fns = {
        name: build.bind(ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")), "segment_sorted").gcp_segment_sum_sorted
        for name in sources
    }

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for tile in (128, 1):
        batch = synthetic_batches(1, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE,
                                  chip_smoke.SEED, sort_tile=tile)[0]
        splits = torch.as_tensor(batch.edge_row_splits).cuda()
        n, end = batch.num_nodes, int(batch.edge_row_splits[-1])
        lengths = (splits[1:] - splits[:-1]).long()
        for dname, dtype in DTYPES.items():
            data = torch.randn((batch.num_edges, 148), generator=gen, device="cuda").to(dtype)
            out = torch.empty((n, 148), dtype=dtype, device="cuda")
            ref = segment_sum_sorted_plain(data, splits, n).float()

            def call(name):
                err = fns[name](data.data_ptr(), splits.data_ptr(), out.data_ptr(), data.shape[0], n, 148,
                                DTYPE_CODES[dtype], stream)
                if err != 0:
                    raise RuntimeError(f"{sources[name]}: launch failed with error {err}")

            calls = {"library": lambda: torch.segment_reduce(data[:end], "sum", lengths=lengths, unsafe=True)}
            calls.update({name: lambda name=name: call(name) for name in sources})
            row = {"sources": sources}
            for name in sources:
                call(name)
                row[f"{name}_max_abs_err"] = (out.float() - ref).abs().max().item()
            order = ["library", *sources, *reversed(list(sources)), "library"]
            turns = [chip_smoke.device_ms(calls[name]) for name in order]
            for name in calls:
                row[f"{name}_ms"] = sum(t for o, t in zip(order, turns) if o == name) / 2
            row["turns"] = list(zip(order, turns))
            print(json.dumps({"layout": f"tile{tile}", "dtype": dname, **row}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
