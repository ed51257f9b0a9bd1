#!/usr/bin/env python3
"""Time K2 (gcpnet_torch/csrc/edge_map_tc.cu) against other versions of its
source, such as a parent commit's.

    git archive <commit> gcpnet_torch/csrc | tar -x -C logs/parent
    python3 k2_versions.py logs/parent/gcpnet_torch/csrc/edge_map_tc.cu

Needs the card.  Builds this tree's source and each given one (an
edge_map_tc.cu, or the CUDA-core K2's edge_map.cu with its C entry point
gcp_edge_map, each with the headers beside it; a source from before the layers' leaky
slopes gets the layer table without them, chip_smoke.stack_for_source)
with nvcc, all at once, then
times each by CUDA events at the main path's shape ([E, 340] messages +
[E, 9] frames -> [E, 148], the benchmark's 8-layer stack), fp32 and bf16, in
turns: the versions, then the versions in reverse order.  Each result is
checked against the plain version (chip_smoke.TOL) and compared bit for bit
with this tree's.  Prints one JSON line of
each build's registers and spills (ptxas), one JSON line per dtype (each version's mean of
its two turns, and the turns), then the card's name and power limit.
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
from gcpnet_torch.ops.edge_map import edge_map_plain, launch_forward
from gcpnet_torch.ops.segment_sorted import DTYPE_CODES
from gcpnet_torch.predict import DTYPES, synthetic_batches

OUT_DIR = os.path.join("logs", "k2_versions")


def build_all(sources: dict):
    """name -> source path: the loaded libraries, built at once, and each
    build's ptxas lines that report registers and spills."""
    procs = {}
    for name, path in sources.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(OUT_DIR, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spills = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{out}")
        spills[name] = sorted(
            {ln.strip() for ln in out.splitlines()
             if "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln)}
        )
    return {name: ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")) for name in sources}, spills


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", help="other versions of edge_map_tc.cu, or of edge_map.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k2_versions: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    sources = {"this": str(build.CSRC / "edge_map_tc.cu")}
    sources.update({
        f"{'v' if os.path.basename(path) == 'edge_map_tc.cu' else 'old'}{i}": path
        for i, path in enumerate(args.sources, 1)
    })
    libs, spills = build_all(sources)
    print(json.dumps({"spills": spills}), flush=True)
    for name, lib in libs.items():
        if name.startswith("old"):
            lib.gcp_edge_map.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                                                  ctypes.c_int, ctypes.c_void_p]
            lib.gcp_edge_map.restype = ctypes.c_int
        else:
            build.bind(lib, "edge_map_tc")

    batch = synthetic_batches(1, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE, chip_smoke.SEED)[0]
    mp = chip_smoke.bench_message_passing()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 1)
    stream = torch.cuda.current_stream().cuda_stream
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
            message, frames = chip_smoke.stack_inputs(batch, stack, dtype, gen)
            want = edge_map_plain(message, frames, stack)
        e = message.shape[0]
        out = torch.empty((e, stack.out_dim), dtype=dtype, device="cuda")
        calls, result = {}, {}
        for name, lib in libs.items():
            if name.startswith("old"):
                old = chip_smoke.stack_for_source(stack, sources[name])

                def call(lib=lib, old=old):
                    err = lib.gcp_edge_map(message.data_ptr(), frames.data_ptr(), old.weights.data_ptr(),
                                           old.meta.ctypes.data, old.meta.size, out.data_ptr(), e,
                                           DTYPE_CODES[dtype], stream)
                    if err != 0:
                        raise RuntimeError(f"old K2: launch failed with error {err}")
                    return out
            else:
                with torch.no_grad():
                    # weight images of its own build, and its own layer table
                    own = chip_smoke.stack_for_source(mp.packed_stack(), sources[name])
                call = lambda lib=lib, own=own: launch_forward(message, frames, own, lib=lib)  # noqa: E731
            got = call().clone()
            err, rel = chip_smoke.rel_err(got, want)
            chip_smoke.check(rel <= chip_smoke.TOL[("K2", dname)], f"{name} {dname}: rel err {rel:.3g}")
            result[name] = {"source": sources[name], "max_abs_err": err, "rel_err": rel,
                            "equal_to_this": torch.equal(got, result["this"]["out"]) if result else True, "out": got}
            calls[name] = call
        order = list(calls) + list(reversed(calls))
        turns = {name: [] for name in calls}
        with torch.no_grad():
            for name in order:
                turns[name].append(chip_smoke.cuda_ms(calls[name], iters=10))
        for name, t in turns.items():
            result[name].update(ms=sum(t) / len(t), ms_turns=t)
            del result[name]["out"]
        print(json.dumps({"dtype": dname, "shape": [e, stack.in_dim, stack.out_dim], "versions": result}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
