#!/usr/bin/env python3
"""Where K3's time goes: time the tensor-core backward kernel
(gcpnet_torch/csrc/edge_map_bwd_tc.cu) with parts of its work removed, in
bf16 and in float32, and against other versions of its source.

    python3 k3_breakdown.py
    git archive <commit> gcpnet_torch/csrc | tar -x -C logs/parent
    python3 k3_breakdown.py logs/parent/gcpnet_torch/csrc/edge_map_bwd_tc.cu

Needs the card.  Each variant is the kernel's source built with
``-DK3_CUT=<n>``, one of the kernel's ``Cut`` values, which removes one part
of the work (so its results are wrong by design): the weight-gradient
partials' loads and stores, the weight-gradient products (and bias sums),
the scratch traffic of the layers' input states, the forward sweep, the
reverse sweep's recompute, the backward's data products.  The other
versions given are ``edge_map_bwd_tc.cu`` files with this tree's C
interface, each with the headers beside it (a source from before the
layers' leaky slopes gets the layer table without them,
chip_smoke.stack_for_source).  All are built with nvcc at
once, then each is timed by CUDA events on the same inputs at the main
path's shape, both dtypes: the cuts once each, the whole kernel and the
other versions in turns (the whole, the versions, the versions in reverse
order, the whole).  The whole kernel and each version are held against the
plain version, leaf by leaf (chip_smoke.k3_leaf_errs), and each version's
results are compared bit for bit with the whole kernel's.  In float32 they
are also measured against the plain version in float64, beside two
yardsticks: the plain float32 version's own distance from float64, and a
control of lower precision, the plain version with its products in one
TF32 pass (``torch.backends.cuda.matmul.allow_tf32``), which chip_smoke's
float32 leaf bound must tell from a float32-grade kernel.  Prints one JSON
line of the whole kernel's and the versions' ptxas register and spill
reports, then one JSON line per dtype with the card's name, the
milliseconds of each variant and the leaf errors.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from gcpnet_torch.ops import build
from gcpnet_torch.ops.edge_map import edge_map_backward_plain, edge_map_plain, launch_backward
from gcpnet_torch.predict import DTYPES, synthetic_batches

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


@contextlib.contextmanager
def one_tf32_pass():
    """float32 matmuls on the card as one TF32 product each, inside."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def worst_leaf(got, ref, stack) -> dict:
    """The largest of K3's leaf errors (chip_smoke.k3_leaf_errs) and its leaf."""
    errs = chip_smoke.k3_leaf_errs(*got, *ref, stack)
    leaf = max(errs, key=errs.get)
    return {"max": errs[leaf], "leaf": leaf}


def build_all(sources: dict) -> dict:
    """name -> (source, extra nvcc flags): one nvcc each, all at once.
    Returns each build's ptxas lines on registers and stack."""
    procs = {}
    for name, (path, flags) in sources.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-o", os.path.join(OUT_DIR, f"lib{name}.so"),
               str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    usage = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        usage[name] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    return usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", help="other versions of edge_map_bwd_tc.cu (this tree's C interface)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k3_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    src = SOURCE.read_text()
    for name, (enum, value) in CUTS.items():
        if f"{enum} = {value}" not in src:
            raise RuntimeError(f"{name}: the kernel no longer defines {enum} = {value}")
    os.makedirs(OUT_DIR, exist_ok=True)
    sources = {name: (SOURCE, [f"-DK3_CUT={value}"]) for name, (_, value) in CUTS.items()}
    sources.update({f"v{i}": (path, []) for i, path in enumerate(args.sources, 1)})
    usage = build_all(sources)
    print(json.dumps({"ptxas": {name: lines for name, lines in usage.items() if name not in CUTS or name == "whole"}}),
          flush=True)
    kernels = {}
    for name in sources:
        lib = build.bind(ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")), "edge_map_bwd_tc")
        kernels[name] = lambda m, f, s, g, lib=lib: launch_backward(m, f, s, g, lib=lib)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    batch = synthetic_batches(1, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE, chip_smoke.SEED)[0]
    mp = chip_smoke.bench_message_passing()
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
        stack_of = {name: chip_smoke.stack_for_source(stack, sources[name][0]) for name in kernels}
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
        message, frames = chip_smoke.stack_inputs(batch, stack, dtype, gen)
        e = message.shape[0]
        grad_out = torch.randn((e, stack.out_dim), generator=gen, device="cuda").to(dtype)
        versions = ["whole", *(name for name in kernels if name not in CUTS)]
        turns = {name: [] for name in kernels}
        for name in [*(n for n in kernels if n not in versions), *versions, *reversed(versions)]:
            turns[name].append(chip_smoke.cuda_ms(lambda: kernels[name](message, frames, stack_of[name], grad_out),
                                                  iters=5, warmup=1))
        # each whole kernel's leaves against the plain version (and in
        # float32 against the plain version in float64)
        refs = {"plain": edge_map_backward_plain(message, frames, stack, grad_out)}
        if dtype == torch.float32:
            with torch.enable_grad():
                m64 = message.double().requires_grad_()
                w64 = stack.weights.detach().double().requires_grad_()
                out = edge_map_plain(m64, frames.double(), stack, w64)
                refs["fp64"] = tuple(t.float() for t in torch.autograd.grad(out, (m64, w64), grad_out.double()))
            del m64, w64, out
            with one_tf32_pass():
                control = edge_map_backward_plain(message, frames, stack, grad_out)
        leaves, same = {}, {}
        first = kernels["whole"](message, frames, stack, grad_out)
        for name in versions:
            got = kernels[name](message, frames, stack_of[name], grad_out)
            same[name] = all(torch.equal(a, b) for a, b in zip(got, first))
            for ref_name, ref in refs.items():
                leaves[f"{name}_vs_{ref_name}"] = worst_leaf(got, ref, stack)
        if dtype == torch.float32:
            leaves["plain_vs_fp64"] = worst_leaf(refs["plain"], refs["fp64"], stack)
            for ref_name, ref in refs.items():
                leaves[f"tf32_control_vs_{ref_name}"] = worst_leaf(control, ref, stack)
            del control
        del refs
        print(json.dumps({
            "card": smi, "dtype": dname, "shape": [e, stack.in_dim, stack.out_dim],
            "ms": {name: sum(t) / len(t) for name, t in turns.items()}, "ms_turns": turns,
            "sources": {name: str(sources[name][0]) for name in versions}, "leaves": leaves,
            "equal_to_whole": same,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
