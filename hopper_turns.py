#!/usr/bin/env python3
"""K2 and K3 in bf16, this tree's kernels against a parent's, in turns on
one card, at every bf16 cell's shape, and the captured LBA bf16 step and
forward with each.

    git archive <commit> gcpnet_torch/csrc | tar -x -C logs/parent
    python3 hopper_turns.py logs/parent/gcpnet_torch/csrc

Needs the card.  Builds this tree's edge_map_tc.cu and edge_map_bwd_tc.cu
and the parent's (nvcc -Xptxas -v, all four at once), then:

- K2 and K3 bf16 at each cell's rows and message stack (LBA 208,896 rows and
  PSR 524,288 on LBA's stack, CPD 61,440 on CPD's, EQ 262,144 on EQ's, AR
  622,592 on AR's), random inputs from the seed: parent, this, this, parent
  by CUDA events; each kernel's bound (chip_smoke.route_bound_ms) and its
  share; the tile rows and shared memory of each; this tree's K2 held to
  chip_smoke.TOL against the plain version;
- the full-width LBA bf16 training step captured as the CLI runs it
  (TrainSteps) and the captured forward (Predictor), each built anew with
  this tree's kernels and with the parent's (the wrappers' library swapped),
  in turns (this, parent, parent, this): one replay under torch.profiler,
  its device busy ms (chip_smoke.device_profile).

Prints one JSON line of the builds' ptxas registers and spills, one per
cell, one for the step and forward, then the card's name and power limit.
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
from gcpnet_torch.models.lba import graph_regression_loss
from gcpnet_torch.ops import build
from gcpnet_torch.ops import edge_map as em
from gcpnet_torch.predict import Predictor, synthetic_batches
from gcpnet_torch.train.graphs import TrainSteps

OUT_DIR = os.path.join("logs", "hopper_turns")
SOURCES = ("edge_map_tc", "edge_map_bwd_tc")
# cell -> (edge rows, the function that makes its message stack)
CELLS = {
    "lba": (None, chip_smoke.bench_message_passing),  # the synthetic LBA batch's rows
    "psr": (524288, chip_smoke.bench_message_passing),
    "cpd": (61440, chip_smoke.cpd_message_passing),
    "eq": (262144, chip_smoke.eq_message_passing),
    "ar": (622592, chip_smoke.ar_message_passing),
}


def build_all(parent: str) -> tuple:
    """This tree's and the parent's two sources: (libraries by version and
    source name, ptxas lines on registers and spills)."""
    procs = {}
    for version, root in (("this", str(build.CSRC)), ("parent", parent)):
        for name in SOURCES:
            out = os.path.join(OUT_DIR, f"lib{name}_{version}.so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, os.path.join(root, f"{name}.cu")]
            procs[(version, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                       text=True), out)
    libs, usage = {"this": {}, "parent": {}}, {}
    for (version, name), (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {version} {name}:\n{text}")
        usage[f"{version}/{name}"] = sorted(
            {ln.strip() for ln in text.splitlines()
             if "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln)})
        libs[version][name] = build.bind(ctypes.CDLL(out), name)
    return libs, usage


def turns(calls: dict, iters: int) -> dict:
    """parent, this, this, parent: each version's mean of its two turns."""
    times = {name: [] for name in calls}
    for name in ("parent", "this", "this", "parent"):
        times[name].append(chip_smoke.cuda_ms(calls[name], iters=iters, warmup=1))
    return {name: {"ms": sum(t) / len(t), "ms_turns": t} for name, t in times.items()}


def cell(name: str, rows, make, libs: dict) -> dict:
    batch = synthetic_batches(1, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE, chip_smoke.SEED)[0]
    e = rows or batch.num_edges
    dtype = torch.bfloat16
    mp = make()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 5)
    with torch.no_grad():
        stacks = {v: mp.to(dtype).packed_stack() for v in libs}  # each build keeps its own weight images
    stack = stacks["this"]
    message = torch.randn((e, stack.in_dim), generator=gen, device="cuda").to(dtype)
    message[: e // 8, stack.layers[0].dims[0]:] = 0.0
    frames = (torch.rand((e, 9), generator=gen, device="cuda") * 2 - 1).to(dtype)
    grad_out = torch.randn((e, stack.out_dim), generator=gen, device="cuda").to(dtype)
    out = {"rows": e, "shape": [e, stack.in_dim, stack.out_dim]}
    flops = e * chip_smoke.stack_flops(stack)
    w = stack.weights.numel()
    with torch.no_grad():
        got = em.launch_forward(message, frames, stack, lib=libs["this"]["edge_map_tc"])
        err, rel = chip_smoke.rel_err(got, em.edge_map_plain(message, frames, stack))
        chip_smoke.check(rel <= chip_smoke.TOL[("K2", "bf16")], f"{name} K2: rel err {rel:.3g}")
        del got
        k2 = turns({v: (lambda v=v: em.launch_forward(message, frames, stacks[v], lib=libs[v]["edge_map_tc"]))
                    for v in libs}, iters=10)
    k3 = turns({v: (lambda v=v: em.launch_backward(message, frames, stacks[v], grad_out,
                                                   lib=libs[v]["edge_map_bwd_tc"])) for v in libs}, iters=5)
    for kernel, res, nbytes, ops in (
        ("K2", k2, e * (stack.in_dim + 9 + stack.out_dim) * 2 + w * 4, flops),
        ("K3", k3, e * (2 * stack.in_dim + 9 + stack.out_dim) * 2 + 2 * w * 4, 3 * flops),
    ):
        b_ms, b_by, _ = chip_smoke.route_bound_ms(nbytes, ops, dtype)
        for v, r in res.items():
            lib = libs[v]["edge_map_tc" if kernel == "K2" else "edge_map_bwd_tc"]
            layout = em.k2_layout(stack, dtype, lib)[::2] if kernel == "K2" else em.k3_tile(stack, dtype, lib)
            r.update(tile_rows=layout[0], smem_bytes=layout[1], share_of_bound=b_ms / r["ms"])
        out[kernel] = {**res, "bound_ms": b_ms, "bound_by": b_by}
    out["K2"]["this"]["max_abs_err"], out["K2"]["this"]["rel_err"] = err, rel
    return out


def step_and_forward(libs: dict, version: str) -> dict:
    """The captured LBA bf16 step and forward with ``version``'s kernels:
    one replay of each under torch.profiler."""
    em.library = lambda name: libs[version].get(name) or build.library(name)
    try:
        batches = synthetic_batches(2, chip_smoke.GRAPHS, chip_smoke.NODES, chip_smoke.EDGES_PER_NODE,
                                    chip_smoke.SEED)
        model, state, gen = chip_smoke._lba_training(torch.bfloat16)
        steps = TrainSteps(model, state, graph_regression_loss, gen)
        pinned = batches[0].pinned()
        for _ in range(3):  # the capture, then replays
            steps([pinned])
        step = chip_smoke.device_profile(lambda: steps([pinned]))
        del steps, model, state
        model = chip_smoke.build_model(chip_smoke.SEED, "cuda", torch.bfloat16)
        predictor = Predictor(model)
        for _ in range(3):
            predictor(batches[0])
        forward = chip_smoke.device_profile(lambda: predictor(batches[1]))
        keep = ("device_busy_ms", "device_idle_share", "wall_ms", "kernel_launches", "share")
        return {"step": {k: step[k] for k in keep}, "forward": {k: forward[k] for k in keep}}
    finally:
        em.library = build.library
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", help="a parent commit's gcpnet_torch/csrc directory")
    parser.add_argument("--cells", default=",".join(CELLS), help="comma-separated cells (default: all five)")
    parser.add_argument("--no-step", action="store_true", help="skip the captured LBA step and forward")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("hopper_turns: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, usage = build_all(args.parent)
    print(json.dumps({"ptxas": usage}), flush=True)
    for name in args.cells.split(","):
        rows, make = CELLS[name]
        print(json.dumps({"cell": name, **cell(name, rows, make, libs)}), flush=True)
        torch.cuda.empty_cache()
    if not args.no_step:
        runs = {}
        for version in ("this", "parent", "parent", "this"):
            runs.setdefault(version, []).append(step_and_forward(libs, version))
        print(json.dumps({"lba_bf16_captured": runs}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
