#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the four CUDA sources of gcpnet_torch/csrc (one nvcc each,
     started together; ptxas resource usage goes to <out-dir>/ptxas.txt);
  3. K1 (sorted segment sum) against its plain PyTorch version at the main
     path's shape, fp32 and bf16, on the tile-aligned and the CSR layouts,
     device time of back-to-back calls (queued_ms) in turns with
     torch.segment_reduce (library, kernel, kernel, library);
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
  8. rs-data: the RS splits, synthetic enantiomer pairs (2,048 / 512 / 512
     graphs; the JAX module's hold 4,096 training graphs), and a paired training batch (64
     anchors and their enantiomers: 128 graphs, a bucket of 8,192 nodes and
     16,384 CSR edge rows, about 1,400 and 2,600 of them real);
  9. rs-kernels: K1, K2 and K3 at the RS step's shape against their plain
     versions, fp32 and bf16, the stack's leaky relu included, with their
     times, bounds and shares of them;
 10. psr-data: synthetic PSR records at protein size (write_psr_records:
     40 / 8 / 8 targets of 16 decoys, native chains of 400-2,000 heavy
     atoms at protein packing, decoys the chain plus noise, a GDT-TS-like
     label) written and read by gcpnet_torch.data.atom3d; a shuffled
     training epoch's batches as the prefetch thread makes them (the
     split's first pass before the first; then ms a batch to featurize,
     pack and sort, and to pin), each batch's real nodes and edge rows
     against the JAX bucket's 16,384 and 524,288;
 11. psr-kernels: K1, K2 and K3 at a PSR training batch (524,288 CSR rows
     into 16,384 nodes) against their plain versions, fp32 and bf16, with
     their times, bounds and shares of them;
 11a. cpd-data: synthetic CATH chains (write_cath_chains: 600 / 100 /
     100 chains of 40-500 residues with ideal backbone geometry from
     (phi, psi) in helix, strand and coil segments, each residue drawn by
     its region and burial) in the chain_set.jsonl format, read by
     gcpnet_torch.data.cath; a shuffled training epoch's batches: host ms
     a batch, real nodes and edge rows against the bucket's 2,048 and
     61,440;
 11b. cpd-kernels: K1, K2 and K3 at a CPD training batch (61,440 CSR rows
     into 2,048 nodes) against their plain versions, fp32 and bf16, with
     their times, bounds and shares of them;
 12. forward: the LBA forward at the benchmark's full width (16 graphs x 448
     atoms, 8 interaction layers x 8 message layers) through
     gcpnet_torch.predict, fp32 and bf16, eager and served (Predictor: a
     CUDA graph captured at the first batch, replayed for the rest): launch
     counts, finiteness, latency, peak memory, the served predictions
     against the eager ones; then the fp32 predictions against the same
     weights and batch run on the CPU through the plain versions;
 13. train: the full-width LBA training step through gcpnet_torch.train
     (bf16 over fp32 masters, dropout 0.1, Adam at lr 1e-4, the adaptive
     clip, a StepLR schedule), 6 steps on one batch, twice eagerly and once
     captured (the first step runs eagerly and captures, 5 replays, each
     under torch.cuda.set_sync_debug_mode("error")): the wrappers' launches
     per step (a replay runs none), finiteness, ms per step, graphs/s, peak
     memory; the captured run's parameters, moments and losses against the
     eager run's; a batch with a NaN label replayed through the graph
     leaves the state as it was; one warm eager step and one replay under
     torch.profiler (device busy and idle share, kernels by name, the
     host's CUDA API calls; the eager step's K1-K3 as the wrappers count
     them, the replay's read from its graph's kernel nodes);
 14. train-fp32: the same in float32 (the JAX Trainer's default precision;
     every K3 launch is one of the tensor-core kernel, K3's only one);
 15. train-check: one fp32 training step on the card against the same step
     on the CPU (2 interaction layers, 2 graphs, no dropout): loss, gradient
     norm, gradients and updated parameters; its launches of the fp32 K3;
 16. bf16-check: the bf16 training step's gradients against the fp32
     step's on the card (the train-check's size), through the kernels and
     through the plain stack in bf16;
 17. profile: one warm bf16 forward, eager and replayed, under
     torch.profiler (device busy and idle share, time by kernel, the
     host's CUDA API calls);
 18. nms-check: one fp32 NMS training step on the card against the CPU (2
     interaction layers, 10 graphs, no dropout);
 19. nms-fit: the NMS path, the full-width NMS model (2 of the experiment's
     4 interaction layers) fitted by the Trainer
     the training entry point builds (entry.build_trainer of the composed
     experiment, its defaults but fp32: trainer.precision=32) with scan_chunk_size 4 (4 batches a
     replay of a CUDA graph) for 3 epochs with checkpoints, then a new
     Trainer resumes to epoch 4 and tests the best checkpoint: the
     wrappers' launches (only the graphs' first calls run them),
     per-epoch seconds, train graphs/s, val/loss and val/RMSE, peak memory;
     the first epoch run eagerly step by step beside it (its losses held
     to the captured epoch's, the parameters' distance printed); 16 steps
     and the validation batches run captured and eagerly under
     torch.use_deterministic_algorithms, equal bit for bit; one warm eager
     step and one replay of a train and an eval chunk under torch.profiler,
     the replays' kernels a step read from their graphs' kernel nodes;
 20. rs-check: one fp32 RS training step on the card against the CPU (2
     interaction layers, a paired batch, no dropout);
 21. rs-fit: the RS path, the full-width RS model (2 of its 8 interaction
     layers) fitted by the Trainer
     (entry.build_trainer, the experiment's defaults but fp32) with scan_chunk_size 4 for 3 epochs
     with checkpoints, then the best checkpoint's test: the wrappers'
     launches, per-epoch seconds, train graphs/s, val/loss, val/Accuracy
     and val/F1, peak memory; the first epoch run eagerly beside it, and
     the deterministic parity run, as nms-fit;
 22. rs-profile: one warm eager RS training step and one replay of a train
     and an eval chunk under torch.profiler; the rs-fit's checks;
 23. psr-check: one fp32 PSR training step on the card against the CPU (2
     interaction layers, 2 decoys, no dropout; the updated parameters at
     1e-4 but for those Adam's first step moves by about lr times opposite
     signs, whose two gradients both lie within the gradient bound of 0:
     counted and printed), and the bf16 step's gradients against the fp32
     step's on the card;
 24. psr-fit: the PSR path, the full-width PSR model (2 of its 5 interaction layers)
     fitted by the Trainer in bf16 over float32 masters (the experiment's
     defaults) with scan_chunk_size 4 for 1 epoch with checkpoints, a
     resume to a second, and the best checkpoint's test: epoch seconds,
     train graphs/s, the val and test metrics (local and global Pearson,
     Spearman, Kendall), peak memory and what was allocated as the fit
     began, the CUDA graphs held (at most a full chunk's and the tail's a
     split); the deterministic parity run, as nms-fit;
 25. psr-profile: one warm eager PSR step and one replay of a train and an
     eval chunk under torch.profiler; the psr-fit's checks;
 26. cpd-check: one fp32 CPD training step on the card against the CPU (2
     encoder and 2 decoder layers, 2 chains, no dropout), and the bf16
     step's gradients against the fp32 step's on the card;
 27. cpd-fit: the CPD path, the full-width CPD model (3 of its 9 encoder
     and 1 of its 3 autoregressive decoder layers) fitted by the Trainer in bf16
     over float32 masters with the experiment's defaults (gradients
     accumulated over 4 batches) and scan_chunk_size 4 for 2 epochs with
     checkpoints, a resume to a third, and the best checkpoint's test:
     epoch seconds, train graphs/s, val/loss and val/recovery_argmax, peak
     memory, the CUDA graphs held; the deterministic parity run;
 28. cpd-profile: one warm eager CPD step and one replay of a train and an
     eval chunk under torch.profiler; the cpd-fit's checks;
 29. cpd-design: the fitted model designs 6 test chains (evaluate_cpd: 100
     sequences each at temperature 0.1): median perplexity and recovery
     for all, short and single_chain, ms a chain, the device's launches a
     position; the argmax samples of one chain, card against CPU;
 29a. esm (before eq-data): ESM-2 650M with random weights from the seed,
     written as a fair-esm-shaped checkpoint and loaded back through
     GCPNET_ESM_CHECKPOINT on the card (gcpnet_torch.data.esm): the
     weights equal to those written, ms a sequence at 250 residues and at
     AR's 1,600-residue prediction decoy, peak memory, the card against
     the CPU at 64 and 250 residues (TF32 off, max abs within 1e-3); then
     EQ's synthetic decoys written and their sequences embedded on the
     card through the datamodule (EQDataModule.prepare_embeddings) in
     place of their seeded cache, a decoy's node scalars its embedding;
 30. eq-data (before any CUDA graph, as eq-kernels; with GCPNET_REQUIRE_ESM=1,
     as eq-fit): the esm phase's EQ decoys (write_eq_decoys: 4 / 2 / 2
     natives of 100-700 residues with side chains, 8 noisy decoys each
     with a plDDT in the b-factor column; ESM-2's embeddings), each split's first pass (the
     lDDT labels made and the graphs cached), a shuffled training epoch's
     batches: host ms a batch, real nodes and edge rows against the
     bucket's 8,192 and 262,144;
 31. eq-kernels: K1, K2 and K3 at an EQ training batch (262,144 CSR rows
     into 8,192 nodes; the GCP3 stack) against their plain versions, fp32
     and bf16, with their times, bounds and shares of them;
 32. determinism (after rs-profile): two eager fp32 RS runs of 16 full-width
     steps without torch.use_deterministic_algorithms end with equal
     parameters, bit for bit;
 33. eq-check: one fp32 EQ training step on the card against the CPU (2
     layers, one decoy, no dropout), and the bf16 step's gradients against
     the fp32 step's on the card;
 34. eq-fit: the EQ path, the full-width EQ model (2 of its 5
     GCPInteractions2 layers, message attention, sums over senders) fitted
     by the Trainer in bf16 over float32 masters with the experiment's
     adaptive gradient clip and scan_chunk_size 4 for
     2 epochs with checkpoints, a resume to a third, and the best
     checkpoint's test: epoch seconds, train graphs/s, val and test RMSE
     and Pearson, peak memory; the deterministic parity run;
 35. eq-profile: one warm eager EQ step and one replay of a train and an
     eval chunk under torch.profiler (K1, K2, K3 a step, no scatter
     kernel); the eq-fit's checks.
 36. ar-data (before any CUDA graph, as ar-kernels): synthetic AR decoy
     and native pairs (write_ar_pairs: 16 / 4 / 4 pairs, training chains
     of 150-700 residues cropped to 250, evaluation chains of 100-380), each
     split's first pass, a shuffled training epoch's batches (the crops
     featurized anew, with the hybrid kNN graph of 128 + 2 x 12 rows an
     atom): host ms a batch to featurize, pack and sort, and to pin, real
     nodes and edge rows against the bucket's 4,096 and 622,592;
 37. ar-kernels: K1, K2 and K3 at an AR training batch (622,592 CSR rows
     into 4,096 nodes; the 4-layer GCP3 stack with silu on scalars and
     vectors and the vector gate, [E, 420] -> [E, 196]) against their
     plain versions, fp32 and bf16, with their times, bounds and shares of
     them, K2's and K3's tiles (K2's weight buffers) and their shared memory;
 38. ar-check: one fp32 AR training step on the card against the CPU (2
     layers, one pair, no dropout), and the bf16 step's gradients against
     the fp32 step's on the card;
 39. ar-fit: the AR path, the full-width AR model (2 of its 4
     GCPInteractions2 layers with the position update) fitted by the
     Trainer in bf16 over float32 masters with the experiment's adaptive
     gradient clip and scan_chunk_size 4 for 2
     epochs with checkpoints, a resume to a third, and the best
     checkpoint's test: epoch seconds, train graphs/s, val and test RMSE;
     the deterministic parity run;
 40. ar-profile: one warm eager AR step and one replay of a train and an
     eval chunk under torch.profiler (K1, K2, K3 a step, no scatter
     kernel), the host's ms a batch against the step's; the ar-fit's
     checks;
 41. ar-predict: the fitted model refines one decoy of 1,600 residues
     (two windows of the prediction path, in a bucket of 8,192 nodes that
     holds a window) through gcpnet_torch.predict.serve: the stitched refined
     PDB, its scores against the native, ms a decoy, the served window
     positions against an eager forward's;
 42. cfg-train: the config-driven entry point (gcpnet_torch.train's main,
     experiment=gcpnet_lba, the experiment's widths: 8 x 8 layers,
     100/16/32/4, bf16 over float32 masters, batch 16, the JAX bucket) on
     synthetic LBA records (write_lba_records: 160 / 64 / 64 pocket and
     ligand complexes of about 300-600 heavy atoms) for 2 epochs with
     checkpoints and the CSV logger, then the best checkpoint's test: the
     composed model against a directly built GCPNetLBA (parameter names
     and shapes), the wrappers' launches over the run, a replayed chunk's
     kernels (36 / 8 / 8 a step, no scatter kernel), train graphs/s, the
     captured step's busy ms, peak memory, the host's ms a batch;
 43. cfg-eval: gcpnet_torch.eval's main on cfg-train's checkpoints: its
     test/loss equal to cfg-train's bit for bit;
 44. cfg-predict: gcpnet_torch.predict's main with model=gcpnet_eq
     datamodule=eq on eq-fit's checkpoints and eq-data's test decoys: a
     b-factor-annotated PDB and a CSV row a decoy, the served per-residue
     lDDT against an eager fp32 forward (atol 1e-5);
 45. gcp-family: gcpnet_torch.train's main with
     experiment=gcpnet_lba_ablations at its full width (2 of its 8
     interaction layers, each of 8 message layers, bf16, the JAX bucket) on
     cfg-train's records, once with each of the frame,
     scalar and vector ablations, GCP v1 with the sigma frame gate and GCP2
     with the frame gate: 6 training batches (the first captured, 5
     replays) and the validation; the run's and a replay's launches (K1 only: the
     message stacks are plain, outside K2/K3's layer table), a replay's busy
     ms a step and idle share, peak memory; each setting holds in the
     trained model (an ablated channel is zeros; the frame-ablated model's
     prediction does not move with the atoms); one fp32 step of the
     frame-ablated model on the card against the CPU;
 45a. overrides: short fits (2 training batches and the validation)
     through gcpnet_torch.train's main at the experiments' widths and
     depths: PSR on psr-data's records under an edge budget
     (datamodule.max_units=262144: each batch in make_bucket's shape, its
     real rows within the budget), EQ's CA-only graphs of eq-data's decoys
     (datamodule.subset_to_ca_atoms_only=true), LBA on GCPInteractions2 on
     cfg-train's records and EQ on GCPInteractions (model.layer_class),
     each through K1-K3; the last two beside one fp32 step at 2 layers on
     the card against the CPU;
 45b. acts: every transcendental activation of K2/K3's layer table but
     AR's silu (selu, gelu, sigmoid, tanh), each as the scalar and as the
     vector activation, under both gates: K2 and K3 against their plain
     versions at the main path's shape (208,896 rows, LBA's 8-layer stack
     at 100/16/32/4) on four stacks, (gelu, sigmoid) and (selu, tanh) with
     the vector gate, (sigmoid, gelu) and (tanh, selu) with the norm gate,
     fp32 and bf16, at phase K2's and K3's bounds (bf16 K2 against the
     plain version in float32 on the same inputs, as K3's upcast check;
     float32 K3 under the kink rule: selu's derivative steps at 0), with
     their times, bounds and
     shares of them beside the card's name and power limit; then short fits
     through gcpnet_torch.train's main (experiment=gcpnet_lba with
     model.module_cfg.scalar_nonlinearity and vector_nonlinearity set to
     gelu / sigmoid and to selu / tanh, the experiment's widths and depth,
     bf16 over float32 masters, the JAX bucket) on cfg-train's records: 2
     training batches (the first captured, one replay) and the validation,
     a replay's K1 / K2 / K3 (36 / 8 / 8 a step), no scatter, its busy ms;
     each beside one fp32 step at 2 layers on the card against the CPU;
 46. rs-e3: the full-width RS model with enable_e3_equivariance in fp32:
     every mirrored pair of a synthetic test batch gets the same logit
     (the SE(3) model with the same weights tells pairs apart); a captured
     fit of 6 batches through gcpnet_torch.train's main with its test
     accuracy, launches, busy ms a step and idle share;
 47. ddp: data-parallel full-width LBA training (bf16 over float32
     masters) on a global batch of two LBA batches, one a shard, K1-K3
     counted from 0 around each run: NCCL world 1 in this process,
     captured, equal bit for bit to the same steps without a process
     group (its busy ms a replay, the all-reduce's ms); gloo world 2 on the
     one card (two processes from gcpnet_torch.parallel.launch), eager,
     against one process stepping on both shards with the all-reduce's
     arithmetic, and each rank's evaluation of its shard (the Trainer's
     eager eval over the group) against one process evaluating both; NCCL
     world 2 where the machine has two GPUs (reported, not run on one).
 48. remat: the full-width LBA main path (dropout 0.1) with remat False,
     True and "dots", captured in fp32 and bf16 and eagerly in fp32: with
     remat the fp32 losses, gradients and parameters equal those without
     (1e-6); each run's launches (the recompute runs K1 and K2 again) and
     peak memory; GCP v1 with the sigma frame gate at gcp-family's depth
     with and without remat: peaks (remat must lower it) and busy ms;
 49. dense: the LBA main path's graphs in the dense slot-major layout
     (degree 32: 229,376 rows; sender budget 64): its fp32 forward and step
     against the receiver-sorted ones (FORWARD_ATOL, TRAIN_CHECK_ATOL), a
     captured bf16 step profiled (K2/K3 on the slot rows, K1 on the sender
     side only, no scatter); an EQ step under GCPNET_EQ_DENSE=1 and an AR
     step under GCPNET_AR_DENSE=1 against their default layouts;
 50. scorers: EQ's labels through lddt_exec_path (a stand-in lddt
     executable printing the native per-residue lDDT) against the native
     labels, the graph cache keyed on the scorer; AMBER's find_violations
     of ar-predict's refined decoy, its clash check on the card in blocks,
     against the same check in numpy on the host.
Every profiled training step lists the scatter kernels it ran (none
allowed; a replay's read from its graph's kernel nodes).  Each phase prints
its seconds and the run's as it ends (``chip_smoke: phase <name> <s> s,
total <t> s``, flushed).  Then the seconds by phase, the total time, one JSON line with every kernel's numbers (at the NMS,
RS, PSR, CPD, EQ and AR shapes too), the nvidia-smi line, and the final status
line.  Any failed phase exits non-zero; without a CUDA device
the script exits non-zero before printing any result.  Full measurements go
to <out-dir>/chip_smoke.json (``--out-dir``, default logs/chip_smoke).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import csv
import dataclasses
import gc
import itertools
import json
import math
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from gcpnet_torch.data.ar import ARDataModule
from gcpnet_torch.data.ar_synthetic import write_ar_pairs, write_pair
from gcpnet_torch.data.atom3d import ATOM3DDataModule
from gcpnet_torch.data.batching import Bucket, batches_from_dataset, collate_shards, make_bucket
from gcpnet_torch.data.cath import CATHDataModule
from gcpnet_torch.data.cath_synthetic import write_cath_chains
from gcpnet_torch.data import esm as data_esm
from gcpnet_torch.data.eq import EQDataModule, featurize_decoy, structure_sequence
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.models.ar import ar_loss
from gcpnet_torch.models.cpd import GCPNetCPD, cpd_loss
from gcpnet_torch.models.cpd_eval import datum_recovery, evaluate_cpd
from gcpnet_torch.models.eq import eq_loss
from gcpnet_torch.models.lba import graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch import parallel
from gcpnet_torch.nn import esm as nn_esm
from gcpnet_torch.nn import message_passing
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops import build as kernel_build
from gcpnet_torch.ops.edge_map import (
    KINK_MARGIN,
    edge_map,
    edge_map_backward,
    edge_map_backward_plain,
    edge_map_plain,
    k2_layout,
    k3_tile,
    kink_margins,
    max_kink_rows,
)
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch import eval as eval_entry
from gcpnet_torch import predict as predict_entry
from gcpnet_torch import tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.data.pdb import parse_pdb
from gcpnet_torch.data import registry as datamodule_registry
from gcpnet_torch.data.registry import build_datamodule
from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.predict import (
    DTYPES, EDGE_SLACK, Predictor, build_model, lba_configs, predict, random_lba_graph, serve, synthetic_batches,
)
from gcpnet_torch.models.common import check_remat
from gcpnet_torch.utils.amber import violations as amber_violations
from gcpnet_torch.utils.structure_metrics import matched_lddt
from gcpnet_torch.train import entry as train_entry
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.train.cli import build_lba_training, build_task_trainer, task_configs
from gcpnet_torch.train.graphs import CapturedCall, TrainSteps
from gcpnet_torch.train.optim import build_optimizer, build_schedule
from gcpnet_torch.train.state import TrainState
from gcpnet_torch.train import step as step_module
from gcpnet_torch.train.step import eval_step, train_step
from gcpnet_torch.train.trainer import Trainer, prefetched

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
# the interaction layers each fit runs (its experiment's: NMS small_20body 4,
# RS 8, PSR 5, CPD 9 encoder and 3 decoder layers, EQ 5, AR 4): every kernel
# keeps its per-layer shape at full width, only its launches a step fall;
# the checks read the depth from the fitted model (model_layers)
FIT_LAYERS = {"nms": 2, "rs": 2, "psr": 2, "cpd": 3, "eq": 2, "ar": 2}
CPD_FIT_DECODERS = 1
FIT_LR = 1e-4  # the NMS and RS experiments' Adam rate
# kernel names by the count they belong to (KERNEL_COUNTS' order, K3 by its
# instantiation), as a graph's nodes give them (mangled) or demangled
KERNEL_NAMES = {
    "K1": ("seg_sum",), "K2": ("edge_map_tc_kernel",),
    "K3_bf16": ("edge_map_bwd_tc_kernelI13__nv_bfloat16", "edge_map_bwd_tc_kernel<__nv_bfloat16>"),
    "K3_fp32": ("edge_map_bwd_tc_kernelIf", "edge_map_bwd_tc_kernel<float>"),
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
# 8,192 nodes and 16,384 edge rows), on the synthetic splits of the JAX
# module's sizes but half its training graphs (RS_SPLITS: 4,096 / 512 / 512
# until the esm and ddp phases came), fitted for 3 of its up to 1,000
# epochs; rs-check cuts to 2 interaction layers for the CPU.
RS_SPLITS = {"train": 2048, "valid": 512, "test": 512}
RS_EPOCHS = 3
RS_CHECK_LAYERS = 2
# The PSR path: the experiment gcpnet_psr at its published widths and depth
# (hidden 100/16/32/4, 5 interaction layers of 8-layer message stacks,
# dropout 0.1, Adam at 1e-4, seed 42, batches of up to 16 decoys in the JAX
# bucket of 16,384 nodes and 524,288 edge rows, bf16 over float32 masters as
# its trainer's precision 16).  The ATOM3D archives are not on the card's
# machine: the records are synthetic, at protein size (write_psr_records),
# and cut to 40 / 8 / 8 targets of 16 decoys, far fewer than ATOM3D PSR's
# splits hold; the fit runs 1 of its up to 1,000 epochs and a resume for a
# second (2 and a third until the esm and ddp phases came); psr-check cuts
# to 2 interaction layers and 2 decoys.
PSR_TARGETS = {"train": 40, "val": 8, "test": 8}
PSR_DECOYS = 16
PSR_ATOMS = (400, 2000)  # heavy atoms of a native chain, uniform
PSR_DENSITY = 0.045  # heavy atoms per cubic angstrom the chain is folded to
PSR_NOISE = (0.3, 4.0)  # a decoy's noise scale in angstrom, log-uniform
PSR_BUCKET = (16384, 16384 * 32)
PSR_EPOCHS, PSR_RESUME_EPOCHS = 1, 2
PSR_CHECK_GRAPHS, PSR_CHECK_LAYERS, PSR_CHECK_NODES = 2, 2, 4096
# The CPD path: the experiment gcpnet_cpd at its published widths and depth
# (hidden 100/16/32/4, 9 encoder and 3 autoregressive decoder layers of
# 8-layer message stacks, dropout 0.2, Adam at 1e-4 with weight decay 1e-8,
# gradients accumulated over 4 batches, seed 42, batches of up to 8 chains
# in the JAX bucket of 2,048 nodes and 61,440 edge rows, bf16 over float32
# masters).  CATH 4.2 is not on the card's machine: the chains are
# synthetic, in its chain_set.jsonl format (write_cath_chains), cut to
# 600 / 100 / 100 chains of 40-500 residues (CATH 4.2's splits hold
# 18,024 / 608 / 1,120; 600, not 1,000, training chains keep the script's
# time with the config-driven phases; the chains come from one seeded
# stream, so fewer training chains would change the test chains the design
# samples); the fit runs 2 of its up to 1,000 epochs and a
# resume for a third; the design samples CPD_DESIGN_CHAINS of the 100 test
# chains, 100 sequences each at temperature 0.1 (the JAX protocol; the
# sampler runs eagerly, 17-20 ms a residue on one H100 80GB HBM3 at 700 W);
# cpd-check cuts to 2 encoder and 2 decoder layers and 2 chains in a bucket
# of 512 nodes.
CPD_CHAINS = {"train": 600, "validation": 100, "test": 100}
CPD_LENGTHS = (40, 500)  # residues, log-uniform
CPD_BUCKET = (2048, 2048 * 30)
CPD_EPOCHS, CPD_RESUME_EPOCHS = 2, 3
CPD_CHECK_GRAPHS, CPD_CHECK_LAYERS, CPD_CHECK_NODES = 2, 2, 512
CPD_DESIGN_CHAINS, CPD_SAMPLES, CPD_TEMPERATURE = 6, 100, 0.1
# the argmax samples (temperature 1e-6) of one chain, card against CPU:
# CPD_ARGMAX_SAMPLES copies of the shortest design chain
CPD_ARGMAX_SAMPLES = 4
# the share of those residues that must agree: the two sum in another order
# (the card's index_add_ atomics), so a position whose two best logits lie
# within float32 rounding of each other may go either way, and the later
# positions read it
CPD_ARGMAX_EQUAL_SHARE = 0.99
# the best checkpoint's val/loss evaluated again against the value logged
# for it: the same weights and batches through the same kernels, but the
# node-frame means sum with index_add_, whose atomics on the card add in
# another order each run (float32: a few roundings of 2^-24 relative)
NMS_VAL_RTOL = 1e-5
# The EQ path: the experiment gcpnet_eq at its published widths and depth
# (1,281 node scalars, ESM-2 and plDDT, and 38 atom types; 18 edge scalars;
# hidden 100/16/32/4; 5 GCPInteractions2 layers of 8-layer GCP3 message
# stacks with scalar message attention and sums over senders; dropout 0.1;
# Adam at 1e-4 without weight decay; seed 42; one decoy a batch in the JAX
# bucket of 8,192 nodes, 262,144 edge rows and 1,100 residues; bf16 over
# float32 masters).  No EQ decoys and no ESM-2 checkpoint are on the card's
# machine: the decoy/native pairs are synthetic (write_eq_decoys: natives
# of 100-700 residues, about 8.5 heavy atoms each, decoys with 0.3-4 A of
# noise), their node scalars the embeddings of ESM-2 650M with random
# weights (the esm phase), cut to 4 / 2 / 2 targets of 8
# decoys; the fit runs 2 of its up to 1,000 epochs and a resume for a
# third; eq-check cuts to 2 layers and one decoy of 60-100 residues in a
# bucket of 1,024 nodes and 128 residues.
EQ_TARGETS = {"train": 4, "valid": 2, "test": 2}
EQ_DECOYS = 8
EQ_RESIDUES = (100, 700)
EQ_BUCKET, EQ_MAX_RESIDUES = (8192, 8192 * 32), 1100
EQ_EPOCHS, EQ_RESUME_EPOCHS = 2, 3
EQ_CHECK_LAYERS, EQ_CHECK_NODES, EQ_CHECK_RESIDUES = 2, 1024, 128
# AR (configs/model/gcpnet_ar.yaml, the experiment gcpnet_ar): GCP3 with
# silu on scalars and vectors and the vector gate (1,338 node scalars:
# residue and atom-name one-hots and ESM-2; 29 edge scalars; hidden
# 100/32/16/4; 4 GCPInteractions2 layers of 4-layer message stacks with
# scalar message attention, sums over senders and the position update;
# dropout 0; Adam at 1e-4 without a scheduler; seed 42; one decoy a batch
# in the JAX bucket of 4,096 nodes, 622,592 edge rows (k_max 128 + 2 x
# k_min 12 an atom) and 600 residues; a 250-residue training crop; bf16
# over float32 masters).  No AF2 decoys, natives or AR split lists and no
# ESM-2 checkpoint are on the card's machine: the pairs are synthetic
# (write_ar_pairs: natives of ideal backbones with side chains, about 8.5
# heavy atoms a residue, decoys with 0.5-3 A of smooth noise, a seeded ESM
# cache file a sequence), cut to 16 / 4 / 4 pairs; the fit runs 2 of its
# up to 1,000 epochs and a resume for a third; ar-check cuts to 2 layers
# and one pair of 60-100 residues in a bucket of 1,024 nodes; ar-predict
# refines one decoy of AR_PREDICT_RESIDUES residues (over the JAX module's
# 1,500-residue split, so two windows) in a bucket of 8,192 nodes, which
# holds a 900-residue window (~7,650 atoms; the training bucket's 4,096
# does not).
AR_PAIRS = {"train": 16, "valid": 4, "test": 4}
AR_BUCKET, AR_MAX_RESIDUES = (4096, 4096 * 152), 600
AR_EPOCHS, AR_RESUME_EPOCHS = 2, 3
AR_CHECK_LAYERS, AR_CHECK_NODES, AR_CHECK_RESIDUES = 2, 1024, 128
AR_PREDICT_RESIDUES, AR_PREDICT_NODES, AR_PREDICT_MAX_RESIDUES = 1600, 8192, 1000
# the config-driven entry points (cfg-train, cfg-eval, cfg-predict):
# experiment=gcpnet_lba at its own widths (100/16/32/4, 8 x 8 layers, bf16,
# batch 16, the JAX bucket) on synthetic LBA records; cut to a few hundred
# complexes (320 training complexes until the esm and ddp phases came) and
# CFG_EPOCHS epochs
LBA_COMPLEXES = {"train": 160, "val": 64, "test": 64}
LBA_POCKET_ATOMS = (300, 560)  # heavy atoms of a pocket before the ligand's cavity is cut out, uniform
LBA_LIGAND_ATOMS = (20, 40)
CFG_EPOCHS = 2
# served per-residue lDDT of cfg-predict against an eager fp32 forward of the same weights
CFG_PREDICT_ATOL = 1e-5
# determinism: two eager fp32 RS runs of this many steps, without
# torch.use_deterministic_algorithms, must end with equal parameters
# The rest of the GCP family (gcp-family): experiment=gcpnet_lba_ablations
# with each setting, one epoch of GCP_FAMILY_STEPS training batches each
GCP_FAMILY_RUNS = {
    "ablate_frame_updates": ["model.module_cfg.ablate_frame_updates=true"],
    "ablate_scalars": ["model.module_cfg.ablate_scalars=true"],
    "ablate_vectors": ["model.module_cfg.ablate_vectors=true"],
    "gcp1_sigma_frame_gate": ["model.module_cfg.selected_GCP._target_=gcpnet_tpu.nn.gcp.GCP",
                              "model.module_cfg.sigma_frame_gate=true", "model.module_cfg.vector_gate=false"],
    "gcp2_frame_gate": ["model.module_cfg.frame_gate=true", "model.module_cfg.vector_gate=false"],
}
GCP_FAMILY_CLASSES = ("GCP", "GCP2", "GCP3")
# one batch a replay: reading a replay's trace back in Python takes about
# 0.15 s a thousand kernels, and a plain-stack step runs 10,000-40,000
FAMILY_CHUNK = 1
GCP_FAMILY_STEPS = 6  # the first runs eagerly and captures, the rest replay
GCP_FAMILY_CHECK_LAYERS = 2
GCP_FAMILY_LAYERS = 2  # interaction layers of each run (the experiment's 8), each of 8 message layers
# E(3) RS (rs-e3): a pair's logits agree within RS_PAIR_ATOL of the pair's
# magnitude (at least 1); the fit's training batches
RS_PAIR_ATOL = 1e-4
RS_E3_STEPS = 6
DETERMINISM_STEPS = 16
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


def queued_ms(fn, calls: int = 100, tries: int = 3) -> float:
    """Device time of ``fn`` per call, for calls as short as the host's
    launch of them: ``calls`` calls queued behind a spin kernel that keeps
    the card busy until the host has launched them all, so that they run
    back to back, timed by CUDA events around them (the median of
    ``tries``).  The time includes the card's gap between consecutive
    kernels.  (K1's earlier times were the kernels' own durations under
    torch.profiler, device_ms; in one process the profiler's traces of
    such windows lost kernels, and from about the 40th window whole
    windows, on one H100 80GB HBM3.)  The spin is doubled until it
    outlasts the launches; ``fn`` must not wait for the card."""
    fn()
    torch.cuda.synchronize()
    spin = 50_000_000  # cycles, ~30 ms
    times = []
    while len(times) < tries:
        if spin > 2**33:
            raise PhaseError("queued_ms: the calls did not fit behind the spin (does fn wait for the card?)")
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms >= 0.8 * before.elapsed_time(start):
            spin *= 2
            continue
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


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


class WrittenAhead:
    """The synthetic data sets, written on one host thread while the kernels
    build (phase_build waits on nvcc): ``start(key, write, ...)`` begins a
    write, ``take(key)`` waits for it and gives ``(what it returned, its
    seconds)``.  Each write draws from its own seeded generator, so the data
    are those the phase would write itself."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="chip_smoke_write")
        self._futures = {}

    def start(self, key: str, write, *args, **kw) -> None:
        def timed():
            t0 = time.perf_counter()
            return write(*args, **kw), time.perf_counter() - t0

        self._futures[key] = self._pool.submit(timed)

    def take(self, key: str) -> tuple:
        return self._futures.pop(key).result()

    def close(self) -> None:
        """Wait for the writes still running (their directories are removed next)."""
        self._pool.shutdown(wait=True, cancel_futures=True)


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


# The layer body each dtype's K2 and K3 run.
BODY = {
    torch.bfloat16: "mma.sync m16n8k16, ldmatrix, cp.async (csrc/edge_stack_mma.cuh)",
    torch.float32: "mma.sync m16n8k8, split TF32 (csrc/edge_stack_mma.cuh)",
}


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
            lib_a, k_a, k_b, lib_b = (queued_ms(fn) for fn in (library, kernel, kernel, library))
            results[f"tile{tile}_{dname}"] = {
                "max_abs_err": err,
                "ms": (k_a + k_b) / 2,
                # the plain version reads the valid rows' count back
                # (boolean indexing): CUDA events around its calls
                "plain_ms": cuda_ms(lambda: segment_sum_sorted_plain(next(copies), splits, n)),
                "library_ms": (lib_a + lib_b) / 2,
                "ms_turns": [lib_a, k_a, k_b, lib_b],
                "timed_copies": copies.count,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "shape": [batch.num_edges, d_out, n],
                "rows_summed": rows,
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
        rows, _, smem = k2_layout(stack, dtype)
        results[dname] = {
            "body": BODY[dtype],
            "tile_rows": rows,
            "smem_bytes": smem,
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
    version's by more than 1e-4 of scale, checked to be kinks (relu, leaky
    relu or selu): each with a kink margin under KINK_MARGIN in the float64
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
        rows, smem = k3_tile(stack, dtype)
        results[dname] = {
            "body": BODY[dtype],
            "tile_rows": rows,
            "smem_bytes": smem,
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
    the capture's; phase_profile reads a replay's kernels from its graph);
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
                k1 = k1_steps("lba", 8)[1]
                want = (k1, 8) if mode == "eager" else (2 * k1, 16) if i == 0 else (0, 0)
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


# K1 launches a model runs outside its interaction layers, in the forward:
# the centring's graph mean, the embedding's node frames, and the head's
# node frames and pool (LBA, PSR, RS: the graph pool; EQ: the residue
# mean; CPD: node frames alone; NMS and AR: no head)
K1_FIXED = {"lba": 4, "psr": 4, "rs": 4, "eq": 4, "nms": 2, "cpd": 3, "ar": 2}


def k1_steps(task: str, layers: int, decoders: int = 0) -> tuple:
    """K1 launches ``(a training step, an evaluation step)`` of a task's
    model with ``layers`` interaction layers (CPD: encoder layers, and
    ``decoders`` autoregressive decoder layers).  The forward: K1_FIXED,
    and each layer's sum or mean of its messages and its feed-forward's
    node frames (a decoder layer: its sum alone); the backward: each
    layer's two gathers of node rows (senders, receivers; a decoder
    layer's four, as it gathers two reps) and CPD's gather of the
    sequence embedding, each K1 over the cotangent rows.  Every other
    backward of a sum is a gather."""
    forward = K1_FIXED[task] + 2 * layers + decoders
    backward = 2 * layers + 4 * decoders + (1 if task == "cpd" else 0)
    return forward + backward, forward


def model_layers(model) -> int:
    """The interaction layers a task model runs (CPD: its encoder's)."""
    return model.num_encoder_layers if isinstance(model, GCPNetCPD) else model.encoder.num_layers


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
    eager step and one replay under torch.profiler (the eager step's
    kernels as the wrappers count them, the replay's read from its graph's
    kernel nodes: profile_eager, profile_replay)."""
    name = "train" if dtype == torch.bfloat16 else "train-fp32"
    k1 = k1_steps("lba", 8)[0]
    want = (k1, 8, 8, 0) if dtype == torch.bfloat16 else (k1, 8, 0, 8)
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
    kernels = dict(zip(KERNEL_COUNTS, want))
    results["profile"] = profile_eager(lambda: train_step(emodel, estate, dev_batch, graph_regression_loss, egen))
    results["profile_captured"] = profile_replay(lambda: steps([pinned]), steps.call, [pinned])
    print(f"phase {name}: " + json.dumps(results), flush=True)
    for key, limit in bound.items():
        check(apart[key] <= limit, f"{name}: captured vs eager {key} {apart[key]:.3g} > {limit:.3g}")
    check_param_gap(f"{name} captured vs eager", gap["captured"])
    check(not results["nan_replay"]["ok"] and not changed and results["nan_replay"]["replays"] == TRAIN_STEPS,
          f"{name}: the NaN replay {results['nan_replay']}")
    for prof in (results["profile"], results["profile_captured"]):
        check(prof["launches"] == kernels, f"{name}: profiled kernels {prof['launches']}, want {kernels}")
        check(not prof["scatters"], f"{name}: scatter kernels in the step {prof['scatters']}")
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


def adam_sign_flips(grads_a: torch.Tensor, grads_b: torch.Tensor, bound: float) -> torch.Tensor:
    """The entries whose two gradients have opposite signs while both lie
    within ``bound`` of 0.  Adam's first step moves an entry by lr * g /
    (|g| + eps), about lr * sign(g), so two gradients that agree within
    their bound can still move such an entry up to 2 lr apart."""
    return (torch.sign(grads_a) != torch.sign(grads_b)) & (grads_a.abs() <= bound) & (grads_b.abs() <= bound)


def card_vs_cpu_step(
    name: str, build, batch, loss_fn, layers: int, rounding_draws: int = 0, params_by_share: bool = False,
    fp32_k3: Optional[int] = None, sign_flips: bool = False,
) -> dict:
    """One float32 training step on the card against the same step on the
    CPU (plain versions): ``build(device) -> (model, state)`` gives both the
    same weights; the same host ``batch``, no dropout.  Held to
    TRAIN_CHECK_ATOL; the card's step launches the fp32 K3 once a layer.
    With ``rounding_draws``, the gradients and updated parameters may also
    part as far as ROUNDING_SPREAD_FACTOR times the CPU step parts from
    itself under a float32 rounding's worth of weight noise (the largest of
    that many draws): for a step whose gradient float32 rounding alone
    moves by more than TRAIN_CHECK_ATOL.  With ``params_by_share`` the
    updated parameters are held by the share of entries apart alone (the
    largest distance is printed, not held: see phase_cpd_check).  ``fp32_k3``
    is the fp32 K3 launches the step must make where not one a layer (a
    model whose message stacks are plain: 0).  With ``sign_flips`` the
    updated parameters are held to TRAIN_CHECK_ATOL["params"] except the
    entries of :func:`adam_sign_flips` at the gradient bound (the norm
    check's bound times the CPU gradient's norm: no entry may part by
    more); those are counted and printed."""
    want_k3 = layers if fp32_k3 is None else fp32_k3
    reset_counts()
    card = _step_outcome(build, "cuda", batch, loss_fn)
    card_k3 = launch_counts()[3]
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
        "launches": {"K3_fp32": card_k3},
    }
    bound = {k: TRAIN_CHECK_ATOL[k] for k in ("grads_norm_rel", "params", "params_share_above_1e-6")}
    held = param_diff
    if sign_flips:
        grad_bound = TRAIN_CHECK_ATOL["grads_norm_rel"] * cpu["grads"].norm().item()
        flips = adam_sign_flips(card["grads"], cpu["grads"], grad_bound)
        held = param_diff[~flips]
        results["sign_flips"] = {
            "grad_bound": grad_bound, "count": int(flips.sum()),
            "params_max_abs_diff_flipped": param_diff[flips].max().item() if flips.any() else 0.0,
            "params_max_abs_diff_others": held.max().item() if held.numel() else 0.0,
        }
    if rounding_draws:
        draws = [_step_diffs(cpu, _step_outcome(build, "cpu", batch, loss_fn, noise_seed=i))
                 for i in range(rounding_draws)]
        spread = {k: max(d[k] for d in draws) for k in bound}
        results["cpu_rounding_spread"] = spread
        bound = {k: max(v, ROUNDING_SPREAD_FACTOR * spread[k]) for k, v in bound.items()}
        results["bound"] = bound
    print(f"phase {name}: " + json.dumps(results), flush=True)
    check(card_k3 == want_k3, f"{name}: fp32 K3 launches {card_k3}, want {want_k3}")
    check(results["loss_abs_diff"] <= TRAIN_CHECK_ATOL["loss"], f"{name}: loss differs")
    check(results["grad_norm_abs_diff"] <= TRAIN_CHECK_ATOL["grad_norm"], f"{name}: grad norm differs")
    check(results["grads_norm_rel_err"] <= bound["grads_norm_rel"], f"{name}: gradients differ")
    if not params_by_share:
        check((held.max().item() if held.numel() else 0.0) <= bound["params"], f"{name}: parameters differ")
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


# kernels that add rows into other rows by an index, by name: index_add_
# (indexFunc*), the backward of indexing (index_put_ with accumulate,
# indexing_backward) and of embedding lookups, scatter_add and the
# scatter/gather kernel.  Their float additions meet in an order that
# changes from run to run; the port's training steps run none (the
# "scatters" of profile_eager and profile_replay).
SCATTER_NAMES = ("indexFuncSmallIndex", "indexFuncLargeIndex", "index_add", "indexing_backward", "scatter_add",
                 "_scatter_gather_elementwise", "embedding_backward", "compute_grad_weight")


PROFILED = "chip_smoke.profiled"  # the range device_profile gives fn


def device_profile(fn) -> dict:
    """Run ``fn`` once under torch.profiler: wall time, device busy time
    (the sum of the CUDA kernels' times; one stream, so they do not
    overlap), idle share, time by kernel, the scatter kernels the trace
    holds by name (SCATTER_NAMES), and the host's calls into the CUDA
    runtime and driver.  The trace can miss a kernel now and then (on one
    H100 80GB HBM3: a K1 in some windows), so kernel counts are not read
    from it (profile_eager, profile_replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(PROFILED):
            fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # user annotations (``Optimizer.step#Adam.step``) also appear on the
    # device's timeline, as ranges over the kernels they launched: not work
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    # the host's calls into the CUDA runtime and driver (cudaLaunchKernel,
    # cudaGraphLaunch, cudaMemcpyAsync, ...) within fn's range: what the
    # host pays per call
    window = next(e.time_range for e in prof.events() if e.device_type == DeviceType.CPU and e.name == PROFILED)
    api = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CPU and e.name.startswith(("cuda", "cu"))
                and window.start <= e.time_range.start <= window.end):
            api[e.name] = api.get(e.name, 0) + 1
    by_name, by_count = {}, {}
    for e in kernels:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0][:80]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
        by_count[name] = by_count.get(name, 0) + 1
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
        "scatters": _scatters(by_count),
        "cuda_api_calls": sum(api.values()),
        "cuda_api_by_name": api,
        "share": {
            label: sum(v for k, v in by_name.items() if any(key in k for key in keys)) / busy_us
            if kernels else "not measured"
            for label, keys in labels
        },
        "top_ms": [[k, v / 1e3] for k, v in top],
    }


def _scatters(by_count: dict) -> dict:
    return {k: by_count[k] for k in sorted(by_count) if any(key in k for key in SCATTER_NAMES)}


def profile_eager(fn) -> dict:
    """device_profile of an eager ``fn``, its ``launches`` of K1, K2 and K3
    as the wrappers count them (every count set to 0 just before)."""
    reset_counts()
    prof = device_profile(fn)
    prof["launches"] = dict(zip(KERNEL_COUNTS, launch_counts()))
    return prof


def launches_by_name(names: dict) -> dict:
    """K1-K3 launches (KERNEL_COUNTS) among kernels counted by name."""
    return {label: sum(n for name, n in names.items() if any(key in name for key in keys))
            for label, keys in KERNEL_NAMES.items()}


def profile_replay(fn, call, batches) -> dict:
    """device_profile of ``fn``, one replay of ``call``'s graph for
    ``batches`` (a CapturedCall captured with ``keep_graphs``), with what
    the replay launches read from the graph's kernel nodes, which no trace
    can drop: ``launches`` of K1, K2 and K3, and ``scatters`` (beside the
    trace's, ``traced_scatters``)."""
    prof = device_profile(fn)
    names = call.kernel_names(batches)
    prof["launches"] = launches_by_name(names)
    prof["traced_scatters"], prof["scatters"] = prof["scatters"], _scatters(names)
    prof["graph_kernel_nodes"] = sum(names.values())
    return prof


def phase_profile(batches) -> dict:
    """Where the time goes in prediction: one warm bf16 full-width forward,
    eager and replayed, each under torch.profiler (the training steps are
    profiled in their phases)."""
    model = build_model(SEED, "cuda", torch.bfloat16)
    predictor = Predictor(model)
    predict(model, batches[0])
    predictor(batches[0])
    kernels = {"K1": k1_steps("lba", 8)[1], "K2": 8, "K3_bf16": 0, "K3_fp32": 0}
    result = {
        "forward": profile_eager(lambda: predict(model, batches[1])),
        "forward_captured": profile_replay(lambda: predictor(batches[1]), predictor.graphs,
                                           [batches[1].pinned(torch.bfloat16)]),
    }
    print("phase profile: ok " + json.dumps(result))
    for key, prof in result.items():
        check(prof["launches"] == kernels, f"profile {key}: kernels {prof['launches']}")
    return result


def nms_message_passing() -> GCPMessagePassing:
    """One message passing layer of the NMS model (8 GCP2 layers, hidden
    64/16, edges 32/4), random weights from the seed."""
    model_cfg, module_cfg, layer_cfg = task_configs("nms")
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
            *task_configs("nms", NMS_CHECK_LAYERS, dropout=0.0), generator=torch.Generator().manual_seed(SEED), device=dev
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


class EpochBatches:
    """A datamodule whose training batches are counted by the epoch (the
    seed) that asked for them; everything else is the datamodule's."""

    def __init__(self, dm):
        self.dm, self.counts = dm, {}

    def __getattr__(self, name):
        return getattr(self.dm, name)

    def train_batches(self, seed: int = 0):
        self.counts.setdefault(seed, 0)
        for batch in self.dm.train_batches(seed=seed):
            self.counts[seed] += 1
            yield batch


def resumed_step(steps: int, counted: EpochBatches, epochs: int, resume_epochs: int) -> int:
    """The step a fit that stood at ``steps`` after ``epochs`` epochs must
    reach when resumed to ``resume_epochs``: one step a training batch of
    each resumed epoch, counted from that epoch's own batches (a packed
    epoch's batch count varies with its shuffle)."""
    missing = [e for e in range(epochs, resume_epochs) if e not in counted.counts]
    if missing:
        raise PhaseError(f"the resumed fit asked for no training batches of epochs {missing}")
    return steps + sum(counted.counts[e] for e in range(epochs, resume_epochs))


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
        captured = build(max_epochs=1, scan_chunk_size=FIT_CHUNK, limit_train_batches=FIT_PARITY_STEPS)
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


def _fit_checks(name: str, results: dict, layers: int, first_epoch: dict, k1: tuple, k3: str = "K3_fp32",
                parity_run: bool = True) -> None:
    """What every captured fit must show: the wrappers counted the kernels
    of each graph's first call only (its eager run and the capture's
    records: twice a training step's K1 launches and a layer's K2 and K3
    launches for each training batch captured, an evaluation step's K1 and
    a layer's K2 for each evaluation batch), so every other chunk ran as a
    replay; the replays of a train chunk and an eval chunk (their graphs'
    kernel nodes) run K1 ``k1`` (``(a training step's, an evaluation
    step's)``: k1_steps) times a step and K2 and K3 once a layer a step (K3
    not in evaluation), as the profiled eager step does (its wrappers'
    counts), and no scatter kernel in training; the
    parity run's captured steps equal its eager ones bit for bit
    (fit_parity), with replays among them (``parity_run=False``: a fit
    without a parity run, cfg-train's); the first epoch's losses are
    the eager epoch's within FIT_EAGER_RTOL[name] where the fit ran one
    (``first_epoch``).  ``k3`` is the K3 of the fit's precision (the other
    counts none)."""
    g = results["graphs"]
    train, evals = 2 * g["train_captured_batches"], 2 * g["eval_captured_batches"]
    k1_train, k1_eval = k1

    def k3s(n):
        return {"K3_bf16": 0, "K3_fp32": 0, k3: n}

    want = {"K1": k1_train * train + k1_eval * evals, "K2": layers * (train + evals), **k3s(layers * train)}
    check(results["launches"] == want, f"{name}: launches {results['launches']}, want {want} (graphs {g})")
    profiled = {
        "profile": {"K1": k1_train, "K2": layers, **k3s(layers)},
        "profile_captured": {"K1": k1_train * FIT_CHUNK, "K2": layers * FIT_CHUNK, **k3s(layers * FIT_CHUNK)},
        "profile_eval_captured": {"K1": k1_eval * FIT_CHUNK, "K2": layers * FIT_CHUNK, **k3s(0)},
    }
    for key, want in profiled.items():
        check(results[key]["launches"] == want, f"{name}: {key} launches {results[key]['launches']}, want {want}")
    for key in ("profile", "profile_captured"):
        check(not results[key]["scatters"], f"{name}: scatter kernels in {key}: {results[key]['scatters']}")
    if parity_run:
        parity = results["parity"]
        check(parity["params_equal"] and parity["generator_equal"] and parity["train_loss"][0] == parity["train_loss"][1]
              and len(set(parity["val_loss"])) == 1 and parity["train_replays"] > 0
              and parity["eval_replays"] > 0 and parity["steps"] == FIT_PARITY_STEPS,
              f"{name}: deterministic parity, captured vs eager: {parity}")
    if first_epoch is None:
        return
    eager = results["eager_epoch"]
    for k in ("train/loss", "val/loss"):
        rel = abs(first_epoch[k] - eager[k]) / abs(eager[k])
        check(rel <= FIT_EAGER_RTOL[name], f"{name}: epoch 0 {k} {first_epoch[k]} captured, {eager[k]} eager")


def _fit_record(trainer, clock: EpochClock, eager, lr: float) -> dict:
    """A captured fit's kernel counts (read by the caller), its graphs (those
    captured, and those its CapturedCalls hold now), and, where an eager
    first epoch ran (``eager``), its first epoch's parameters against it."""
    train, evals = trainer.train_graphs.call, trainer.eval_graphs.call
    record = {
        "graphs": {
            "train_captures": train.captures, "train_captured_batches": train.captured_batches,
            "train_replays": train.replays, "train_held": train.num_graphs, "eval_captures": evals.captures,
            "eval_captured_batches": evals.captured_batches, "eval_replays": evals.replays,
            "eval_held": evals.num_graphs,
        },
    }
    if eager is not None:
        eager = dict(eager)
        start, params = eager.pop("start"), eager.pop("params")
        record["eager_epoch"] = eager
        record["param_gap"] = param_gap(clock.first_params, params, start, lr, eager["steps"])
    return record


def _profile_steps(trainer, dm, loss_fn, layers: int, k1: tuple) -> dict:
    """One warm eager training step, and one replay each of the trainer's
    captured train chunk and eval chunk (FIT_CHUNK batches of the fit's
    shapes), each under torch.profiler (profile_eager: the kernels as the
    wrappers count them; profile_replay: as the graph's kernel nodes hold
    them)."""
    train = [b.pinned() for b in itertools.islice(dm.train_batches(seed=0), FIT_CHUNK)]
    val = [b.pinned() for b in itertools.islice(dm.val_batches(), FIT_CHUNK)]
    dev_batch = next(dm.train_batches(seed=0)).to(torch.device("cuda"))
    eager = lambda: train_step(trainer.model, trainer.state, dev_batch, loss_fn, trainer.generator)  # noqa: E731
    replay = lambda: trainer.train_graphs(train)  # noqa: E731
    replay_eval = lambda: trainer.eval_graphs(val)  # noqa: E731
    for fn in (eager, replay, replay_eval):  # warm, and captured where the graphs were dropped
        fn()
    return {
        "chunk_steps": FIT_CHUNK,
        "profile": profile_eager(eager),
        "profile_captured": profile_replay(replay, trainer.train_graphs.call, train),
        "profile_eval_captured": profile_replay(replay_eval, trainer.eval_graphs.call, val),
    }


def phase_nms_fit(dm, ckpt_dir: str) -> dict:
    """The NMS path: the full-width NMS model at FIT_LAYERS["nms"] layers with the experiment's defaults
    (fp32, dropout 0.1, Adam at 1e-4) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK (each full chunk of training or validation
    batches one replay of a CUDA graph) for NMS_EPOCHS epochs with
    checkpoints; a new Trainer resumes from the last checkpoint to epoch
    NMS_RESUME_EPOCHS and tests the best checkpoint; beside it the first
    epoch of the same fit run eagerly (_eager_epoch); then one warm eager
    step and one replay of a train and an eval chunk under torch.profiler
    (_profile_steps).  Every kernel count is set to 0 just before the fit
    and read just after it (_fit_checks)."""
    build = lambda seed=SEED, **kw: build_task_trainer(  # noqa: E731
        "nms", seed, "cuda", num_encoder_layers=FIT_LAYERS["nms"], lr=FIT_LR, precision=32, **kw)
    eager = _eager_epoch(build, dm, nms_loss, NMS_BATCH)
    parity = fit_parity(build, dm, nms_loss)
    clock = EpochClock()
    trainer = build(max_epochs=NMS_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    layers = model_layers(trainer.model)
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
    counted = EpochBatches(dm)
    resumed.fit(counted, resume=True)
    final_step = resumed.state.step  # before the best checkpoint's state replaces it
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
        "final_step": final_step,
    })
    check(results["final_step"] == resumed_step(steps, counted, NMS_EPOCHS, NMS_RESUME_EPOCHS),
          f"nms-fit: resumed steps, {results['final_step']} after {steps} and {counted.counts}")
    results.update(_profile_steps(resumed, dm, nms_loss, layers, k1_steps("nms", layers)))
    print("phase nms-fit: " + json.dumps(results), flush=True)

    wanted = ("train/loss", "val/loss", "val/RMSE", "val/CosineSimilarity")
    for line in epochs:
        check(all(k in line and math.isfinite(line[k]) for k in wanted), f"nms-fit: epoch line {line}")
    check(all(k in test and math.isfinite(test[k]) for k in ("test/loss", "test/RMSE", "test/CosineSimilarity")),
          f"nms-fit: test metrics {test}")
    check([line["epoch"] for line in epochs] == list(range(NMS_RESUME_EPOCHS)), "nms-fit: epochs run")
    _fit_checks("nms-fit", results, layers, epochs[0], k1_steps("nms", layers))
    check(results["resumed_step"] == steps and same, "nms-fit: the resumed state is not the saved one")
    check(abs(again - logged) <= NMS_VAL_RTOL * abs(logged),
          f"nms-fit: best checkpoint's val/loss {again} against {logged} logged")
    print("phase nms-fit: ok")
    return results


def rs_message_passing() -> GCPMessagePassing:
    """One message passing layer of the RS model (8 GCP2 layers with leaky
    relu, hidden 100/16, edges 32/4: LBA's widths), random weights from the
    seed."""
    model_cfg, module_cfg, layer_cfg = task_configs("rs")
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
    dm = RSDataModule(seed=42, synthetic_sizes=RS_SPLITS)
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
    check(results["graphs"] == RS_SPLITS, f"rs-data: splits {results['graphs']}")
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
            *task_configs("rs", RS_CHECK_LAYERS, dropout=0.0), generator=torch.Generator().manual_seed(SEED), device=dev
        )
        return model, TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}))

    return card_vs_cpu_step("rs-check", build, next(dm.train_batches(seed=0)), rs_loss, RS_CHECK_LAYERS,
                            rounding_draws=RS_ROUNDING_DRAWS)


def phase_rs_fit(dm, ckpt_dir: str):
    """The RS path: the full-width RS model at FIT_LAYERS["rs"] layers with the experiment's defaults
    (fp32, dropout 0.1, Adam at 1e-4, seed 42) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK for RS_EPOCHS epochs with checkpoints, then
    the best checkpoint's test; beside it the first epoch of the same fit
    run eagerly (_eager_epoch).  Every kernel count is set to 0 just before
    the fit and read just after; rs-profile checks them (_fit_checks)."""
    build = lambda **kw: build_task_trainer(  # noqa: E731
        "rs", 42, "cuda", num_encoder_layers=FIT_LAYERS["rs"], lr=FIT_LR, precision=32, **kw)
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
    layers = model_layers(trainer.model)
    results = _profile_steps(trainer, dm, rs_loss, layers, k1_steps("rs", layers))
    print("phase rs-profile: " + json.dumps(results), flush=True)
    _fit_checks("rs-fit", {**fit, **results}, layers, fit["epochs"][0], k1_steps("rs", layers))
    print("phase rs-profile: ok")
    return results


def _native_chains(rng: np.random.Generator, sizes) -> list:
    """Native chains of ``sizes`` heavy atoms: random walks of 1.5 A steps
    whose direction turns a little each step and is pulled back inside a
    sphere that holds the chain at PSR_DENSITY, so that an atom has about
    20-30 others within 4.5 A (protein-like packing), all walks at once."""
    sizes = np.asarray(sizes)
    radius = (3 * sizes / (4 * np.pi * PSR_DENSITY)) ** (1 / 3)
    x = np.zeros((len(sizes), sizes.max(), 3))
    pos = np.zeros((len(sizes), 3))
    direction = rng.normal(size=(len(sizes), 3))
    for i in range(1, sizes.max()):
        direction = direction / np.linalg.norm(direction, axis=1, keepdims=True) + 0.4 * rng.normal(size=pos.shape)
        r = np.linalg.norm(pos, axis=1, keepdims=True)
        direction = np.where(r > 0.9 * radius[:, None], direction - 3.0 * pos / np.maximum(r, 1e-9), direction)
        pos = pos + 1.5 * direction / np.linalg.norm(direction, axis=1, keepdims=True)
        x[:, i] = pos
    return [x[k, :n] for k, n in enumerate(sizes)]


def gdt_ts(decoy: np.ndarray, native: np.ndarray) -> float:
    """A GDT-TS-like score (no superposition: the decoys are not moved):
    the mean over 1, 2, 4 and 8 A of the share of atoms that far from
    their native place or nearer."""
    dist = np.linalg.norm(decoy - native, axis=1)
    return float(np.mean([(dist <= t).mean() for t in (1.0, 2.0, 4.0, 8.0)]))


LDDT_STUB = """#!{python}
# A stand-in for the lddt binary: prints its per-residue table (a header,
# then one line a residue after the first line that starts with "Chain",
# the score in the fifth column) of the scores {scores!r} holds for the
# decoy's file name.
import json, os, sys
scores = json.load(open({scores!r}))[os.path.basename(sys.argv[1])]
print("lddt (stand-in)")
print("Global LDDT score: %.6f" % (sum(scores) / max(len(scores), 1)))
print("Chain\tResName\tResNum\tAsses.\tScore\t(Conserved/Total, over 4 thresholds)")
for i, score in enumerate(scores):
    print("A\tUNK\t%d\tYes\t%.6f\t(0/0)" % (i + 1, score))
{log}"""


def write_lddt_stub(path: str, scores: dict, log: Optional[str] = None) -> str:
    """An executable at ``path`` that prints the lddt binary's per-residue
    table for a decoy (its first argument) from ``scores`` (file name ->
    per-residue scores, printed with six decimals, kept in
    ``<path>.json``); with ``log`` it appends the decoy's path to that
    file a call."""
    with open(path + ".json", "w") as f:
        json.dump({k: [float(v) for v in vs] for k, vs in scores.items()}, f)
    log_line = f"open({log!r}, 'a').write(sys.argv[1] + '\\n')\n" if log else ""
    with open(path, "w") as f:
        f.write(LDDT_STUB.format(python=sys.executable, scores=path + ".json", log=log_line))
    os.chmod(path, 0o755)
    return path


def write_psr_records(root: str, seed: int = SEED, targets=None, decoys: int = PSR_DECOYS, atoms=PSR_ATOMS) -> dict:
    """Synthetic PSR records in the npz format of
    scripts/convert_atom3d_to_npz.py under ``root`` (``targets``: per split,
    default PSR_TARGETS): for each target a native chain (_native_chains)
    of heavy atoms drawn C, N, O, S as in proteins, and ``decoys`` decoys,
    each the chain plus Gaussian noise of a log-uniform scale in
    PSR_NOISE, labelled with its gdt_ts.  Returns the decoys per split."""
    rng = np.random.default_rng(seed)
    counts = {}
    for split, n_targets in (targets or PSR_TARGETS).items():
        out = os.path.join(root, "PSR", "split-by-year", "data", f"{split}_npz")
        os.makedirs(out, exist_ok=True)
        chains = _native_chains(rng, rng.integers(atoms[0], atoms[1] + 1, size=n_targets))
        for t, native in enumerate(chains):
            elements = rng.choice(np.asarray(["C", "N", "O", "S"]), size=len(native), p=[0.62, 0.17, 0.19, 0.02])
            for d in range(decoys):
                scale = np.exp(rng.uniform(*np.log(PSR_NOISE)))
                coords = (native + scale * rng.normal(size=native.shape)).astype(np.float32)
                np.savez(
                    os.path.join(out, f"{t:03d}_{d:02d}.npz"), coords=coords, elements=elements,
                    label=np.float32(gdt_ts(coords, native)), target=f"{split}{t:03d}",
                )
        counts[split] = n_targets * decoys
    return counts


def psr_datamodule(root: str, batch_size: int = 16, max_nodes: int = PSR_BUCKET[0]) -> ATOM3DDataModule:
    dm = ATOM3DDataModule(task="PSR", data_dir=root, batch_size=batch_size, max_nodes_per_batch=max_nodes)
    dm.setup()
    return dm


def _batch_fill(batch) -> dict:
    nodes, edges = int(batch.node_pad_mask.sum()), int(batch.edge_pad_mask.sum())
    return {"graphs": int(batch.graph_pad_mask.sum()), "real_nodes": nodes, "real_edges": edges,
            "edge_padding_share": 1 - edges / batch.num_edges, "node_padding_share": 1 - nodes / batch.num_nodes}


def _timed_batches(batches, bucket=PSR_BUCKET) -> tuple:
    """For each batch of ``batches``: its fill (_batch_fill), whether it has
    the ``bucket``'s shape (nodes, edge rows) and CSR splits, the ms its
    making took (featurizing, packing, sorting; for the first, anything
    before it) and the ms its pinning took.  No batch is kept."""
    fills, make_ms, pin_ms = [], [], []
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            return fills, make_ms, pin_ms
        t1 = time.perf_counter()
        batch.pinned()
        pin_ms.append((time.perf_counter() - t1) * 1e3)
        make_ms.append((t1 - t0) * 1e3)
        in_bucket = (batch.num_nodes, batch.num_edges) == tuple(bucket) and batch.edge_row_splits is not None
        fills.append({**_batch_fill(batch), "in_bucket": in_bucket})


def phase_psr_data(root: str, ahead: WrittenAhead):
    """Synthetic PSR records written (write_psr_records, during the build:
    ``ahead``) and read (setup);
    one shuffled training epoch's batches made as the Trainer's prefetch
    thread makes them: the split's first pass before the first batch
    (which records featurize, the target codes), then each batch
    featurized, packed and sorted (ms a batch, and its pinning, against
    the step it must stay under); each batch's real nodes and edge rows
    against the bucket's."""
    counts, write_seconds = ahead.take("psr")
    t0 = time.perf_counter()
    dm = psr_datamodule(root)
    setup_seconds = time.perf_counter() - t0
    fills, make_ms, pin_ms = _timed_batches(dm.train_batches(seed=0))
    keys = ("graphs", "real_nodes", "real_edges", "edge_padding_share", "node_padding_share")
    results = {
        "decoys": counts, "write_seconds": write_seconds, "setup_seconds": setup_seconds,
        "first_batch_seconds": make_ms[0] / 1e3, "train_batches": len(fills),
        "featurize_ms_per_batch": {"mean": float(np.mean(make_ms[1:])), "max": float(np.max(make_ms[1:]))},
        "pin_ms_per_batch": {"mean": float(np.mean(pin_ms)), "max": float(np.max(pin_ms))},
        "bucket": {"nodes": PSR_BUCKET[0], "edges": PSR_BUCKET[1], "graphs": 16},
        "fill_min_mean_max": {k: [float(f(np.asarray([x[k] for x in fills]))) for f in (np.min, np.mean, np.max)]
                              for k in keys},
        "mean_in_degree": float(np.mean([x["real_edges"] / x["real_nodes"] for x in fills])),
        "graphs_per_batch": counts["train"] / len(fills),
        "per_batch": fills,
        "cuts": {"targets": dict(PSR_TARGETS), "decoys_per_target": PSR_DECOYS, "atoms": list(PSR_ATOMS),
                 "epochs": [PSR_EPOCHS, PSR_RESUME_EPOCHS], "data": "synthetic chains, not ATOM3D"},
    }
    print("phase psr-data: " + json.dumps({k: v for k, v in results.items() if k != "per_batch"}), flush=True)
    print("phase psr-data: per batch [decoys, real nodes, real edge rows]: "
          + json.dumps([[x["graphs"], x["real_nodes"], x["real_edges"]] for x in fills]), flush=True)
    check(sum(x["graphs"] for x in fills) == counts["train"],
          f"psr-data: {len(fills)} batches hold {sum(x['graphs'] for x in fills)} decoys")
    check(all(x["in_bucket"] for x in fills), "psr-data: a batch outside the bucket or without its CSR splits")
    print("phase psr-data: ok")
    return dm, results


def phase_psr_kernels(dm) -> dict:
    """K1, K2 and K3 at the PSR step's shape (a training batch: the bucket's
    524,288 receiver-sorted CSR rows into 16,384 nodes), fp32 and bf16,
    the LBA stack (PSR's is the same)."""
    batch = next(dm.train_batches(seed=0))
    results = {
        "K1": phase_k1({1: batch}, name="psr-K1"),
        "K2": phase_k2(batch, bench_message_passing(), name="psr-K2"),
        "K3": phase_k3(batch, bench_message_passing(), name="psr-K3", full_bound=False),
    }
    for kernel, res in results.items():
        for key, r in res.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print("phase psr-kernels: ok " + json.dumps({
        k: {d: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms", "library_ms")}
            for d, r in res.items()}
        for k, res in results.items()
    }))
    return results


def _psr_model(dev, layers: int, dtype: torch.dtype = torch.float32):
    """The PSR model at full width with ``layers`` interaction layers, no
    dropout, weights from SEED, and a train state (Adam at 1e-4) computing
    in ``dtype``."""
    trainer = build_task_trainer(
        "psr", SEED, dev, num_encoder_layers=layers, dropout=0.0, precision=16 if dtype == torch.bfloat16 else 32
    )
    return trainer.model, trainer.state


def phase_psr_check(root: str) -> dict:
    """The PSR step at PSR_CHECK_LAYERS interaction layers on
    PSR_CHECK_GRAPHS decoys (a bucket of PSR_CHECK_NODES nodes): fp32 on the
    card against the CPU (card_vs_cpu_step), then the bf16 step's
    gradients against the fp32 step's on the card (BF16_STEP_TOL)."""
    dm = psr_datamodule(root, PSR_CHECK_GRAPHS, PSR_CHECK_NODES)
    batch = next(dm.val_batches())
    results = {"fp32": card_vs_cpu_step("psr-check", lambda dev: _psr_model(dev, PSR_CHECK_LAYERS), batch,
                                        graph_regression_loss, PSR_CHECK_LAYERS, sign_flips=True)}
    dev_batch = batch.to(torch.device("cuda"))
    steps = {}
    reset_counts()
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model, state = _psr_model("cuda", PSR_CHECK_LAYERS, dtype)
        result = train_step(model, state, dev_batch, graph_regression_loss, deterministic=True)
        steps[name] = {"loss": result.loss.item(), "grad_norm": result.grad_norm.item(),
                       "grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()])}
    ref, bf16 = steps["fp32"], steps["bf16"]
    results["bf16"] = r = {
        "loss_rel_diff": abs(bf16["loss"] - ref["loss"]) / abs(ref["loss"]),
        "grad_norm_rel_diff": abs(bf16["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
        "grads_cosine": torch.nn.functional.cosine_similarity(bf16["grads"], ref["grads"], dim=0).item(),
        "launches": dict(zip(KERNEL_COUNTS, launch_counts())),
    }
    print("phase psr-check bf16: " + json.dumps(r), flush=True)
    check(r["launches"]["K3_bf16"] == r["launches"]["K3_fp32"] == PSR_CHECK_LAYERS,
          f"psr-check: K3 launches {r['launches']}")
    check(r["loss_rel_diff"] <= BF16_STEP_TOL["loss_rel"], "psr-check: bf16 loss differs")
    check(r["grad_norm_rel_diff"] <= BF16_STEP_TOL["grad_norm_rel"], "psr-check: bf16 grad norm differs")
    check(r["grads_cosine"] >= BF16_STEP_TOL["grads_cosine"], "psr-check: bf16 gradients differ")
    print("phase psr-check: ok")
    return results


PSR_METRICS = ("loss", "RMSE", "local_pearson", "local_spearman", "local_kendall", "global_pearson",
               "global_spearman", "global_kendall")


def phase_psr_fit(root: str, ckpt_dir: str, graphs_per_batch: float):
    """The PSR path: the full-width PSR model at FIT_LAYERS["psr"] layers with the experiment's defaults
    (bf16 over float32 masters, dropout 0.1, Adam at 1e-4, seed 42) fitted
    by the Trainer with scan_chunk_size FIT_CHUNK for PSR_EPOCHS epochs with
    checkpoints, on a datamodule that has not read the records yet (the
    first epoch makes the training split's first pass); a new Trainer
    resumes from the last checkpoint to epoch PSR_RESUME_EPOCHS and tests
    the best checkpoint.  Beside it the deterministic parity run
    (fit_parity).  Every kernel count is set to 0 just before the fit and
    read just after (psr-profile checks them); after the fit and after the
    resume each CapturedCall may hold two graphs, a full chunk's and the
    tail's, as every batch has the bucket's shape."""
    build = lambda seed=42, **kw: build_task_trainer(  # noqa: E731
        "psr", seed, "cuda", num_encoder_layers=FIT_LAYERS["psr"], lr=FIT_LR, precision=16, **kw)
    parity = fit_parity(build, psr_datamodule(root), graph_regression_loss)
    dm = psr_datamodule(root)
    clock = EpochClock()
    trainer = build(max_epochs=PSR_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    gc.collect()  # the parity run's trainers: their memory is not the fit's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # allocated as the fit begins: its model and optimizer, and what earlier
    # phases still hold, all inside the peak
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    clock.last = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    results = {"launches": dict(zip(KERNEL_COUNTS, launch_counts())), "held_at_start_gb": held_gb,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "steps": trainer.state.step}
    results.update(_fit_record(trainer, clock, None, FIT_LR), parity=parity)
    resumed_clock = EpochClock()
    resumed = build(max_epochs=PSR_RESUME_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[resumed_clock],
                    scan_chunk_size=FIT_CHUNK)
    counted = EpochBatches(dm)
    resumed.fit(counted, resume=True)
    results["resumed_graphs"] = _fit_record(resumed, resumed_clock, None, FIT_LR)["graphs"]
    # the step the fit ended at, before the best checkpoint's state replaces it
    results["final_step"] = resumed.state.step
    results["best_step"] = resumed.restore_best()
    results["test"] = test = resumed.test(dm)
    torch.cuda.synchronize()
    epochs = clock.lines + resumed_clock.lines[:-1]
    results["epochs"] = [
        {k: line[k] for k in ("epoch", "seconds", "train/loss", "train/steps_per_sec")}
        | {f"val/{m}": line[f"val/{m}"] for m in PSR_METRICS}
        | {"train_graphs_per_s": line["train/steps_per_sec"] * graphs_per_batch}
        for line in epochs
    ]
    print("phase psr-fit: " + json.dumps(results), flush=True)
    check([line["epoch"] for line in epochs] == list(range(PSR_RESUME_EPOCHS)), "psr-fit: epochs run")
    for line in results["epochs"]:
        check(all(math.isfinite(v) for v in line.values()), f"psr-fit: epoch line {line}")
    check(all(math.isfinite(test[f"test/{m}"]) for m in PSR_METRICS), f"psr-fit: test metrics {test}")
    check(results["final_step"] == resumed_step(results["steps"], counted, PSR_EPOCHS, PSR_RESUME_EPOCHS),
          f"psr-fit: resumed steps, {results['final_step']} after {results['steps']} and {counted.counts}")
    for graphs in (results["graphs"], results["resumed_graphs"]):
        check(graphs["train_held"] <= 2 and graphs["eval_held"] <= 2, f"psr-fit: CUDA graphs held {graphs}")
    print("phase psr-fit: ok")
    return resumed, dm, results


def phase_psr_profile(trainer, dm, fit: dict) -> dict:
    """One warm eager PSR training step of the fitted model and one replay
    of its captured train and eval chunks under torch.profiler (busy ms,
    idle share, kernels: K1, K2 and the bf16 K3 once a layer a step); then the
    psr-fit's checks that read them (_fit_checks)."""
    layers = model_layers(trainer.model)
    results = _profile_steps(trainer, dm, graph_regression_loss, layers, k1_steps("psr", layers))
    print("phase psr-profile: " + json.dumps(results), flush=True)
    _fit_checks("psr-fit", {**fit, **results}, layers, None, k1_steps("psr", layers), k3="K3_bf16")
    print("phase psr-profile: ok")
    return results


# --- CPD ----------------------------------------------------------------------

def cpd_datamodule(root: str, batch_size: int = 8, max_nodes: int = CPD_BUCKET[0]) -> CATHDataModule:
    dm = CATHDataModule(data_dir=root, batch_size=batch_size, max_nodes_per_batch=max_nodes)
    dm.prepare_data()
    dm.setup()
    return dm


def phase_cpd_data(root: str, ahead: WrittenAhead):
    """Synthetic CATH chains written (write_cath_chains, during the build:
    ``ahead``) and read
    (CATHDataModule); a shuffled training epoch's batches made as the
    Trainer's prefetch thread makes them (featurized on threads, packed,
    receiver-sorted): ms a batch and its pinning, each batch's real nodes
    and edge rows against the bucket's 2,048 and 61,440."""
    written, write_seconds = ahead.take("cpd")
    t0 = time.perf_counter()
    dm = cpd_datamodule(root)
    setup_seconds = time.perf_counter() - t0
    fills, make_ms, pin_ms = _timed_batches(dm.train_batches(seed=0), CPD_BUCKET)
    keys = ("graphs", "real_nodes", "real_edges", "edge_padding_share", "node_padding_share")
    results = {
        **written, "write_seconds": write_seconds, "setup_seconds": setup_seconds,
        "custom_splits": {k: len(v) for k, v in dm.custom_splits.items()},
        "train_batches": len(fills),
        "host_ms_per_batch": {"mean": float(np.mean(make_ms[1:])), "max": float(np.max(make_ms[1:])),
                              "first": make_ms[0]},
        "pin_ms_per_batch": {"mean": float(np.mean(pin_ms)), "max": float(np.max(pin_ms))},
        "bucket": {"nodes": CPD_BUCKET[0], "edges": CPD_BUCKET[1], "graphs": 8},
        "fill_min_mean_max": {k: [float(f(np.asarray([x[k] for x in fills]))) for f in (np.min, np.mean, np.max)]
                              for k in keys},
        "graphs_per_batch": CPD_CHAINS["train"] / len(fills),
        "per_batch": fills,
        "cuts": {"chains": dict(CPD_CHAINS), "lengths": list(CPD_LENGTHS), "epochs": [CPD_EPOCHS, CPD_RESUME_EPOCHS],
                 "design_chains": CPD_DESIGN_CHAINS, "data": "synthetic chains, not CATH 4.2"},
    }
    print("phase cpd-data: " + json.dumps({k: v for k, v in results.items() if k != "per_batch"}), flush=True)
    print("phase cpd-data: per batch [chains, real nodes, real edge rows]: "
          + json.dumps([[x["graphs"], x["real_nodes"], x["real_edges"]] for x in fills]), flush=True)
    check(written["chains"] == CPD_CHAINS, f"cpd-data: chains written {written['chains']}")
    check([len(v) for v in dm.splits.values()] == list(CPD_CHAINS.values()), "cpd-data: splits read")
    check(sum(x["graphs"] for x in fills) == CPD_CHAINS["train"],
          f"cpd-data: {len(fills)} batches hold {sum(x['graphs'] for x in fills)} chains")
    check(all(x["in_bucket"] for x in fills), "cpd-data: a batch outside the bucket or without its CSR splits")
    print("phase cpd-data: ok")
    return dm, results


def cpd_message_passing() -> GCPMessagePassing:
    """One encoder layer's message passing of the CPD model (8 GCP2 layers,
    hidden 100/16, edges 32/4), random weights from the seed."""
    model_cfg, module_cfg, layer_cfg = task_configs("cpd")
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def phase_cpd_kernels(dm) -> dict:
    """K1, K2 and K3 at the CPD step's shape (a training batch: the bucket's
    61,440 receiver-sorted CSR rows into 2,048 nodes), fp32 and bf16, the
    encoder's stack; K3 fp32 by the kink rule."""
    batch = next(dm.train_batches(seed=0))
    results = {
        "K1": phase_k1({1: batch}, name="cpd-K1"),
        "K2": phase_k2(batch, cpd_message_passing(), name="cpd-K2"),
        "K3": phase_k3(batch, cpd_message_passing(), name="cpd-K3", full_bound=False),
    }
    for kernel, res in results.items():
        for key, r in res.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print("phase cpd-kernels: ok " + json.dumps({
        k: {d: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms", "library_ms")}
            for d, r in res.items()}
        for k, res in results.items()
    }))
    return results


def _cpd_model(dev, layers: int, dtype: torch.dtype = torch.float32):
    """The CPD model at full width with ``layers`` encoder and decoder
    layers, no dropout, weights from SEED, and a train state (Adam at 1e-4,
    weight decay 1e-8, no accumulation) computing in ``dtype``."""
    trainer = build_task_trainer(
        "cpd", SEED, dev, num_encoder_layers=layers, num_decoder_layers=layers, dropout=0.0, accumulate_grad_batches=1,
        precision=16 if dtype == torch.bfloat16 else 32,
    )
    return trainer.model, trainer.state


def phase_cpd_check(root: str) -> dict:
    """The CPD step at CPD_CHECK_LAYERS encoder and decoder layers on
    CPD_CHECK_GRAPHS validation chains (a bucket of CPD_CHECK_NODES nodes):
    fp32 on the card against the CPU (card_vs_cpu_step: loss, gradient
    norm, every gradient, the share of updated parameters apart), then
    the bf16 step's gradients against the fp32 step's on the card
    (BF16_STEP_TOL).  The updated parameters are held by the share apart
    alone: Adam's first step moves every entry by about lr times its
    gradient's sign, so a gradient within rounding of 0 that takes the other
    sign parts the two steps by up to 2 lr (on one H100 80GB HBM3 at 700 W,
    0.005-0.03% of the 825,332 entries parted by up to 1.8e-4), and a
    max-abs bound that allows that cannot fail."""
    dm = cpd_datamodule(root, CPD_CHECK_GRAPHS, CPD_CHECK_NODES)
    batch = next(dm.val_batches())
    results = {"fp32": card_vs_cpu_step("cpd-check", lambda dev: _cpd_model(dev, CPD_CHECK_LAYERS), batch,
                                        cpd_loss, CPD_CHECK_LAYERS, params_by_share=True)}
    k1 = 2 * k1_steps("cpd", CPD_CHECK_LAYERS, CPD_CHECK_LAYERS)[0]
    want = {"K1": k1, "K2": 2 * CPD_CHECK_LAYERS, "K3_bf16": CPD_CHECK_LAYERS, "K3_fp32": CPD_CHECK_LAYERS}
    results["bf16"] = bf16_vs_fp32_step("cpd-check", lambda dev, dtype: _cpd_model(dev, CPD_CHECK_LAYERS, dtype),
                                        batch, cpd_loss, want)
    print("phase cpd-check: ok")
    return results


def bf16_vs_fp32_step(name: str, build, batch, loss_fn, want: dict) -> dict:
    """One bf16 and one fp32 training step on the card from the same
    weights (``build(device, dtype) -> (model, state)``), no dropout: the
    bf16 step's loss, gradient norm and gradients against the fp32 step's
    (BF16_STEP_TOL); ``want`` the kernel launches of the two steps."""
    dev_batch = batch.to(torch.device("cuda"))
    steps = {}
    reset_counts()
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model, state = build("cuda", dtype)
        result = train_step(model, state, dev_batch, loss_fn, deterministic=True)
        steps[dname] = {"loss": result.loss.item(), "grad_norm": result.grad_norm.item(),
                        "grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()])}
    ref, bf16 = steps["fp32"], steps["bf16"]
    r = {
        "loss_rel_diff": abs(bf16["loss"] - ref["loss"]) / abs(ref["loss"]),
        "grad_norm_rel_diff": abs(bf16["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
        "grads_cosine": torch.nn.functional.cosine_similarity(bf16["grads"], ref["grads"], dim=0).item(),
        "launches": dict(zip(KERNEL_COUNTS, launch_counts())),
    }
    print(f"phase {name} bf16: " + json.dumps(r), flush=True)
    check(r["launches"] == want, f"{name}: launches {r['launches']}, want {want}")
    check(r["loss_rel_diff"] <= BF16_STEP_TOL["loss_rel"], f"{name}: bf16 loss differs")
    check(r["grad_norm_rel_diff"] <= BF16_STEP_TOL["grad_norm_rel"], f"{name}: bf16 grad norm differs")
    check(r["grads_cosine"] >= BF16_STEP_TOL["grads_cosine"], f"{name}: bf16 gradients differ")
    return r


CPD_METRICS = ("loss", "recovery_argmax")


def phase_cpd_fit(root: str, ckpt_dir: str, graphs_per_batch: float):
    """The CPD path: the full-width CPD model at FIT_LAYERS["cpd"] encoder and
    CPD_FIT_DECODERS decoder layers with the
    experiment's defaults (autoregressive decoder, bf16 over float32
    masters, dropout 0.2, Adam at 1e-4 with weight decay 1e-8, gradients
    accumulated over 4 batches, seed 42) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK for CPD_EPOCHS epochs with checkpoints; a new
    Trainer resumes from the last checkpoint to epoch CPD_RESUME_EPOCHS and
    tests the best checkpoint.  Beside it the deterministic parity run
    (fit_parity).  Every kernel count is set to 0 just before the fit and
    read just after (cpd-profile checks them)."""
    build = lambda seed=42, **kw: build_task_trainer(  # noqa: E731
        "cpd", seed, "cuda", num_encoder_layers=FIT_LAYERS["cpd"], num_decoder_layers=CPD_FIT_DECODERS, lr=FIT_LR,
        precision=16, **kw)
    parity = fit_parity(build, cpd_datamodule(root), cpd_loss)
    dm = cpd_datamodule(root)
    clock = EpochClock()
    trainer = build(max_epochs=CPD_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    clock.last = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    results = {"launches": dict(zip(KERNEL_COUNTS, launch_counts())), "held_at_start_gb": held_gb,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "steps": trainer.state.step}
    results.update(_fit_record(trainer, clock, None, FIT_LR), parity=parity)
    resumed_clock = EpochClock()
    resumed = build(max_epochs=CPD_RESUME_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[resumed_clock],
                    scan_chunk_size=FIT_CHUNK)
    counted = EpochBatches(dm)
    resumed.fit(counted, resume=True)
    results["resumed_graphs"] = _fit_record(resumed, resumed_clock, None, FIT_LR)["graphs"]
    # the step the fit ended at, before the best checkpoint's state replaces it
    results["final_step"] = resumed.state.step
    results["best_step"] = resumed.restore_best()
    results["test"] = test = resumed.test(dm)
    torch.cuda.synchronize()
    epochs = clock.lines + resumed_clock.lines[:-1]
    results["epochs"] = [
        {k: line[k] for k in ("epoch", "seconds", "train/loss", "train/steps_per_sec")}
        | {f"val/{m}": line[f"val/{m}"] for m in CPD_METRICS}
        | {"train_graphs_per_s": line["train/steps_per_sec"] * graphs_per_batch}
        for line in epochs
    ]
    print("phase cpd-fit: " + json.dumps(results), flush=True)
    check([line["epoch"] for line in epochs] == list(range(CPD_RESUME_EPOCHS)), "cpd-fit: epochs run")
    for line in results["epochs"]:
        check(all(math.isfinite(v) for v in line.values()), f"cpd-fit: epoch line {line}")
    check(all(math.isfinite(test[f"test/{m}"]) for m in CPD_METRICS), f"cpd-fit: test metrics {test}")
    check(results["final_step"] == resumed_step(results["steps"], counted, CPD_EPOCHS, CPD_RESUME_EPOCHS),
          f"cpd-fit: resumed steps, {results['final_step']} after {results['steps']} and {counted.counts}")
    for graphs in (results["graphs"], results["resumed_graphs"]):
        check(graphs["train_held"] <= 2 and graphs["eval_held"] <= 2, f"cpd-fit: CUDA graphs held {graphs}")
    print("phase cpd-fit: ok")
    return resumed, dm, results


def phase_cpd_profile(trainer, dm, fit: dict) -> dict:
    """One warm eager CPD training step of the fitted model and one replay
    of its captured train and eval chunks under torch.profiler (busy ms,
    idle share, kernels: K2 and the bf16 K3 once an encoder layer a step, K1
    as k1_steps counts it for the model's encoder and decoder layers); then the
    cpd-fit's checks that read them (_fit_checks)."""
    layers = model_layers(trainer.model)
    k1 = k1_steps("cpd", layers, trainer.model.num_decoder_layers)
    results = _profile_steps(trainer, dm, cpd_loss, layers, k1)
    print("phase cpd-profile: " + json.dumps(results), flush=True)
    _fit_checks("cpd-fit", {**fit, **results}, layers, None, k1, k3="K3_bf16")
    print("phase cpd-profile: ok")
    return results


def phase_cpd_design(trainer, dm) -> dict:
    """The fitted model's design of test chains (evaluate_cpd, float32):
    the first CPD_DESIGN_CHAINS test chains, CPD_SAMPLES sequences each at
    CPD_TEMPERATURE, median perplexity and recovery for all, short and
    single_chain; ms a chain, and the device's launches a position (one
    chain's sampling under torch.profiler); every kernel count set to 0
    just before and read just after.  Then the argmax samples
    (temperature 1e-6) of the shortest of those chains, CPD_ARGMAX_SAMPLES
    copies, card against CPU on the same weights."""
    model = trainer.model
    chains = list(itertools.islice(dm.named_graphs("test"), CPD_DESIGN_CHAINS))
    names = {n for n, _ in chains}
    subsets = {k: v & names for k, v in dm.custom_splits.items()}
    per_chain = []
    reset_counts()
    t0 = time.perf_counter()
    metrics = evaluate_cpd(model, chains, subsets, num_samples=CPD_SAMPLES, temperature=CPD_TEMPERATURE,
                           per_chain=per_chain)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    name, graph = min(chains, key=lambda c: c[1].num_nodes)
    prof = device_profile(lambda: datum_recovery(model, graph, CPD_SAMPLES, CPD_TEMPERATURE))
    card = datum_samples(model, graph, CPD_ARGMAX_SAMPLES)
    cpu_model = build_task_trainer("cpd", SEED, "cpu", num_encoder_layers=model_layers(model),
                                   num_decoder_layers=model.num_decoder_layers).model
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu = datum_samples(cpu_model, graph, CPD_ARGMAX_SAMPLES)
    positions = int(graph.num_nodes)
    results = {
        "metrics": metrics, "chains": len(per_chain), "seconds": seconds,
        "ms_per_chain": 1e3 * float(np.mean([c[3] for c in per_chain])),
        "ms_per_residue": 1e3 * sum(c[3] for c in per_chain) / sum(g.num_nodes for _, g in chains),
        "per_chain": [[c[0], c[1], c[2], c[3]] for c in per_chain],
        "launches": launches,
        "profiled_chain": {"name": name, "positions": positions, "wall_ms": prof["wall_ms"],
                           "device_busy_ms": prof["device_busy_ms"], "device_idle_share": prof["device_idle_share"],
                           "kernel_launches": prof["kernel_launches"],
                           "launches_per_position": prof["kernel_launches"] / positions,
                           "top_ms": prof["top_ms"]},
        "argmax_card_vs_cpu": {"chain": name, "copies": CPD_ARGMAX_SAMPLES,
                               "equal_share": float((card == cpu).mean()), "equal": bool((card == cpu).all())},
    }
    print("phase cpd-design: " + json.dumps(results), flush=True)
    check(results["chains"] == len(chains) == CPD_DESIGN_CHAINS, f"cpd-design: {results['chains']} chains evaluated")
    for key in ("all", "short", "single_chain"):
        for m in ("perplexity", "recovery"):
            check(math.isfinite(metrics.get(f"test/{key}_{m}", float("nan"))), f"cpd-design: test/{key}_{m}")
    # each chain's perplexity (an evaluation forward) and its sampling
    # batch's encoder (the centring, the embedding's node frames, a mean
    # and node frames a layer), 9 K2 each; and the sampler's decoder steps,
    # a sum a decoder layer at each position with a valid node (the
    # subgraphs carry their indices' sorted forms)
    layers = model_layers(model)
    decoders = model.num_decoder_layers
    k1 = k1_steps("cpd", layers, decoders)[1] + 2 + 2 * layers
    steps = sum(g.num_nodes if g.node_mask is None else int(np.sum(g.node_mask)) for _, g in chains)
    want = {"K1": len(chains) * k1 + decoders * steps, "K2": len(chains) * 2 * layers,
            "K3_bf16": 0, "K3_fp32": 0}
    check(launches == want, f"cpd-design: launches {launches}, want {want}")
    check(results["argmax_card_vs_cpu"]["equal_share"] >= CPD_ARGMAX_EQUAL_SHARE,
          f"cpd-design: argmax samples card vs CPU {results['argmax_card_vs_cpu']}")
    print("phase cpd-design: ok")
    return results


def phase_determinism(dm) -> dict:
    """Two eager fp32 RS runs at full width, DETERMINISM_STEPS training
    steps each from the same weights, batches and dropout seed, without
    torch.use_deterministic_algorithms: every sum and every gather's
    backward runs through K1 (or a scatter-free gather), so the parameters
    must end equal bit for bit; the share of entries apart is printed."""
    runs = []
    for _ in range(2):
        trainer = build_task_trainer("rs", 42, "cuda", lr=FIT_LR, precision=32)
        for batch in itertools.islice(dm.train_batches(seed=0), DETERMINISM_STEPS):
            train_step(trainer.model, trainer.state, batch.to(torch.device("cuda")), rs_loss, trainer.generator)
        torch.cuda.synchronize()
        runs.append(flat_params(trainer.model))
        del trainer
    apart = (runs[0] != runs[1]).double().mean().item()
    results = {"steps": DETERMINISM_STEPS, "params_equal": torch.equal(runs[0], runs[1]), "share_apart": apart,
               "moved_share": (runs[0] != flat_params(build_task_trainer("rs", 42, "cuda", lr=FIT_LR, precision=32).model)).double()
               .mean().item()}
    print("phase determinism: " + json.dumps(results), flush=True)
    check(results["params_equal"], f"determinism: two eager fp32 RS runs part in {apart:.3g} of the entries")
    print("phase determinism: ok")
    return results


def eq_datamodule(root: str, max_nodes: int = EQ_BUCKET[0], max_residues: int = EQ_MAX_RESIDUES) -> EQDataModule:
    dm = EQDataModule.from_data_dir(root, batch_size=1, max_nodes_per_batch=max_nodes,
                                    max_residues_per_batch=max_residues)
    dm.prepare_data()
    dm.setup()
    return dm


def phase_eq_data(root: str, written: Optional[dict] = None, write_seconds: float = 0.0):
    """Synthetic EQ decoys written (write_eq_decoys) and read (EQDataModule):
    each split's first pass (parsing, the ESM cache, the radius graph and
    the per-residue lDDT labels, each graph then cached, as the JAX module
    caches its graphs), then one shuffled training epoch's batches as the
    Trainer's prefetch thread makes them from the cache: ms a batch to read,
    pack, sort and attach the sorted indices, and to pin; each batch's real
    nodes, edge rows and residues against the bucket's.  Decoys that the
    esm phase wrote (``written``) are not written again."""
    if written is None:
        t0 = time.perf_counter()
        written = write_eq_decoys(root, seed=SEED, targets=EQ_TARGETS, decoys=EQ_DECOYS, residues=EQ_RESIDUES)
        write_seconds = time.perf_counter() - t0
    dm = eq_datamodule(root)
    first_pass = {}
    for split in ("train", "valid", "test"):
        t0 = time.perf_counter()
        graphs = sum(1 for _ in dm._graphs(split))
        first_pass[split] = {"graphs": graphs, "seconds": time.perf_counter() - t0}
    fills, make_ms, pin_ms = _timed_batches(dm.train_batches(seed=0), EQ_BUCKET)
    labels = np.concatenate([b.extras["label"][b.extras["res_mask"] > 0] for b in dm.val_batches()])
    keys = ("real_nodes", "real_edges", "edge_padding_share", "node_padding_share")
    results = {
        **written, "write_seconds": write_seconds, "first_pass": first_pass,
        "featurize_ms_per_decoy": 1e3 * first_pass["train"]["seconds"] / first_pass["train"]["graphs"],
        "train_batches": len(fills),
        "host_ms_per_batch": {"mean": float(np.mean(make_ms)), "max": float(np.max(make_ms))},
        "pin_ms_per_batch": {"mean": float(np.mean(pin_ms)), "max": float(np.max(pin_ms))},
        "bucket": {"nodes": EQ_BUCKET[0], "edges": EQ_BUCKET[1], "graphs": 1, "residues": EQ_MAX_RESIDUES},
        "fill_min_mean_max": {k: [float(f(np.asarray([x[k] for x in fills]))) for f in (np.min, np.mean, np.max)]
                              for k in keys},
        "val_label_mean_std": [float(labels.mean()), float(labels.std())],
        "cuts": {"targets": dict(EQ_TARGETS), "decoys_per_target": EQ_DECOYS, "residues": list(EQ_RESIDUES),
                 "epochs": [EQ_EPOCHS, EQ_RESUME_EPOCHS],
                 "data": "synthetic decoys, not EQ; ESM-2 650M embeddings of random weights (the esm phase)"},
    }
    print("phase eq-data: " + json.dumps(results), flush=True)
    want = {k: EQ_TARGETS[k] * EQ_DECOYS for k in EQ_TARGETS}
    check(written["decoys"] == want and {k: v["graphs"] for k, v in first_pass.items()} == want,
          f"eq-data: decoys written {written['decoys']}, featurized {first_pass}")
    check(len(fills) == want["train"] and all(x["in_bucket"] for x in fills),
          "eq-data: a batch outside the bucket or without its CSR splits")
    check(0.05 < labels.mean() < 0.95 and labels.std() > 0.02, f"eq-data: lDDT labels {results['val_label_mean_std']}")
    print("phase eq-data: ok")
    return dm, results


def eq_message_passing() -> GCPMessagePassing:
    """One EQ layer's message passing (8 GCP3 layers, hidden 100/16, edges
    32/4, the attention and the sum over senders), random weights from the
    seed."""
    model_cfg, module_cfg, layer_cfg = task_configs("eq")
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg, reduce_function="sum",
        use_scalar_message_attention=True, aggregate_with_row=True,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def phase_eq_kernels(dm) -> dict:
    """K1, K2 and K3 at the EQ step's shape (a training batch: the bucket's
    262,144 receiver-sorted CSR rows into 8,192 nodes), fp32 and bf16, an
    EQ layer's GCP3 stack; K3 fp32 by the kink rule.  The timed batch's
    real nodes and edge rows are printed beside them (the bounds count
    what this batch's data needs)."""
    batch = next(dm.train_batches(seed=0))
    fill = _batch_fill(batch)
    results = {
        "K1": phase_k1({1: batch}, name="eq-K1"),
        "K2": phase_k2(batch, eq_message_passing(), name="eq-K2"),
        "K3": phase_k3(batch, eq_message_passing(), name="eq-K3", full_bound=False),
    }
    for kernel, res in results.items():
        for key, r in res.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print("phase eq-kernels: ok " + json.dumps({"batch": fill} | {
        k: {d: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms", "library_ms")}
            for d, r in res.items()}
        for k, res in results.items()
    }))
    return {"batch": fill, **results}


def _eq_model(dev, layers: int, dtype: torch.dtype = torch.float32):
    """The EQ model at full width with ``layers`` layers, no dropout,
    weights from SEED, and a train state (Adam at 1e-4, the experiment's
    adaptive clip) computing in ``dtype``."""
    trainer = build_task_trainer("eq", SEED, dev, num_encoder_layers=layers, dropout=0.0,
                               precision=16 if dtype == torch.bfloat16 else 32)
    return trainer.model, trainer.state


def phase_eq_check(root: str) -> dict:
    """The EQ step at EQ_CHECK_LAYERS layers on one decoy of 60-100 residues
    (written under ``root``, apart from the fit's, in a bucket of
    EQ_CHECK_NODES nodes): fp32 on the card
    against the CPU (card_vs_cpu_step: loss, gradient norm, every gradient,
    the updated parameters by the share apart, as cpd-check), then the bf16
    step's gradients against the fp32 step's on the card (BF16_STEP_TOL)."""
    write_eq_decoys(root, seed=SEED + 1, targets={"valid": 1}, decoys=1, residues=(60, 100))
    dm = eq_datamodule(root, EQ_CHECK_NODES, EQ_CHECK_RESIDUES)
    batch = next(dm.val_batches())
    results = {"fp32": card_vs_cpu_step("eq-check", lambda dev: _eq_model(dev, EQ_CHECK_LAYERS), batch, eq_loss,
                                        EQ_CHECK_LAYERS, params_by_share=True)}
    k1 = 2 * k1_steps("eq", EQ_CHECK_LAYERS)[0]
    want = {"K1": k1, "K2": 2 * EQ_CHECK_LAYERS, "K3_bf16": EQ_CHECK_LAYERS, "K3_fp32": EQ_CHECK_LAYERS}
    results["bf16"] = bf16_vs_fp32_step("eq-check", lambda dev, dtype: _eq_model(dev, EQ_CHECK_LAYERS, dtype),
                                        batch, eq_loss, want)
    print("phase eq-check: ok")
    return results


EQ_METRICS = ("loss", "RMSE", "PearsonCorrCoef")


def phase_eq_fit(root: str, ckpt_dir: str):
    """The EQ path: the full-width EQ model at FIT_LAYERS["eq"] layers with the
    experiment's defaults (bf16 over float32 masters, dropout 0.1, Adam at
    1e-4, seed 42, one decoy a batch) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK for EQ_EPOCHS epochs with checkpoints; a new
    Trainer resumes from the last checkpoint to epoch EQ_RESUME_EPOCHS and
    tests the best checkpoint: seconds an epoch, train graphs/s, val and
    test RMSE and Pearson on the synthetic labels, peak memory.  Beside it
    the deterministic parity run (fit_parity).  Every kernel count is set to
    0 just before the fit and read just after (eq-profile checks them)."""
    build = lambda seed=42, **kw: build_task_trainer(  # noqa: E731
        "eq", seed, "cuda", num_encoder_layers=FIT_LAYERS["eq"], lr=FIT_LR, precision=16, **kw)
    parity = fit_parity(build, eq_datamodule(root), eq_loss)
    dm = eq_datamodule(root)
    clock = EpochClock()
    trainer = build(max_epochs=EQ_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    clock.last = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    results = {"launches": dict(zip(KERNEL_COUNTS, launch_counts())), "held_at_start_gb": held_gb,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "steps": trainer.state.step}
    results.update(_fit_record(trainer, clock, None, FIT_LR), parity=parity)
    resumed_clock = EpochClock()
    resumed = build(max_epochs=EQ_RESUME_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[resumed_clock],
                    scan_chunk_size=FIT_CHUNK)
    counted = EpochBatches(dm)
    resumed.fit(counted, resume=True)
    # the step the fit ended at, before the best checkpoint's state replaces it
    results["final_step"] = resumed.state.step
    results["resumed_graphs"] = _fit_record(resumed, resumed_clock, None, FIT_LR)["graphs"]
    results["best_step"] = resumed.restore_best()
    results["test"] = test = resumed.test(dm)
    torch.cuda.synchronize()
    epochs = clock.lines + resumed_clock.lines[:-1]
    results["epochs"] = [
        {k: line[k] for k in ("epoch", "seconds", "train/loss", "train/steps_per_sec")}
        | {f"val/{m}": line[f"val/{m}"] for m in EQ_METRICS}
        | {"train_graphs_per_s": line["train/steps_per_sec"]}
        for line in epochs
    ]
    print("phase eq-fit: " + json.dumps(results), flush=True)
    check([line["epoch"] for line in epochs] == list(range(EQ_RESUME_EPOCHS)), "eq-fit: epochs run")
    for line in results["epochs"]:
        check(all(math.isfinite(v) for v in line.values()), f"eq-fit: epoch line {line}")
    check(all(math.isfinite(test[f"test/{m}"]) for m in EQ_METRICS), f"eq-fit: test metrics {test}")
    check(results["final_step"] == resumed_step(results["steps"], counted, EQ_EPOCHS, EQ_RESUME_EPOCHS),
          f"eq-fit: resumed steps, {results['final_step']} after {results['steps']} and {counted.counts}")
    for graphs in (results["graphs"], results["resumed_graphs"]):
        check(graphs["train_held"] <= 2 and graphs["eval_held"] <= 2, f"eq-fit: CUDA graphs held {graphs}")
    print("phase eq-fit: ok")
    return resumed, dm, results


def phase_eq_profile(trainer, dm, fit: dict) -> dict:
    """One warm eager EQ training step of the fitted model and one replay of
    its captured train and eval chunks under torch.profiler (busy ms, idle
    share, kernels: K2 and the bf16 K3 once a layer a step, K1 as k1_steps counts
    it, no scatter kernel); then the eq-fit's checks that read them
    (_fit_checks)."""
    layers = model_layers(trainer.model)
    k1 = k1_steps("eq", layers)
    results = _profile_steps(trainer, dm, eq_loss, layers, k1)
    print("phase eq-profile: " + json.dumps(results), flush=True)
    _fit_checks("eq-fit", {**fit, **results}, layers, None, k1, k3="K3_bf16")
    print("phase eq-profile: ok")
    return results


def ar_datamodule(root: str, max_nodes: int = AR_BUCKET[0], max_residues: int = AR_MAX_RESIDUES, **kw) -> ARDataModule:
    dm = ARDataModule.from_data_dir(root, batch_size=1, max_nodes_per_batch=max_nodes,
                                    max_residues_per_batch=max_residues, **kw)
    dm.prepare_data()
    dm.setup()
    return dm


def phase_ar_data(root: str, ahead: WrittenAhead):
    """Synthetic AR pairs written (write_ar_pairs, during the build:
    ``ahead``) and read (ARDataModule):
    each split's first pass (parsing, the ESM cache, the hybrid kNN graph,
    the pair features and the native's positions; the evaluation graphs
    then cached, as the JAX module caches its uncropped graphs), then one
    shuffled training epoch's batches as the Trainer's prefetch thread
    makes them (each a 250-residue crop featurized anew, packed, sorted
    and given the sorted indices), and pinned: ms a batch for each; each
    batch's real nodes and edge rows against the bucket's."""
    written, write_seconds = ahead.take("ar")
    dm = ar_datamodule(root)
    first_pass = {}
    for split in ("train", "valid", "test"):
        t0 = time.perf_counter()
        graphs = sum(1 for _ in dm._graphs(split, split == "train", 0))
        first_pass[split] = {"graphs": graphs, "seconds": time.perf_counter() - t0}
    fills, make_ms, pin_ms = _timed_batches(dm.train_batches(seed=0), AR_BUCKET)
    moves = np.concatenate([np.linalg.norm(b.extras["label"] - b.x, axis=-1)[b.node_pad_mask]
                            for b in dm.val_batches()])
    keys = ("real_nodes", "real_edges", "edge_padding_share", "node_padding_share")
    results = {
        **written, "write_seconds": write_seconds, "first_pass": first_pass,
        "featurize_ms_per_decoy": 1e3 * first_pass["train"]["seconds"] / first_pass["train"]["graphs"],
        "train_batches": len(fills),
        "host_ms_per_batch": {"mean": float(np.mean(make_ms)), "max": float(np.max(make_ms))},
        "pin_ms_per_batch": {"mean": float(np.mean(pin_ms)), "max": float(np.max(pin_ms))},
        "bucket": {"nodes": AR_BUCKET[0], "edges": AR_BUCKET[1], "graphs": 1, "residues": AR_MAX_RESIDUES},
        "fill_min_mean_max": {k: [float(f(np.asarray([x[k] for x in fills]))) for f in (np.min, np.mean, np.max)]
                              for k in keys},
        "val_decoy_to_native_mean_std": [float(moves.mean()), float(moves.std())],
        "cuts": {"pairs": dict(AR_PAIRS), "epochs": [AR_EPOCHS, AR_RESUME_EPOCHS],
                 "data": "synthetic pairs and ESM cache, not AR"},
    }
    print("phase ar-data: " + json.dumps(results), flush=True)
    check(written["decoys"] == AR_PAIRS and {k: v["graphs"] for k, v in first_pass.items()} == AR_PAIRS,
          f"ar-data: pairs written {written['decoys']}, featurized {first_pass}")
    check(len(fills) == AR_PAIRS["train"] and all(x["in_bucket"] for x in fills),
          "ar-data: a batch outside the bucket or without its CSR splits")
    check(0.3 < moves.mean() < 5.0, f"ar-data: decoy to native {results['val_decoy_to_native_mean_std']}")
    print("phase ar-data: ok")
    return dm, results


def ar_message_passing() -> GCPMessagePassing:
    """One AR layer's message passing (4 GCP3 layers with silu and the
    vector gate, hidden 100/32, edges 16/4, the attention and the sum over
    senders), random weights from the seed."""
    model_cfg, module_cfg, layer_cfg = task_configs("ar")
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, module_cfg, layer_cfg, reduce_function="sum",
        use_scalar_message_attention=True, aggregate_with_row=True,
        generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def phase_ar_kernels(dm) -> dict:
    """K1, K2 and K3 at the AR step's shape (a training batch: the bucket's
    622,592 receiver-sorted CSR rows into 4,096 nodes), fp32 and bf16, an
    AR layer's GCP3 stack with silu (no kink: K3 fp32 is held with every
    row); K2's and K3's tile rows (K2's weight buffers) with their shared
    memory.
    The timed batch's real nodes and edge rows are printed beside them."""
    batch = next(dm.train_batches(seed=0))
    fill = _batch_fill(batch)
    mp = ar_message_passing()
    tiles = {}
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
        (k2_rows, nbuf, k2_smem), (rows, k3_smem) = k2_layout(stack, dtype), k3_tile(stack, dtype)
        tiles[dname] = {"K2_tile_rows": k2_rows, "K2_weight_buffers": nbuf, "K2_smem_bytes": k2_smem,
                        "K3_tile_rows": rows, "K3_smem_bytes": k3_smem}
    print("phase ar-kernels: tiles " + json.dumps(tiles), flush=True)
    results = {
        "K1": phase_k1({1: batch}, d_out=100 + 3 * 32, name="ar-K1"),
        "K2": phase_k2(batch, mp, name="ar-K2"),
        "K3": phase_k3(batch, mp, name="ar-K3", full_bound=False),
    }
    for kernel, res in results.items():
        for key, r in res.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print("phase ar-kernels: ok " + json.dumps({"batch": fill, "tiles": tiles} | {
        k: {d: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms", "library_ms")}
            for d, r in res.items()}
        for k, res in results.items()
    }))
    return {"batch": fill, "tiles": tiles, **results}


def _ar_model(dev, layers: int, dtype: torch.dtype = torch.float32):
    """The AR model at full width with ``layers`` layers, weights from
    SEED, and a train state (Adam at 1e-4, the experiment's adaptive clip)
    computing in ``dtype``."""
    trainer = build_task_trainer("ar", SEED, dev, num_encoder_layers=layers, precision=16 if dtype == torch.bfloat16 else 32)
    return trainer.model, trainer.state


def phase_ar_check(root: str) -> dict:
    """The AR step at AR_CHECK_LAYERS layers on one pair of 60-100 residues
    (written under ``root``, apart from the fit's, in a bucket of
    AR_CHECK_NODES nodes): fp32 on the card against the CPU
    (card_vs_cpu_step: loss, gradient norm, every gradient, the updated
    parameters by the share apart, as eq-check), then the bf16 step's
    gradients against the fp32 step's on the card (BF16_STEP_TOL)."""
    write_ar_pairs(root, seed=SEED + 1, pairs={"valid": 1}, eval_residues=(60, 100))
    dm = ar_datamodule(root, AR_CHECK_NODES, AR_CHECK_RESIDUES)
    batch = next(dm.val_batches())
    results = {"fp32": card_vs_cpu_step("ar-check", lambda dev: _ar_model(dev, AR_CHECK_LAYERS), batch, ar_loss,
                                        AR_CHECK_LAYERS, params_by_share=True)}
    k1 = 2 * k1_steps("ar", AR_CHECK_LAYERS)[0]
    want = {"K1": k1, "K2": 2 * AR_CHECK_LAYERS, "K3_bf16": AR_CHECK_LAYERS, "K3_fp32": AR_CHECK_LAYERS}
    results["bf16"] = bf16_vs_fp32_step("ar-check", lambda dev, dtype: _ar_model(dev, AR_CHECK_LAYERS, dtype),
                                        batch, ar_loss, want)
    print("phase ar-check: ok")
    return results


def phase_ar_fit(root: str, ckpt_dir: str):
    """The AR path: the full-width AR model at FIT_LAYERS["ar"] layers with the
    experiment's defaults (bf16 over float32 masters, dropout 0, Adam at
    1e-4, seed 42, one decoy a batch) fitted by the Trainer with
    scan_chunk_size FIT_CHUNK for AR_EPOCHS epochs with checkpoints; a new
    Trainer resumes from the last checkpoint to epoch AR_RESUME_EPOCHS and
    tests the best checkpoint: seconds an epoch, train graphs/s, val and
    test RMSE (A) on the synthetic pairs, peak memory.  Beside it the
    deterministic parity run (fit_parity).  Every kernel count is set to 0
    just before the fit and read just after (ar-profile checks them)."""
    build = lambda seed=42, **kw: build_task_trainer(  # noqa: E731
        "ar", seed, "cuda", num_encoder_layers=FIT_LAYERS["ar"], lr=FIT_LR, precision=16, **kw)
    parity = fit_parity(build, ar_datamodule(root), ar_loss)
    dm = ar_datamodule(root)
    clock = EpochClock()
    trainer = build(max_epochs=AR_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[clock], scan_chunk_size=FIT_CHUNK)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    clock.last = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    results = {"launches": dict(zip(KERNEL_COUNTS, launch_counts())), "held_at_start_gb": held_gb,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "steps": trainer.state.step}
    results.update(_fit_record(trainer, clock, None, FIT_LR), parity=parity)
    resumed_clock = EpochClock()
    resumed = build(max_epochs=AR_RESUME_EPOCHS, checkpoint_dir=ckpt_dir, loggers=[resumed_clock],
                    scan_chunk_size=FIT_CHUNK)
    counted = EpochBatches(dm)
    resumed.fit(counted, resume=True)
    # the step the fit ended at, before the best checkpoint's state replaces it
    results["final_step"] = resumed.state.step
    results["resumed_graphs"] = _fit_record(resumed, resumed_clock, None, FIT_LR)["graphs"]
    results["best_step"] = resumed.restore_best()
    results["test"] = test = resumed.test(dm)
    torch.cuda.synchronize()
    epochs = clock.lines + resumed_clock.lines[:-1]
    results["epochs"] = [
        {k: line[k] for k in ("epoch", "seconds", "train/loss", "train/steps_per_sec", "val/loss", "val/RMSE")}
        | {"train_graphs_per_s": line["train/steps_per_sec"]}
        for line in epochs
    ]
    print("phase ar-fit: " + json.dumps(results), flush=True)
    check([line["epoch"] for line in epochs] == list(range(AR_RESUME_EPOCHS)), "ar-fit: epochs run")
    for line in results["epochs"]:
        check(all(math.isfinite(v) for v in line.values()), f"ar-fit: epoch line {line}")
    check(all(math.isfinite(test[f"test/{m}"]) for m in ("loss", "RMSE")), f"ar-fit: test metrics {test}")
    check(results["final_step"] == resumed_step(results["steps"], counted, AR_EPOCHS, AR_RESUME_EPOCHS),
          f"ar-fit: resumed steps, {results['final_step']} after {results['steps']} and {counted.counts}")
    for graphs in (results["graphs"], results["resumed_graphs"]):
        check(graphs["train_held"] <= 2 and graphs["eval_held"] <= 2, f"ar-fit: CUDA graphs held {graphs}")
    print("phase ar-fit: ok")
    return resumed, dm, results


def phase_ar_profile(trainer, dm, fit: dict, data: dict) -> dict:
    """One warm eager AR training step of the fitted model and one replay of
    its captured train and eval chunks under torch.profiler (busy ms, idle
    share, kernels: K2 and the bf16 K3 once a layer a step, K1 as k1_steps
    counts it, no scatter kernel); the host's ms to make a training batch
    (ar-data) against a replayed step's busy ms; then the ar-fit's checks
    that read them (_fit_checks)."""
    layers = model_layers(trainer.model)
    k1 = k1_steps("ar", layers)
    results = _profile_steps(trainer, dm, ar_loss, layers, k1)
    busy = results["profile_captured"]["device_busy_ms"]
    step_ms = busy / FIT_CHUNK if isinstance(busy, float) else float("nan")
    results["step_busy_ms"] = step_ms
    results["host_batch_ms_over_step_busy_ms"] = data["host_ms_per_batch"]["mean"] / step_ms
    print("phase ar-profile: " + json.dumps(results), flush=True)
    _fit_checks("ar-fit", {**fit, **results}, layers, None, k1, k3="K3_bf16")
    print("phase ar-profile: ok")
    return results


def phase_ar_predict(trainer, root: str) -> dict:
    """The fitted model (fp32 copy of its weights) refines one decoy of
    AR_PREDICT_RESIDUES residues through gcpnet_torch.predict.serve: its two
    windows each one batch in a bucket of AR_PREDICT_NODES nodes, served
    by a CUDA graph (Predictor), stitched into one refined PDB and scored
    against the native (TM-score, GDT, MaxSub, RMSD, lDDT); ms a decoy
    (the first decoy captures, a second pass over it replays); K1 and K2
    launched in the first pass (the first window's eager run and capture;
    the second window replays); the served positions of a window against
    an eager forward's (FORWARD_ATOL, relative to their scale; ar-check
    holds the card against the CPU)."""
    inputs, natives, out = (os.path.join(root, d) for d in ("in", "native", "out"))
    write_pair(root, "long", np.random.default_rng(SEED + 3), AR_PREDICT_RESIDUES)
    for d in (inputs, natives):
        os.makedirs(d, exist_ok=True)
    os.replace(os.path.join(root, "AF2_model", "long.pdb"), os.path.join(inputs, "long.pdb"))
    os.replace(os.path.join(root, "true_model", "long.pdb"), os.path.join(natives, "long.pdb"))
    model = copy.deepcopy(trainer.model).float().eval()
    dm = ARDataModule("", "", "", max_nodes_per_batch=AR_PREDICT_NODES, max_residues_per_batch=AR_PREDICT_MAX_RESIDUES,
                      predict_input_dir=inputs, predict_true_dir=natives,
                      esm_cache_dir=os.path.join(root, "model_data_cache", "esm"))
    windows = [_batch_fill(b) for b in dm.predict_batches()]
    dm._predict_meta.clear()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, _ = serve(model, dm, out)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    _, again_ms = serve(model, dm, out)
    batch = next(dm.predict_batches())
    dm._predict_meta.clear()
    served = Predictor(model)
    with torch.inference_mode():
        eager = model(batch.to(torch.device("cuda"))).float().cpu().numpy()
        replayed = served(batch).float().cpu().numpy()
        replayed = served(batch).float().cpu().numpy()
    real = batch.node_pad_mask
    err = float(np.abs(replayed[real] - eager[real]).max())
    scale = float(np.abs(eager[real]).max())
    results = {"windows": windows, "rows": rows, "ms_first_decoy": first_ms, "ms_per_decoy": again_ms[0],
               "launches_first": launches, "served_vs_eager_max_abs": err, "position_scale": scale,
               "bucket": {"nodes": AR_PREDICT_NODES, "edges": AR_PREDICT_NODES * 152}}
    print("phase ar-predict: " + json.dumps(results), flush=True)
    check(len(windows) == 2 and all(w["real_nodes"] <= AR_PREDICT_NODES for w in windows),
          f"ar-predict: windows {windows}")
    check(len(rows) == 1 and os.path.exists(rows[0]["refined_pdb"]), f"ar-predict: rows {rows}")
    for key in ("TM-score", "GDT-TS", "GDT-HA", "MaxSub", "RMSD", "lDDT"):
        check(math.isfinite(rows[0].get(key, float("nan"))), f"ar-predict: score {key} {rows[0]}")
    with open(rows[0]["refined_pdb"]) as f:
        atoms = sum(line.startswith("ATOM") for line in f)
    check(atoms == sum(int(b.extras["overlap_keep_mask"].sum()) for b in dm.predict_batches()),
          f"ar-predict: {atoms} atoms written")
    dm._predict_meta.clear()
    layers = model_layers(model)
    want = {"K1": 2 * k1_steps("ar", layers)[1], "K2": 2 * layers, "K3_bf16": 0, "K3_fp32": 0}
    check(launches == want, f"ar-predict: launches {launches}, want {want} (one window eager and captured)")
    check(err <= FORWARD_ATOL * max(1.0, scale), f"ar-predict: served vs eager {err} at scale {scale}")
    print("phase ar-predict: ok")
    return results


def write_lba_records(root: str, seed: int = SEED, complexes=None, pocket_atoms=LBA_POCKET_ATOMS,
                      ligand_atoms=LBA_LIGAND_ATOMS) -> dict:
    """Synthetic LBA records in the npz format of
    scripts/convert_atom3d_to_npz.py under ``root``
    (``LBA/split-by-sequence-identity-30/data/<split>_npz``; ``complexes``
    per split, default LBA_COMPLEXES): each a ligand, a compact walk of 1.5
    A steps from the origin with drug-like elements, inside a pocket, a
    protein chain at protein packing (_native_chains) with its atoms within
    2.5 A of the ligand removed; ``lig_flag`` marks the ligand's atoms and
    ``label`` is a seeded affinity in pK units that grows with the ligand's
    size.  Returns the complexes per split and their atom counts."""
    rng = np.random.default_rng(seed)
    counts, atoms = {}, []
    for split, n in (complexes or LBA_COMPLEXES).items():
        out = os.path.join(root, "LBA", "split-by-sequence-identity-30", "data", f"{split}_npz")
        os.makedirs(out, exist_ok=True)
        pockets = _native_chains(rng, rng.integers(pocket_atoms[0], pocket_atoms[1] + 1, size=n))
        for i, pocket in enumerate(pockets):
            m = int(rng.integers(ligand_atoms[0], ligand_atoms[1] + 1))
            steps = rng.normal(size=(m, 3))
            ligand = np.cumsum(1.5 * steps / np.linalg.norm(steps, axis=1, keepdims=True), axis=0)
            ligand -= ligand.mean(axis=0)
            gap = np.linalg.norm(pocket[:, None] - ligand[None], axis=-1).min(axis=1)
            pocket = pocket[gap > 2.5]
            elements = np.concatenate([
                rng.choice(np.asarray(["C", "N", "O", "S"]), size=len(pocket), p=[0.62, 0.17, 0.19, 0.02]),
                rng.choice(np.asarray(["C", "N", "O", "F", "Cl", "P"]), size=m, p=[0.7, 0.12, 0.12, 0.03, 0.02, 0.01]),
            ])
            np.savez(
                os.path.join(out, f"{i:04d}.npz"), coords=np.concatenate([pocket, ligand]).astype(np.float32),
                elements=elements, lig_flag=np.r_[np.zeros(len(pocket)), np.ones(m)].astype(np.int32),
                label=np.float32(3.0 + 0.12 * m + rng.normal(0.0, 0.5)),
            )
            atoms.append(len(pocket) + m)
        counts[split] = n
    return {"complexes": counts, "atoms": [int(min(atoms)), float(np.mean(atoms)), int(max(atoms))]}


def cfg_overrides(data_root: str, run_dir: str) -> list:
    """The overrides of cfg-train and cfg-eval: the LBA experiment on the
    records under ``data_root/ATOM3D`` (paths.data_dir), CFG_EPOCHS epochs,
    FIT_CHUNK batches a dispatch, checkpoints and the CSV logger under
    ``run_dir``; the experiment's widths, precision and batch size, and the
    default trainer.accelerator (the card)."""
    return [
        "experiment=gcpnet_lba", f"paths.data_dir={data_root}/", f"paths.output_dir={run_dir}",
        f"trainer.max_epochs={CFG_EPOCHS}", f"+trainer.scan_chunk_size={FIT_CHUNK}",
        f"callbacks.model_checkpoint.dirpath={run_dir}/checkpoints", "logger=csv", "extras.print_config=false",
    ]


def phase_cfg_train(data_root: str, run_dir: str, ahead: WrittenAhead) -> dict:
    """The config-driven training entry point on the card:
    ``gcpnet_torch.train.entry.main`` with experiment=gcpnet_lba on
    synthetic LBA records (write_lba_records, during the build: ``ahead``)
    at the experiment's widths
    (its composed model's parameters named and shaped as a GCPNetLBA built
    directly at the benchmark's widths), fitted for CFG_EPOCHS epochs and
    tested with the best checkpoint.  Every kernel count is set to 0 just
    before main and read just after: K1, K2 and the bf16 K3 ran, as many
    times as the captured graphs' first calls need (_fit_checks); then one
    warm eager step and one replay of a train and an eval chunk under
    torch.profiler (36 / 8 / 8 a step, no scatter kernel); the train
    graphs/s, the captured step's busy ms, peak memory, and the host's ms
    to make a batch."""
    data, write_seconds = ahead.take("lba")
    overrides = cfg_overrides(data_root, run_dir)
    cfg = compose(CONFIG_DIR, "train.yaml", overrides)
    composed, name = tasks.build_model(cfg["model"], device="cuda")
    direct = GCPNetLBA(*lba_configs(), num_atom_types=9, generator=torch.Generator().manual_seed(SEED), device="cuda")
    shapes = [(k, tuple(v.shape)) for k, v in composed.state_dict().items()]
    same_model = name == "GCPNetLBA" and shapes == [(k, tuple(v.shape)) for k, v in direct.state_dict().items()]
    layers = composed.encoder.num_layers
    del composed, direct
    clock, trainers = EpochClock(), []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock.last = t0 = time.perf_counter()
    metrics = train_entry.main(overrides, loggers=[clock], trainers=trainers)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer = trainers[0]
    dm = build_datamodule(cfg["datamodule"], device="cuda")
    dm.setup()
    fills, make_ms, pin_ms = _timed_batches(dm.train_batches(seed=0))
    k1 = k1_steps("lba", layers)
    results = {
        "data": data, "write_seconds": write_seconds, "overrides": overrides, "same_model_as_direct": same_model,
        "layers": layers, "metrics": metrics, "seconds": seconds, "launches": launches, "peak_mem_gb": peak_gb,
        "steps": trainer.state.step, "best_step": trainer.ckpt.best_step,
        "graphs_per_batch": data["complexes"]["train"] / len(fills),
        "host_ms_per_batch": {"mean": float(np.mean(make_ms[1:])), "max": float(np.max(make_ms[1:]))},
        "pin_ms_per_batch": float(np.mean(pin_ms)),
        "fill_mean": {k: float(np.mean([f[k] for f in fills])) for k in ("real_nodes", "real_edges")},
        "in_bucket": all(f["in_bucket"] for f in fills),
        "epochs": [{k: line[k] for k in ("epoch", "seconds", "train/loss", "train/steps_per_sec", "val/loss")}
                   for line in clock.lines if "epoch" in line],
        **_fit_record(trainer, clock, None, FIT_LR),
    }
    results.update(_profile_steps(trainer, dm, graph_regression_loss, layers, k1))
    busy = results["profile_captured"]["device_busy_ms"]
    results["step_busy_ms"] = busy / FIT_CHUNK if isinstance(busy, float) else float("nan")
    results["train_graphs_per_s"] = [line["train/steps_per_sec"] * results["graphs_per_batch"]
                                     for line in results["epochs"]]
    print("phase cfg-train: " + json.dumps(results), flush=True)
    check(same_model, "cfg-train: the composed model is not GCPNetLBA at the benchmark's widths")
    check(layers == 8, f"cfg-train: {layers} interaction layers, the experiment has 8")
    check(results["in_bucket"], "cfg-train: a batch outside the JAX bucket or without its CSR splits")
    check([line["epoch"] for line in results["epochs"]] == list(range(CFG_EPOCHS)), "cfg-train: epochs run")
    for line in results["epochs"]:
        check(all(math.isfinite(v) for v in line.values()), f"cfg-train: epoch line {line}")
    check(all(math.isfinite(metrics[f"test/{m}"]) for m in ("loss", "RMSE", "PearsonCorrCoef")),
          f"cfg-train: test metrics {metrics}")
    check(results["profile"]["launches"] == {"K1": 36, "K2": 8, "K3_bf16": 8, "K3_fp32": 0},
          f"cfg-train: an eager step's launches {results['profile']['launches']}")
    _fit_checks("cfg-train", results, layers, None, k1, k3="K3_bf16", parity_run=False)
    check(os.path.exists(os.path.join(run_dir, "csv", "metrics.csv")), "cfg-train: the CSV logger wrote nothing")
    print("phase cfg-train: ok")
    return results


def phase_cfg_eval(data_root: str, run_dir: str, train: dict) -> dict:
    """The config-driven evaluation entry point on the card:
    ``gcpnet_torch.eval.main`` with cfg-train's overrides and
    ``ckpt_path=<its checkpoints>`` restores the best checkpoint and tests
    it; its test/loss is cfg-train's (the same checkpoint, batches and
    kernels), bit for bit.  The counts are set to 0 just before and read
    just after: K1 and K2 ran, K3 did not."""
    overrides = [*cfg_overrides(data_root, run_dir), f"ckpt_path={run_dir}/checkpoints"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = eval_entry.main(overrides)
    torch.cuda.synchronize()
    results = {"metrics": metrics, "seconds": time.perf_counter() - t0,
               "launches": dict(zip(KERNEL_COUNTS, launch_counts())), "train_test_loss": train["metrics"]["test/loss"]}
    print("phase cfg-eval: " + json.dumps(results), flush=True)
    check(metrics["test/loss"] == train["metrics"]["test/loss"],
          f"cfg-eval: test/loss {metrics['test/loss']!r}, cfg-train's {train['metrics']['test/loss']!r}")
    launches = results["launches"]
    check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3_bf16"] == launches["K3_fp32"] == 0,
          f"cfg-eval: launches {launches}")
    print("phase cfg-eval: ok")
    return results


def phase_cfg_predict(eq_root: str, ckpt_dir: str, work: str) -> dict:
    """The config-driven prediction entry point on the card:
    ``gcpnet_torch.predict.main`` with model=gcpnet_eq datamodule=eq and
    eq-fit's checkpoints serves eq-data's test decoys (each native copied
    under its decoy's name, so the rows carry the true lDDT): one
    b-factor-annotated PDB and one CSV row a decoy; the served per-residue
    lDDT against an eager fp32 forward of the same weights
    (CFG_PREDICT_ATOL); the counts set to 0 just before main and read just
    after (one capture: the first decoy eager and captured, the rest
    replayed)."""
    inputs, natives, out, run_dir = (os.path.join(work, d) for d in ("in", "native", "out", "run"))
    for d in (inputs, natives):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(eq_root, "splits", "test.lst")) as f:
        names = [line.strip() for line in f if line.strip()]
    for name in names:
        shutil.copy(os.path.join(eq_root, "decoy_model", f"{name}.pdb"), os.path.join(inputs, f"{name}.pdb"))
        shutil.copy(os.path.join(eq_root, "true_model", f"{name.split('_')[0]}.pdb"),
                    os.path.join(natives, f"{name}.pdb"))
    overrides = [
        "model=gcpnet_eq", "datamodule=eq", f"ckpt_path={ckpt_dir}", f"datamodule.predict_input_dir={inputs}",
        f"datamodule.predict_true_dir={natives}", f"datamodule.predict_output_dir={out}",
        f"datamodule.model_data_cache_dir={eq_root}/model_data_cache", f"paths.output_dir={run_dir}",
        f"model.model_cfg.num_encoder_layers={FIT_LAYERS['eq']}", "extras.print_config=false",
    ]
    served = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = predict_entry.main(overrides, served=served)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    cfg = compose(CONFIG_DIR, "predict.yaml", overrides)
    model, _ = tasks.build_model(cfg["model"], device="cuda")
    model.load_state_dict(CheckpointManager(ckpt_dir).restore_best(map_location="cuda")["model"])
    model.float().eval()
    errs, bfactor_errs = [], []
    with open(cfg["predictions_csv_path"]) as f:
        rows = list(csv.DictReader(f))
    with torch.inference_mode():
        for (batch, preds), row in zip(served, rows):
            mask = np.asarray(batch.extras["res_mask"]) > 0
            eager = model(batch.to(torch.device("cuda"))).float().cpu().numpy()
            errs.append(float(np.abs(preds[mask] - eager[mask]).max()))
            by_residue, seen = [], set()
            for a in parse_pdb(row["annotated_pdb"], heavy_only=True).atoms:
                if (a.chain, a.resseq, a.icode) not in seen:
                    seen.add((a.chain, a.resseq, a.icode))
                    by_residue.append(a.bfactor)
            bfactor_errs.append(float(np.abs(np.asarray(by_residue) - preds[mask][: len(by_residue)]).max()))
            check(len(by_residue) == int(mask.sum()), f"cfg-predict: {row['decoy']} has {len(by_residue)} residues")
            check(abs(float(row["global_plddt_pred"]) - float(preds[mask].mean())) <= 1e-6,
                  f"cfg-predict: row {row}")
    layers = cfg["model"]["model_cfg"]["num_encoder_layers"]
    want = {"K1": 2 * k1_steps("eq", layers)[1], "K2": 2 * layers, "K3_bf16": 0, "K3_fp32": 0}
    results = {
        "metrics": metrics, "decoys": len(names), "seconds": seconds, "ms_per_decoy": seconds * 1e3 / len(names),
        "launches": launches, "want_launches": want, "served_vs_eager_max_abs": max(errs),
        "bfactor_vs_served_max_abs": max(bfactor_errs), "rows": rows[:2],
        "mean_true_lddt": float(np.mean([float(r["global_lddt_true"]) for r in rows])),
    }
    print("phase cfg-predict: " + json.dumps(results), flush=True)
    check(metrics["num_predictions"] == len(names) == len(rows) == len(served), f"cfg-predict: {len(rows)} rows")
    check(sorted(r["decoy"] for r in rows) == sorted(f"{n}.pdb" for n in names), "cfg-predict: the rows' decoys")
    check(sorted(rows[0]) == ["annotated_pdb", "decoy", "global_lddt_true", "global_plddt_pred"],
          f"cfg-predict: CSV columns {sorted(rows[0])}")
    check(all(os.path.exists(r["annotated_pdb"]) for r in rows), "cfg-predict: a PDB is missing")
    check(max(bfactor_errs) <= 0.005 + 1e-6, f"cfg-predict: b-factors off the served values by {max(bfactor_errs)}")
    check(max(errs) <= CFG_PREDICT_ATOL, f"cfg-predict: served vs eager {max(errs)}")
    check(launches == want, f"cfg-predict: launches {launches}, want {want} (one decoy eager and captured)")
    print("phase cfg-predict: ok")
    return results


def _gcp_outputs(model, batch) -> list:
    """Every GCP module's output of one eager fp32 forward of ``model`` on
    ``batch`` (no dropout), caught by forward hooks: ``(class name, scalars,
    vectors or None)``."""
    caught, hooks = [], []

    def hook(module, _args, out):
        scalar, vector = (out.scalar, out.vector) if isinstance(out, tuple) else (out, None)
        caught.append((type(module).__name__, scalar.detach(), None if vector is None else vector.detach()))

    for module in model.modules():
        if type(module).__name__ in GCP_FAMILY_CLASSES:
            hooks.append(module.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return caught


def _ablated_channel(name: str, model, batch) -> dict:
    """Whether a run's setting really holds in its trained model, on one
    eager fp32 forward: ablate_scalars / ablate_vectors: every GCP's output
    scalars / vectors are zeros; ablate_frame_updates: the prediction does
    not move when the atoms move (the frames are the model's only use of
    the positions), bit for bit; the GCP classes of GCP v1's and the frame
    gate's runs."""
    model.eval()
    outs = _gcp_outputs(model, batch)
    result = {"gcps": len(outs), "classes": sorted({c for c, _, _ in outs})}
    if name == "ablate_scalars":
        result["nonzero_scalars"] = sum(int(torch.count_nonzero(s)) for _, s, _ in outs)
        result["nonzero_vectors"] = sum(int(torch.count_nonzero(v)) for _, _, v in outs if v is not None)
        result["holds"] = result["nonzero_scalars"] == 0 and result["nonzero_vectors"] > 0
    elif name == "ablate_vectors":
        result["nonzero_vectors"] = sum(int(torch.count_nonzero(v)) for _, _, v in outs if v is not None)
        result["nonzero_scalars"] = sum(int(torch.count_nonzero(s)) for _, s, _ in outs)
        result["holds"] = result["nonzero_vectors"] == 0 and result["nonzero_scalars"] > 0
    elif name == "ablate_frame_updates":
        gen = torch.Generator(device=batch.x.device).manual_seed(SEED)
        moved = batch.replace(x=batch.x + torch.randn(batch.x.shape, generator=gen, device=batch.x.device))
        with torch.no_grad():
            a, b = model(batch), model(moved)
        result["prediction_moved_by"] = (a - b).abs().max().item()
        result["holds"] = torch.equal(a, b)
    elif name == "gcp1_sigma_frame_gate":
        result["holds"] = result["classes"] == ["GCP"] and all(
            hasattr(m, "vector_out_scale_sigma_frames") for m in model.modules()
            if type(m).__name__ == "GCP" and m.output_dims[1] and m.input_dims[1])
    else:
        result["holds"] = result["classes"] == ["GCP2"] and any(hasattr(m, "vector_up_frames") for m in model.modules())
    model.train()
    return result


def _captured_fit(name: str, overrides: list, ckpt_dir: str, train: list) -> dict:
    """One captured fit through ``gcpnet_torch.train``'s main with
    ``overrides`` and FAMILY_CHUNK batches a replay (the first runs eagerly
    and captures, the rest replay), every count set to 0 just before and
    read just after; then one replay of ``train`` (FAMILY_CHUNK pinned
    host batches of the fit's shapes; captured first
    where the test's checkpoint restore dropped the graphs) under
    torch.profiler: busy ms, idle share, and the K1-K3 launches and scatters
    read from its graph's kernel nodes.  Held: the losses finite, no
    scatter kernel in the replay, a replayed chunk in the fit and none
    captured anew for the profile."""
    overrides = [*overrides, f"paths.output_dir={ckpt_dir}", f"callbacks.model_checkpoint.dirpath={ckpt_dir}",
                 "extras.print_config=false"]
    trainers = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = train_entry.main(overrides, trainers=trainers)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer = trainers[0]
    fit_steps, call = trainer.state.step, trainer.train_graphs.call
    replays = call.replays
    trainer.train_graphs(train)  # warm, and captured again where the test's restore dropped the graphs
    captures = call.captures
    t1 = time.perf_counter()
    profile = profile_replay(lambda: trainer.train_graphs(train), call, train)
    profile_seconds = time.perf_counter() - t1
    steps = profile["launches"]
    busy = profile["device_busy_ms"]
    results = {
        "overrides": overrides, "metrics": metrics, "seconds": seconds, "profile_seconds": profile_seconds,
        "launches": launches, "peak_mem_gb": peak_gb, "steps": fit_steps, "fit_replays": replays,
        "step_busy_ms": busy / FAMILY_CHUNK if isinstance(busy, float) else busy,
        "device_idle_share": profile["device_idle_share"],
        "launches_per_step": {k: v / FAMILY_CHUNK for k, v in steps.items()},
        "profile_captured": profile,
        "model": trainer.model,
    }
    # a correlation can be NaN: the scalar ablation's prediction is constant
    losses = {k: v for k, v in metrics.items() if k.endswith("/loss")}
    check(len(losses) >= 2 and all(math.isfinite(v) for v in losses.values()), f"{name}: losses {metrics}")
    check(not profile["scatters"], f"{name}: scatter kernels in a replay: {profile['scatters']}")
    check(replays >= 1 and call.captures == captures,
          f"{name}: {replays} replayed training chunks in the fit, or the profiled chunk captured anew")
    return results


def _plain_fit(name: str, overrides: list, ckpt_dir: str, train: list) -> dict:
    """_captured_fit of a run whose message stacks are plain (outside
    K2/K3's layer table): K1 runs, K2 and K3 never."""
    results = _captured_fit(name, overrides, ckpt_dir, train)
    launches, steps = results["launches"], results["launches_per_step"]
    check(launches["K1"] > 0 and launches["K2"] == launches["K3_bf16"] == launches["K3_fp32"] == 0,
          f"{name}: the run's launches {launches}: K1 runs, K2 and K3 never")
    check(steps["K1"] > 0 and steps["K2"] == steps["K3_bf16"] == steps["K3_fp32"] == 0,
          f"{name}: a replay's launches {steps}")
    return results


def _public(results: dict) -> dict:
    return {k: v for k, v in results.items() if k != "model"}


def phase_gcp_family(data_root: str, run_dir: str) -> dict:
    """The rest of the GCP family through ``gcpnet_torch.train``'s main, at
    full width: experiment=gcpnet_lba_ablations (GCP_FAMILY_LAYERS of its 8
    interaction layers, each of 8 message layers, 100/16/32/4,
    bf16 over float32 masters, batch 16, the JAX bucket) on cfg-train's
    synthetic LBA records, once for each of GCP_FAMILY_RUNS (the frame,
    scalar and vector ablations, GCP v1 with the sigma frame gate, GCP2
    with the frame gate), GCP_FAMILY_STEPS training batches and one epoch
    each (_plain_fit: the losses finite, K2 = K3 = 0 and K1 > 0 a step, no
    scatter; no test loop); each setting holds in the trained model
    (_ablated_channel);
    and one fp32 step of the frame-ablated model (GCP_FAMILY_CHECK_LAYERS
    layers, the train-check's batch) on the card against the CPU."""
    base = ["experiment=gcpnet_lba_ablations", f"paths.data_dir={data_root}/", "trainer.max_epochs=1", "test=false",
            f"model.model_cfg.num_encoder_layers={GCP_FAMILY_LAYERS}", f"+trainer.limit_train_batches={GCP_FAMILY_STEPS}",
            f"+trainer.scan_chunk_size={FAMILY_CHUNK}"]
    dm = build_datamodule(compose(CONFIG_DIR, "train.yaml", base)["datamodule"], device="cuda")
    dm.setup()
    train = [b.pinned() for b in itertools.islice(dm.train_batches(seed=0), FAMILY_CHUNK)]
    batch = next(iter(dm.val_batches())).to(torch.device("cuda"))
    del dm
    results = {}
    for name, flags in GCP_FAMILY_RUNS.items():
        t0 = time.perf_counter()
        run = _plain_fit(f"gcp-family {name}", [*base, *flags], os.path.join(run_dir, name), train)
        run["setting"] = _ablated_channel(name, run["model"], batch)
        run["run_seconds"] = time.perf_counter() - t0
        results[name] = _public(run)
        del run
        print(f"phase gcp-family {name}: " + json.dumps(results[name]), flush=True)
        check(results[name]["setting"]["holds"], f"gcp-family {name}: the setting does not hold: "
              f"{results[name]['setting']}")
        check(results[name]["steps"] == GCP_FAMILY_STEPS, f"gcp-family {name}: {results[name]['steps']} steps")

    def build(dev):
        model_cfg, module_cfg, layer_cfg = lba_configs()
        model = GCPNetLBA(
            model_cfg.replace(dropout=0.0, dense_dropout=0.0, num_encoder_layers=GCP_FAMILY_CHECK_LAYERS),
            module_cfg.replace(ablate_frame_updates=True), layer_cfg, num_atom_types=9,
            generator=torch.Generator().manual_seed(SEED), device=dev,
        ).train()
        return model, TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}))

    batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0]
    results["check"] = card_vs_cpu_step("gcp-family-check", build, batch, graph_regression_loss,
                                        GCP_FAMILY_CHECK_LAYERS, fp32_k3=0)
    print("phase gcp-family: ok")
    return results


# --- budget batching, CA-only graphs and layer_class overrides -------------------

OVERRIDE_STEPS = 2  # training batches a run: the first runs eagerly and captures, the second replays
OVERRIDE_CHECK_LAYERS = 2
PSR_MAX_UNITS = 262144  # datamodule.max_units of the PSR run: edge rows a batch may hold


@contextlib.contextmanager
def recorded_batches(target: str, fills: list):
    """Inside, the registry's ``target`` datamodule records each batch it
    makes into ``fills``: _batch_fill, its shape, whether it has CSR
    splits, and its residues where it has a residue mask."""
    base = datamodule_registry.DATAMODULES[target]

    class Recording(base):
        def batches(self, *args, **kw):
            for b in super().batches(*args, **kw):
                fill = {**_batch_fill(b), "shape": [b.num_nodes, b.num_edges], "csr": b.edge_row_splits is not None}
                if "res_mask" in b.extras:
                    fill["residues"] = int(np.sum(b.extras["res_mask"]))
                fills.append(fill)
                yield b

    datamodule_registry.DATAMODULES[target] = Recording
    try:
        yield
    finally:
        datamodule_registry.DATAMODULES[target] = base


def _override_fit(name: str, overrides: list, run_dir: str, target: str, layer_class: str) -> tuple:
    """A short fit through ``gcpnet_torch.train``'s main with ``overrides``,
    at the experiment's width and depth: OVERRIDE_STEPS training batches
    (the first eager and captured, the next replayed) and the validation,
    no test; every count set to 0 just before main and read just after,
    every batch the ``target`` datamodule made recorded
    (recorded_batches).  Held: the losses finite, the trunk built of
    ``layer_class``, K1, K2 and the bf16 K3 launched, at most two CUDA
    graphs held a split.  Returns the results and every batch's fill."""
    overrides = [*overrides, "trainer.max_epochs=1", "trainer.min_epochs=0", "test=false",
                 f"+trainer.limit_train_batches={OVERRIDE_STEPS}", f"paths.output_dir={run_dir}",
                 f"callbacks.model_checkpoint.dirpath={run_dir}", "extras.print_config=false"]
    trainers, fills = [], []
    gc.collect()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with recorded_batches(target, fills):
        metrics = train_entry.main(overrides, trainers=trainers)
    torch.cuda.synchronize()
    trainer = trainers[0]
    results = {
        "overrides": overrides, "metrics": metrics, "seconds": time.perf_counter() - t0,
        "launches": dict(zip(KERNEL_COUNTS, launch_counts())), "steps": trainer.state.step,
        "layer_class": type(trainer.model.encoder.interaction_0).__name__, "layers": model_layers(trainer.model),
        "batches": len(fills), "fills": fills[:4], **_fit_record(trainer, None, None, FIT_LR),
    }
    launches, graphs = results["launches"], results["graphs"]
    print(f"phase overrides {name}: " + json.dumps(results), flush=True)
    check(all(math.isfinite(metrics.get(k, float("nan"))) for k in ("train/loss", "val/loss")),
          f"overrides {name}: losses {metrics}")
    check(results["layer_class"] == layer_class, f"overrides {name}: the trunk is {results['layer_class']}")
    check(results["steps"] == OVERRIDE_STEPS, f"overrides {name}: {results['steps']} steps")
    check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3_bf16"] > 0 and launches["K3_fp32"] == 0,
          f"overrides {name}: launches {launches}")
    check(graphs["train_held"] <= 2 and graphs["eval_held"] <= 2, f"overrides {name}: CUDA graphs held {graphs}")
    check(fills and all(f["csr"] for f in fills), f"overrides {name}: a batch without CSR splits")
    return results, fills


def _layer_class_model(task: str, layer_class: str, dev):
    """``task``'s experiment on ``layer_class`` at full width and
    OVERRIDE_CHECK_LAYERS layers, no dropout, float32: (model, state)."""
    trainer = build_task_trainer(task, SEED, dev, num_encoder_layers=OVERRIDE_CHECK_LAYERS, dropout=0.0,
                                 precision=32, layer_class=layer_class)
    return trainer.model, trainer.state


def phase_overrides(psr_root: str, eq_root: str, eq_check_root: str, cfg_root: str, run_dir: str) -> dict:
    """Datamodule and model settings of the config-driven entry point that
    the experiments leave off, each a short fit through
    ``gcpnet_torch.train``'s main (_override_fit):

    - PSR on psr-data's records under an edge budget
      (``datamodule.max_units=PSR_MAX_UNITS``): every batch the datamodule
      made of the JAX module's ``make_bucket`` shape, its real rows within
      the budget;
    - EQ's CA-only graphs (``datamodule.subset_to_ca_atoms_only=true``) of
      eq-data's decoys: one node a residue, cached as ``<name>_ca``;
    - LBA on ``GCPInteractions2`` on cfg-train's records, and EQ on
      ``GCPInteractions`` on eq-data's decoys (``model.layer_class``), each
      beside one float32 step at OVERRIDE_CHECK_LAYERS layers on the card
      against the CPU (card_vs_cpu_step, as train-check and eq-check),
      through K1-K3."""
    results = {}
    psr = ["experiment=gcpnet_psr", f"datamodule.data_dir={psr_root}", f"datamodule.max_units={PSR_MAX_UNITS}"]
    run, fills = _override_fit("psr-budget", psr, os.path.join(run_dir, "psr"), "ATOM3DDataModule", "GCPInteractions")
    block = compose(CONFIG_DIR, "train.yaml", psr)["datamodule"]
    bucket = make_bucket(PSR_MAX_UNITS, "edge", int(block["batch_size"]), avg_degree=int(block["max_neighbors"]))
    check(all(f["shape"] == [bucket.num_nodes, bucket.num_edges] and f["real_edges"] <= PSR_MAX_UNITS
              for f in fills), f"overrides psr-budget: a batch outside the budget's bucket {bucket}")
    results["psr_budget"] = {**run, "bucket": [bucket.num_nodes, bucket.num_edges, bucket.num_graphs]}

    eq_dirs = [f"datamodule.{k}={os.path.join(eq_root, d)}" for k, d in (
        ("splits_dir", "splits"), ("decoy_dir", "decoy_model"), ("true_dir", "true_model"),
        ("model_data_cache_dir", "model_data_cache"))]
    with required_esm():
        run, fills = _override_fit("eq-ca-only", ["experiment=gcpnet_eq", *eq_dirs,
                                                  "datamodule.subset_to_ca_atoms_only=true"],
                                   os.path.join(run_dir, "eq_ca"), "EQDataModule", "GCPInteractions2")
    cached = [n for n in os.listdir(os.path.join(eq_root, "model_data_cache")) if n.endswith("_ca.graph.npz")]
    check(all(f["real_nodes"] == f["residues"] for f in fills),
          "overrides eq-ca-only: a batch with other nodes than its residues' CA atoms")
    check(len(cached) > 0, "overrides eq-ca-only: no CA-only graph cached")
    results["eq_ca_only"] = {**run, "cached_ca_graphs": len(cached)}

    lba = ["experiment=gcpnet_lba", f"paths.data_dir={cfg_root}/", "model.layer_class._target_=GCPInteractions2"]
    run, _ = _override_fit("lba-interactions2", lba, os.path.join(run_dir, "lba"), "ATOM3DDataModule",
                           "GCPInteractions2")
    batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0]
    run["check"] = card_vs_cpu_step("overrides lba-interactions2-check",
                                    lambda dev: _layer_class_model("lba", "GCPInteractions2", dev), batch,
                                    graph_regression_loss, OVERRIDE_CHECK_LAYERS)
    results["lba_interactions2"] = run

    with required_esm():
        run, _ = _override_fit("eq-interactions", ["experiment=gcpnet_eq", *eq_dirs,
                                                   "model.layer_class._target_=GCPInteractions"],
                               os.path.join(run_dir, "eq"), "EQDataModule", "GCPInteractions")
    batch = next(eq_datamodule(eq_check_root, EQ_CHECK_NODES, EQ_CHECK_RESIDUES).val_batches())
    run["check"] = card_vs_cpu_step("overrides eq-interactions-check",
                                    lambda dev: _layer_class_model("eq", "GCPInteractions", dev), batch, eq_loss,
                                    OVERRIDE_CHECK_LAYERS, params_by_share=True)
    results["eq_interactions"] = run
    print("phase overrides: ok")
    return results


# --- every activation of the layer table through K2/K3 -------------------------

# The acts phase's message stacks: LBA's 8 layers at 100/16/32/4 with the
# transcendental codes, each as the scalar and as the vector activation,
# under both gates: name -> (scalar activation, vector activation, vector
# gate).  The first two are also fitted through the entry point.
ACT_STACKS = {
    "gelu_sigmoid": ("gelu", "sigmoid", True),  # the LBA default gate
    "selu_tanh": ("selu", "tanh", True),
    "sigmoid_gelu_norm": ("sigmoid", "gelu", False),
    "tanh_selu_norm": ("tanh", "selu", False),
}
ACT_FITS = ("gelu_sigmoid", "selu_tanh")
ACTS_CHECK_LAYERS = 2


def act_message_passing(scalar: str, vector: str, gate: bool) -> GCPMessagePassing:
    """bench_message_passing's layer (8 GCP2 layers, hidden 100/16, edges
    32/4) with these activations and gate."""
    model_cfg, module_cfg, layer_cfg = lba_configs()
    cfg = module_cfg.replace(scalar_nonlinearity=scalar, vector_nonlinearity=vector, vector_gate=gate)
    node_dims = (model_cfg.h_hidden_dim, model_cfg.chi_hidden_dim)
    edge_dims = (model_cfg.e_hidden_dim, model_cfg.xi_hidden_dim)
    return GCPMessagePassing(
        node_dims, node_dims, edge_dims, cfg, layer_cfg, generator=torch.Generator().manual_seed(SEED), device="cuda",
    )


def act_kernels(name: str, batch, mp: GCPMessagePassing) -> dict:
    """K2 and K3 with ``mp``'s stack at the main path's rows, fp32 and bf16,
    against their plain versions at phase K2's and K3's bounds: K2 to TOL,
    bf16 K2 against the plain version in float32 on the same bf16 inputs
    (as K3's upcast check), its distance from the plain bf16 version beside
    it: the plain bf16 version rounds each elementwise step to bf16, and at
    these rows its own distance from float32 reaches the bound (on the
    H100, at the sigmoid / gelu norm-gate stack's worst element plain bf16
    reads -12.0, float32 -12.235, the kernel -12.25; over all elements the
    plain bf16 version parts from float32 by 0.0190 of scale, the kernel by
    0.0151, and the two from each other by 0.0202); bf16 K3 leaf by leaf to
    TOL and to K3_UPCAST_TOL against the float32 plain version; float32 K3
    under the kink rule (the rows that part from
    the plain version by more than 1e-4 of scale each hold a kink margin
    under KINK_MARGIN, at most max_kink_rows of them; with their cotangents
    set to 0 every leaf within K3_KINK_FREE_TOL) and, beside it, each leaf
    to TOL.  Each kernel's ms a call (CUDA events), its bound and its
    share of the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    e = batch.num_edges
    results = {}
    for dname, dtype in DTYPES.items():
        with torch.no_grad():
            stack = mp.to(dtype).packed_stack()
            message, frames = stack_inputs(batch, stack, dtype, gen)
            got = edge_map(message, frames, stack)
            plain = edge_map_plain(message, frames, stack)
            k2_err, k2_rel = rel_err(got, plain)
            # the bf16 stack's weights are float32 copies of bf16 values
            plain_f32 = edge_map_plain(message.float(), frames.float(), stack)
            _, k2_rel_f32 = rel_err(got, plain_f32)
            # the element where kernel and plain version part most: both, and float32's value
            at = int((got.float() - plain.float()).abs().argmax())
            k2_worst = [float(t.flatten()[at]) for t in (got, plain, plain_f32)]
            finite = bool(torch.isfinite(got).all())
            del got, plain, plain_f32
        held = k2_rel if dtype == torch.float32 else k2_rel_f32
        check(finite and held <= TOL[("K2", dname)],
              f"acts {name} K2 {dname}: rel err {k2_rel:.3g} vs plain, {k2_rel_f32:.3g} vs float32 plain, finite {finite}")
        grad_out = torch.randn((e, stack.out_dim), generator=gen, device="cuda").to(dtype)
        k3 = k3_leaves(message, frames, stack, grad_out, upcast=dtype == torch.bfloat16)
        bad = {leaf: errs for leaf, errs in k3["leaves"].items()
               if errs["vs_plain"] > TOL[("K3", dname)] or errs.get("vs_upcast", 0.0) > K3_UPCAST_TOL}
        check(not bad, f"acts {name} K3 {dname}: leaves past their bounds {bad}")
        if dtype == torch.float32:
            d_msg, _ = edge_map_backward(message, frames, stack, grad_out)
            ref_msg, _ = edge_map_backward_plain(message, frames, stack, grad_out)
            scale = max(1.0, ref_msg.abs().max().item())
            kinks = ((d_msg - ref_msg).abs().amax(dim=1) > 1e-4 * scale).nonzero().flatten()
            del d_msg, ref_msg
            margins = kink_margins(message[kinks], frames[kinks], stack).tolist() if kinks.numel() else []
            k3["kinks"] = {"kink_rows": kinks.tolist(), "kink_row_margins": margins,
                           "max_kink_rows": max_kink_rows(e)}
            check(kinks.numel() <= max_kink_rows(e) and all(m <= KINK_MARGIN for m in margins),
                  f"acts {name} K3 {dname}: rows {kinks.tolist()} part from plain, kink margins {margins}")
            kink_free = grad_out.clone()
            kink_free[kinks] = 0.0
            k3["kink_free"] = k3_leaves(message, frames, stack, kink_free, upcast=False)
            del kink_free
            worst = max(errs["vs_plain"] for errs in k3["kink_free"]["leaves"].values())
            check(worst <= K3_KINK_FREE_TOL, f"acts {name} K3 {dname}: kink-free leaf norm rel err {worst:.3g}")
        for key in ("d_message", "d_weights"):
            check(k3[key]["finite"], f"acts {name} K3 {dname}: non-finite {key}")
        es = message.element_size()
        w = stack.weights.numel() * 4
        flops = e * stack_flops(stack)
        k2_bound, k2_by, _ = route_bound_ms(e * (stack.in_dim + 9 + stack.out_dim) * es + w, flops, dtype)
        k3_bound, k3_by, _ = route_bound_ms(e * (2 * stack.in_dim + 9 + stack.out_dim) * es + 2 * w, 3 * flops,
                                            dtype)
        with torch.no_grad():
            k2_ms = cuda_ms(lambda: edge_map(message, frames, stack), iters=10)
        k3_ms = cuda_ms(lambda: edge_map_backward(message, frames, stack, grad_out), iters=5, warmup=1)
        results[dname] = {
            "K2": {"max_abs_err": k2_err, "rel_err": k2_rel, "rel_err_vs_float32_plain": k2_rel_f32,
                   "worst_element_kernel_plain_float32": k2_worst, "ms": k2_ms,
                   "bound_ms": k2_bound, "bound_by": k2_by, "share_of_bound": k2_bound / k2_ms},
            "K3": {"max_abs_err": max(k3["d_message"]["max_abs_err"], k3["d_weights"]["max_abs_err"]),
                   "worst_leaf_vs_plain": max(errs["vs_plain"] for errs in k3["leaves"].values()),
                   **({"worst_leaf_vs_upcast": max(errs["vs_upcast"] for errs in k3["leaves"].values())}
                      if dtype == torch.bfloat16 else {"kinks": k3["kinks"]}),
                   "ms": k3_ms, "bound_ms": k3_bound, "bound_by": k3_by, "share_of_bound": k3_bound / k3_ms},
        }
        del message, frames, grad_out, k3
    return results


def phase_acts(batch, cfg_root: str, run_dir: str, smi: str) -> dict:
    """Every transcendental activation of the layer table (selu, gelu,
    sigmoid, tanh; silu is AR's) through K2 and K3 on the main path:

    - act_kernels for each of ACT_STACKS at the main path's 208,896 rows;
    - for each of ACT_FITS, a short fit through ``gcpnet_torch.train``'s
      main at the experiment's width and depth (experiment=gcpnet_lba with
      model.module_cfg.scalar_nonlinearity and vector_nonlinearity set:
      8 x 8 layers, 100/16/32/4, bf16 over float32 masters, the JAX
      bucket) on cfg-train's records, as the overrides phase runs its fits:
      OVERRIDE_STEPS training batches (the first eager and captured, the
      second replayed) and the validation (_captured_fit); a replay's
      kernel nodes hold K1, K2 and K3 as cfg-train's (36 / 8 / 8 a step),
      no scatter; the trained model's stacks carry the activations; then
      one fp32 step at ACTS_CHECK_LAYERS layers on the card against the
      CPU (card_vs_cpu_step).

    ``smi`` is the card's name and power limit, printed beside the times."""
    results = {"card": smi, "kernels": {}}
    for name, (scalar, vector, gate) in ACT_STACKS.items():
        results["kernels"][name] = act_kernels(name, batch, act_message_passing(scalar, vector, gate))
        print(f"phase acts {name}: " + json.dumps({"card": smi, **results["kernels"][name]}), flush=True)
        torch.cuda.empty_cache()
    base = ["experiment=gcpnet_lba", f"paths.data_dir={cfg_root}/", "trainer.max_epochs=1", "trainer.min_epochs=0",
            "test=false", f"+trainer.limit_train_batches={OVERRIDE_STEPS}", f"+trainer.scan_chunk_size={FAMILY_CHUNK}"]
    dm = build_datamodule(compose(CONFIG_DIR, "train.yaml", base)["datamodule"], device="cuda")
    dm.setup()
    train = [b.pinned() for b in itertools.islice(dm.train_batches(seed=0), FAMILY_CHUNK)]
    del dm
    k1 = k1_steps("lba", 8)[0]
    want = {"K1": k1, "K2": 8, "K3_bf16": 8, "K3_fp32": 0}
    check_batch = synthetic_batches(1, TRAIN_CHECK_GRAPHS, NODES, EDGES_PER_NODE, SEED + 5)[0]
    for name in ACT_FITS:
        scalar, vector, gate = ACT_STACKS[name]
        acts = [f"model.module_cfg.scalar_nonlinearity={scalar}", f"model.module_cfg.vector_nonlinearity={vector}"]
        run = _captured_fit(f"acts {name}", [*base, *acts], os.path.join(run_dir, name), train)
        model = run.pop("model")
        run["layers"] = model_layers(model)
        run["stack_activations"] = sorted({(m.settings.scalar_nonlinearity, m.settings.vector_nonlinearity)
                                           for mp in model.modules() if isinstance(mp, GCPMessagePassing)
                                           for m in mp.stack}, key=str)
        del model
        print(f"phase acts {name} fit: " + json.dumps(run), flush=True)
        launches = run["launches"]
        check(run["steps"] == OVERRIDE_STEPS and run["layers"] == 8,
              f"acts {name}: {run['steps']} steps at {run['layers']} layers")
        check((scalar, vector) in [tuple(a) for a in run["stack_activations"]],
              f"acts {name}: the model's stacks take {run['stack_activations']}")
        check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3_bf16"] > 0 and launches["K3_fp32"] == 0,
              f"acts {name}: the run's launches {launches}")
        check(run["launches_per_step"] == want, f"acts {name}: a replay's launches {run['launches_per_step']}, "
              f"want {want}")

        def build(dev, scalar=scalar, vector=vector, gate=gate):
            model_cfg, module_cfg, layer_cfg = lba_configs()
            model = GCPNetLBA(
                model_cfg.replace(dropout=0.0, dense_dropout=0.0, num_encoder_layers=ACTS_CHECK_LAYERS),
                module_cfg.replace(scalar_nonlinearity=scalar, vector_nonlinearity=vector, vector_gate=gate),
                layer_cfg, num_atom_types=9, generator=torch.Generator().manual_seed(SEED), device=dev,
            ).train()
            return model, TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}))

        run["check"] = card_vs_cpu_step(f"acts {name}-check", build, check_batch, graph_regression_loss,
                                        ACTS_CHECK_LAYERS)
        results[name] = run
    print("phase acts: ok")
    return results


def phase_rs_e3(rs_dm, ckpt_dir: str) -> dict:
    """E(3) RS at full width (experiment=gcpnet_rs with
    model.module_cfg.enable_e3_equivariance=true, composed and built as the
    entry point builds it) in fp32: on the first test batch of rs-data's
    synthetic splits (in order, so graphs 2k and 2k+1 are an enantiomer
    pair, one the other's mirror image through x), the E(3) model gives
    both graphs of every pair the same logit within RS_PAIR_ATOL of the
    pair's magnitude; the SE(3) model with the same weights tells them
    apart (the median pair over the bound, the largest ten times over).
    K2 does not run in the E(3) forward, and does in the SE(3) one.  Then a
    captured fit in fp32, as rs-fit (_plain_fit: RS_E3_STEPS training
    batches, its validation and test accuracy)."""
    flag = "model.module_cfg.enable_e3_equivariance"
    host = next(rs_dm.batches("test"))
    real = int(np.asarray(host.graph_pad_mask).sum())
    batch = host.to(torch.device("cuda"))
    gaps, k2 = {}, {}
    for e3 in (True, False):
        cfg = compose(CONFIG_DIR, "train.yaml", ["experiment=gcpnet_rs", f"{flag}={str(e3).lower()}"])
        model, _ = tasks.build_model(cfg["model"], seed=42, device="cuda")
        model.eval()
        reset_counts()
        with torch.no_grad():
            logits = model(batch).float().cpu().numpy()[:real].reshape(-1, 2)
        k2[e3] = launch_counts()[1]
        gaps[e3] = np.abs(logits[:, 0] - logits[:, 1]) / np.maximum(np.abs(logits).max(axis=1), 1.0)
        del model
    train = [b.pinned() for b in itertools.islice(rs_dm.train_batches(seed=0), FAMILY_CHUNK)]
    fit = _plain_fit("rs-e3", [
        "experiment=gcpnet_rs", f"{flag}=true", "trainer.precision=32", "trainer.max_epochs=1",
        f"+trainer.limit_train_batches={RS_E3_STEPS}", f"+trainer.scan_chunk_size={FAMILY_CHUNK}",
    ], ckpt_dir, train)
    results = {
        "pairs": real // 2, "e3_max_gap": float(gaps[True].max()), "se3_median_gap": float(np.median(gaps[False])),
        "se3_max_gap": float(gaps[False].max()), "se3_min_gap": float(gaps[False].min()),
        "k2_launches": {"e3": k2[True], "se3": k2[False]}, "fit": _public(fit),
    }
    print("phase rs-e3: " + json.dumps(results), flush=True)
    check(real == 128, f"rs-e3: {real} graphs in the test batch")
    check(results["e3_max_gap"] <= RS_PAIR_ATOL, f"rs-e3: E(3) pairs apart by {results['e3_max_gap']}")
    check(results["se3_median_gap"] > RS_PAIR_ATOL and results["se3_max_gap"] > 10 * RS_PAIR_ATOL,
          f"rs-e3: SE(3) pairs not told apart: {results}")
    check(k2[True] == 0 and k2[False] > 0, f"rs-e3: K2 launches {k2}")
    check(all(math.isfinite(fit["metrics"][f"test/{m}"]) for m in ("loss", "Accuracy")), f"rs-e3: {fit['metrics']}")
    check(fit["steps"] == RS_E3_STEPS, f"rs-e3: {fit['steps']} steps")
    print("phase rs-e3: ok")
    return results


# --- ESM-2 ------------------------------------------------------------------------

ESM_SIZE = "t33_650M"
ESM_TIMED_RESIDUES = 250  # beside AR's prediction decoy (AR_PREDICT_RESIDUES)
ESM_CHECK_RESIDUES = (64, 250)
ESM_CARD_CPU_ATOL = 1e-3  # float32 on both, TF32 off: the card's and the CPU's sums in other orders


def fairesm_state_dict(model: nn_esm.ESM2) -> dict:
    """The port's ESM-2 weights as a fair-esm checkpoint's ``model`` holds
    them: ``encoder.sentence_encoder.`` names, ``[out, in]`` weights."""
    sd = {}
    for key, value in model.state_dict().items():
        *path, leaf = key.replace("layers_", "layers.").split(".")
        if leaf == "kernel":
            value = value.t()
        sd[".".join(["encoder", "sentence_encoder", *path, "bias" if leaf == "bias" else "weight"])] = (
            value.detach().contiguous().cpu())
    return sd


def _random_sequence(rng: np.random.Generator, n: int) -> str:
    return "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))


def phase_esm(eq_root: str, work: str, ahead: WrittenAhead) -> dict:
    """ESM-2 650M (ESM2Config.t33_650M) with random weights from SEED,
    initialised as the transformers library's ESM-2 is, written as a
    fair-esm-shaped checkpoint (with its ``args`` Namespace) and loaded
    back through data.esm's checkpoint tier (GCPNET_ESM_CHECKPOINT) on the
    card: the weights equal to those written; ms a sequence at
    ESM_TIMED_RESIDUES residues and at AR's 1,600-residue prediction decoy
    (its sequence; CUDA events around embed_sequence, the copy to the host
    included) and peak memory; the card against the CPU on the same weights
    at ESM_CHECK_RESIDUES residues with TF32 off, within ESM_CARD_CPU_ATOL.
    Then EQ's synthetic decoys (written during the build: ``ahead``;
    eq-data featurizes them) get
    the model's embeddings in place of their seeded cache, through the
    datamodule's ahead-of-time tier (EQDataModule.prepare_embeddings) on
    the card, and a decoy's features carry them.  ESM-2 runs no kernel of
    the port (the JAX package runs it outside any Pallas site)."""
    cfg = getattr(nn_esm.ESM2Config, ESM_SIZE)()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = nn_esm.ESM2(cfg, generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda").eval()
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    params = sum(p.numel() for p in built.parameters())
    path = os.path.join(work, f"esm2_{ESM_SIZE}_random.pt")
    t0 = time.perf_counter()
    torch.save({"args": argparse.Namespace(arch="ESM-2", layers=cfg.num_layers, embed_dim=cfg.embed_dim,
                                           attention_heads=cfg.num_heads),
                "model": fairesm_state_dict(built)}, path)
    save_seconds, file_gb = time.perf_counter() - t0, os.path.getsize(path) / 1e9
    os.environ[data_esm.CHECKPOINT_ENV] = path
    try:
        t0 = time.perf_counter()
        model = data_esm.checkpoint_model("cuda")
        torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(built.state_dict().values(), model.state_dict().values()))
        del built
        rng = np.random.default_rng(SEED)
        ar_dir = os.path.join(work, "esm_ar")
        write_pair(ar_dir, "long", np.random.default_rng(SEED + 3), AR_PREDICT_RESIDUES)
        ar_seq = structure_sequence(parse_pdb(os.path.join(ar_dir, "AF2_model", "long.pdb"), heavy_only=True))
        timed = {ESM_TIMED_RESIDUES: _random_sequence(rng, ESM_TIMED_RESIDUES), len(ar_seq): ar_seq}
        ms = {n: cuda_ms(lambda s=s: nn_esm.embed_sequence(model, s), iters=5, warmup=1) for n, s in timed.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        cpu_model = nn_esm.ESM2(cfg, device="meta")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
        cpu_model.eval()
        card_cpu = {}
        try:
            for n in ESM_CHECK_RESIDUES:
                seq = _random_sequence(rng, n)
                card, cpu = nn_esm.embed_sequence(model, seq), nn_esm.embed_sequence(cpu_model, seq)
                card_cpu[n] = {"max_abs_err": float(np.abs(card - cpu).max()), "max_abs": float(np.abs(cpu).max()),
                               "bound": ESM_CARD_CPU_ATOL}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del cpu_model
        # EQ's decoys: the model's embeddings replace the seeded cache
        written, write_seconds = ahead.take("eq")
        esm_dir = os.path.join(eq_root, "model_data_cache", "esm")
        shutil.rmtree(esm_dir)
        dm = EQDataModule.from_data_dir(eq_root, esm_device="cuda")
        dm.setup()
        decoys = [dm._decoy_path(n) for names in dm.splits.values() for n in names]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embedded = dm.prepare_embeddings(decoys)
        embed_seconds = time.perf_counter() - t0
        first = dm.splits["train"][0]
        g = featurize_decoy(dm._decoy_path(first), dm._native_path(first), esm_cache_dir=esm_dir)
        emb = np.load(os.path.join(esm_dir, data_esm.seq_key(
            structure_sequence(parse_pdb(dm._decoy_path(first), heavy_only=True))) + ".npy"))
        features_hold = bool(np.abs(g.h[:, :-1]).max() > 0 and np.array_equal(
            g.h[:, :-1], emb[g.extras["atom_residue_idx"]]))
    finally:
        os.environ.pop(data_esm.CHECKPOINT_ENV, None)
        data_esm._models.clear()
        os.remove(path)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    results = {
        "size": ESM_SIZE, "params": params, "build_seconds": build_seconds, "checkpoint_gb": file_gb,
        "save_seconds": save_seconds, "load_seconds": load_seconds, "loaded_equals_written": same,
        "ms_per_sequence": {str(n): v for n, v in ms.items()}, "peak_gb": peak_gb,
        "card_vs_cpu": {str(n): v for n, v in card_cpu.items()},
        "eq": {"sequences_embedded": embedded, "decoys": len(decoys), "seconds": embed_seconds,
               "ms_per_sequence": 1e3 * embed_seconds / max(embedded, 1), "features_hold": features_hold},
        "eq_written": written, "eq_write_seconds": write_seconds,
    }
    print("phase esm: " + json.dumps(results), flush=True)
    check(same, "esm: the weights loaded through the checkpoint tier differ from those written")
    check(params > 6.4e8, f"esm: {params} parameters, not ESM-2 650M's")
    for n, v in card_cpu.items():
        check(v["max_abs_err"] <= ESM_CARD_CPU_ATOL, f"esm: card vs CPU at {n} residues: {v}")
    check(embedded == sum(EQ_TARGETS.values()), f"esm: {embedded} EQ sequences embedded, want one a target")
    check(features_hold, "esm: an EQ decoy's node scalars are not its ESM-2 embedding")
    print("phase esm: ok")
    return results


# --- data parallelism -------------------------------------------------------------

DDP_STEPS = 4  # the first runs eagerly and captures, the rest replay
DDP_GLOO_STEPS = 3
DDP_SHARDS = 2
# seconds for the two gloo processes, start-up included (20 launches on one
# H100 took 13.3-28.2 s each); a process still running at 0.9 of it prints
# its stacks, and running over it fails the phase
DDP_TIMEOUT = 90
# the evaluation over 2 ranks against one process's: the same float32
# forwards, the loss's mean taken over the shards in another order
DDP_EVAL_RTOL = 1e-6


def _ddp_shards() -> list:
    """The global batch of the DP runs: DDP_SHARDS full-width LBA batches
    from SEED, one a shard."""
    return synthetic_batches(DDP_SHARDS, GRAPHS, NODES, EDGES_PER_NODE, SEED)


def _dp_generator(rank: int) -> torch.Generator:
    """Rank ``rank``'s dropout stream, as the Trainer seeds it."""
    return torch.Generator(device="cuda").manual_seed(SEED + (rank << 32))


def _captured_dp_run(shard, group) -> dict:
    """DDP_STEPS captured bf16 steps of _lba_training on ``shard`` in
    ``group`` (``None``: alone); K1-K3 counted from 0 around them."""
    model, state, gen = _lba_training(torch.bfloat16)
    state.group = group
    start = flat_params(model)
    steps = TrainSteps(model, state, graph_regression_loss, gen)
    pinned = shard.pinned()
    reset_counts()
    results = [steps([pinned]) for _ in range(DDP_STEPS)]
    torch.cuda.synchronize()
    launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    return {
        "losses": [r.loss.item() for r in results], "grad_norms": [r.grad_norm.item() for r in results],
        "ok": all(bool(r.ok.all()) for r in results), "launches": launches,
        "start": start, "params": flat_params(model), "steps": steps, "pinned": pinned,
    }


def _lba_evaluator(model, group=None) -> Trainer:
    """The Trainer that tests LBA's ``model`` (its loss, collect and
    metrics) alone or in ``group``; over gloo it runs eagerly."""
    return Trainer(model, graph_regression_loss, group=group, early_stopping_patience=None,
                   collect_fn=tasks.build_collect("GCPNetLBA"), metric_fns=tasks.build_metric_fns("GCPNetLBA"))


def _gloo_worker(steps: int) -> dict:
    """One rank of the gloo run on the one card: its shard of the global
    batch tested with the starting weights (the Trainer's evaluation over
    the group: the loss averaged, the predictions gathered), then ``steps``
    eager bf16 steps of _lba_training on it (its dropout stream its own)."""
    group = parallel.init_from_env("cuda", backend="gloo")
    host = _ddp_shards()[group.rank]
    shard = host.to(torch.device("cuda"))
    model, state, _ = _lba_training(torch.bfloat16)
    reset_counts()
    evaluation = _lba_evaluator(model, group).eval_epoch([host], prefix="test")
    eval_launches = dict(zip(KERNEL_COUNTS, launch_counts()))
    state.group = group
    gen = _dp_generator(group.rank)
    reset_counts()
    results = [train_step(model, state, shard, graph_regression_loss, gen) for _ in range(steps)]
    losses = [r.loss.item() for r in results]
    out = {"losses": losses, "params": flat_params(model).cpu(), "launches": dict(zip(KERNEL_COUNTS, launch_counts())),
           "ok": all(bool(r.ok) for r in results)}
    gathered = parallel.all_gather_objects(out["launches"], group)
    return {**out, "launches_by_rank": gathered, "evaluation": evaluation,
            "eval_launches_by_rank": parallel.all_gather_objects(eval_launches, group)}


def _two_shard_reference(shards, steps: int) -> dict:
    """One process on the global batch of two shards: each step takes each
    shard's loss and gradients (its rank's dropout stream), sums the two
    flat buffers and halves them, as the all-reduce does, then updates."""
    model, state, _ = _lba_training(torch.bfloat16)
    gens = [_dp_generator(r) for r in range(len(shards))]
    dev = [s.to(torch.device("cuda")) for s in shards]
    losses = []
    for _ in range(steps):
        flat = None
        for shard, gen in zip(dev, gens):
            loss, grads = step_module.loss_and_grads(model, state, shard, graph_regression_loss, gen)
            part = step_module.flatten(loss, grads)
            flat = part if flat is None else flat + part
        loss = step_module.unflatten_(flat.div_(len(shards)), grads)
        state.step += 1
        losses.append(step_module.update(model, state, loss, grads).loss.item())
    return {"losses": losses, "params": flat_params(model)}


def phase_ddp(work: str) -> dict:
    """Data-parallel full-width LBA training (bf16 over float32 masters,
    _lba_training), K1-K3 in every rank's step:

    - world 1 on NCCL in this process, captured: DDP_STEPS steps equal bit
      for bit to the same steps without a process group (the all-reduce of
      one process changes no bit), its busy ms a replay beside the plain
      one's, and the all-reduce of the step's flat buffer timed alone;
    - world 2 over gloo on the one card (two processes started by
      parallel.launch, each on its own shard of a global batch of two),
      eager: DDP_GLOO_STEPS steps against one process stepping on both
      shards with the all-reduce's arithmetic (_two_shard_reference);
    - where the machine has two or more GPUs, world 2 on NCCL, captured,
      against world 1 on the same global batch (reported, not required).

    The launches of K1-K3 are counted from 0 around each run."""
    shards = _ddp_shards()
    alone = _captured_dp_run(shards[0], None)
    alone_prof = profile_replay(lambda: alone["steps"]([alone["pinned"]]), alone["steps"].call, [alone["pinned"]])
    del alone["steps"], alone["pinned"]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           parallel.group.INIT_METHOD_ENV: "file://" + os.path.join(work, "ddp_store")}
    os.environ.update(env)
    try:
        group = parallel.init_from_env("cuda")
        world1 = _captured_dp_run(shards[0], group)
        world1_prof = profile_replay(lambda: world1["steps"]([world1["pinned"]]), world1["steps"].call,
                                     [world1["pinned"]])
        names = world1["steps"].call.kernel_names([world1["pinned"]])
        del world1["steps"], world1["pinned"]
        flat = torch.zeros(world1["params"].numel() + 1, device="cuda")  # the step's buffer: gradients, loss
        allreduce_ms = cuda_ms(lambda: parallel.mean_(flat, group), iters=20, warmup=3)
        backend = group.backend
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)
    world1_bits = bool(torch.equal(world1["params"], alone["params"])) and world1["losses"] == alone["losses"] \
        and world1["grad_norms"] == alone["grad_norms"]
    # the two processes share the card with this one: hand back its cache
    gc.collect()
    torch.cuda.empty_cache()
    sigchld = str(signal.getsignal(signal.SIGCHLD))  # how this process's ended children are reaped
    t0 = time.perf_counter()
    gloo = parallel.launch(_gloo_worker, DDP_SHARDS, DDP_GLOO_STEPS, timeout=DDP_TIMEOUT)
    gloo_seconds = time.perf_counter() - t0
    # one process tests both shards with the starting weights
    evaluation = _lba_evaluator(_lba_training(torch.bfloat16)[0]).eval_epoch(shards, prefix="test")
    eval_rel = {k: abs(gloo["evaluation"][k] - v) / max(abs(v), 1e-12) for k, v in evaluation.items()}
    ref = _two_shard_reference(shards, DDP_GLOO_STEPS)
    gloo_gap = param_gap(gloo["params"].cuda(), ref["params"], alone["start"], TRAIN_LR, DDP_GLOO_STEPS)
    loss_rel = float(np.max(np.abs(np.subtract(gloo["losses"], ref["losses"])) / np.abs(ref["losses"])))
    nccl2 = "not run: one GPU" if torch.cuda.device_count() < 2 else "not run"
    results = {
        "global_batch": {"shards": DDP_SHARDS, "graphs_per_shard": GRAPHS, "atoms_per_graph": NODES},
        "world1_nccl": {
            "backend": backend, "losses": world1["losses"], "alone_losses": alone["losses"],
            "grad_norms": world1["grad_norms"], "equal_bit_for_bit": world1_bits,
            "params_max_abs_diff": (world1["params"] - alone["params"]).abs().max().item(),
            "launches": world1["launches"], "alone_launches": alone["launches"],
            "busy_ms": world1_prof["device_busy_ms"], "idle_share": world1_prof["device_idle_share"],
            "alone_busy_ms": alone_prof["device_busy_ms"], "replay_launches": world1_prof["launches"],
            "nccl_kernel_nodes": {k: v for k, v in names.items() if "nccl" in k.lower()},
            "allreduce_ms": allreduce_ms, "allreduce_bytes": flat.numel() * 4,
        },
        "world2_gloo": {
            "losses": gloo["losses"], "reference_losses": ref["losses"], "loss_max_rel_diff": loss_rel,
            "params": gloo_gap, "loss_bound_rel": REPLAY_TOL["losses"], "launches_by_rank": gloo["launches_by_rank"],
            "launch_seconds": gloo_seconds, "timeout": DDP_TIMEOUT, "sigchld_before_launch": sigchld,
            "evaluation": gloo["evaluation"], "one_process_evaluation": evaluation, "evaluation_rel_diff": eval_rel,
            "eval_launches_by_rank": gloo["eval_launches_by_rank"],
        },
        "world2_nccl": nccl2,
    }
    print("phase ddp: " + json.dumps(results), flush=True)
    for name, run in (("world-1", world1), ("alone", alone)):
        check(run["ok"] and all(np.isfinite(run["losses"])), f"ddp {name}: losses {run['losses']}")
        check(all(run["launches"][k] > 0 for k in ("K1", "K2", "K3_bf16")), f"ddp {name}: launches {run['launches']}")
    check(world1_bits, f"ddp: NCCL world 1 differs from the step alone: {results['world1_nccl']}")
    check(world1_prof["launches"] == alone_prof["launches"], "ddp: a world-1 replay launches other kernels")
    check(gloo["ok"], "ddp: a gloo step was not applied")
    for rank, launches in enumerate(gloo["launches_by_rank"]):
        check(all(launches[k] > 0 for k in ("K1", "K2", "K3_bf16")), f"ddp gloo rank {rank}: launches {launches}")
    check(loss_rel <= REPLAY_TOL["losses"], f"ddp: gloo world 2 losses apart from the reference by {loss_rel}")
    for rank, launches in enumerate(gloo["eval_launches_by_rank"]):
        check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3_bf16"] == launches["K3_fp32"] == 0,
              f"ddp gloo rank {rank}: evaluation launches {launches}")
    check(set(eval_rel) == set(gloo["evaluation"]) and "test/RMSE" in eval_rel
          and all(v <= DDP_EVAL_RTOL for v in eval_rel.values()),
          f"ddp: gloo world 2's evaluation apart from one process's: {eval_rel}")
    check_param_gap("ddp gloo world 2", gloo_gap)
    print("phase ddp: ok")
    return results


# --- remat, the dense layouts and the external scorers --------------------------

REMAT_MODES = (False, True, "dots")
# fp32 loss, gradients and parameters with remat against without: the
# recompute replays the forward's dropout masks and weights, so equal bit
# for bit is expected (REMAT_ATOL is what is held)
REMAT_ATOL = 1e-6
# the gcp-family stack of the remat phase: GCP v1 with the sigma frame gate,
# the gcp-family setting of the largest peak memory
REMAT_FAMILY = "gcp1_sigma_frame_gate"
# the dense layout of the LBA cell: the JAX ATOM3D budgets (the radius
# graph's neighbour cap and twice it); 7,168 nodes x 32 = 229,376 slot rows
DENSE_DEGREE, DENSE_OUT_DEGREE = 32, 64


def k1_steps_dense(task: str, layers: int, by_sender: bool = False) -> tuple:
    """k1_steps in the dense layout: the receiver-side sums are slot sums
    and the receiver gathers broadcasts, so K1 runs on the sender side
    alone: each layer's feed-forward node frames (and, ``by_sender``, its
    message sum), and its sender gather's backward."""
    forward = K1_FIXED[task] + (2 if by_sender else 1) * layers
    return forward + layers, forward


def remat_launches(dtype: torch.dtype, remat) -> tuple:
    """An LBA training step's K1, K2, K3 launches (KERNEL_COUNTS' order):
    with remat each layer's recompute runs its two sums (K1) and its stack
    (K2) again."""
    k1 = k1_steps("lba", 8)[0] + (2 * 8 if remat else 0)
    k2 = 8 * (2 if remat else 1)
    return (k1, k2, 8, 0) if dtype == torch.bfloat16 else (k1, k2, 0, 8)


def _remat_lba(batch, dtype: torch.dtype, remat, eager: bool) -> dict:
    """The full-width LBA (dropout 0.1 from a generator seeded SEED) with
    ``remat``: with ``eager`` one eager step (train_step), then on a fresh
    model two captured steps (TrainSteps: the first runs eagerly and
    captures, the second replays); each step's loss, the gradients and
    parameters after the eager step and after the replay, the launches of
    the eager step and of a replay (from its graph), the captured run's
    peak memory."""
    out = {}
    if eager:
        model, state = build_lba_training(SEED, "cuda", dtype, lr=TRAIN_LR, dropout=0.1, remat=remat)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        reset_counts()
        step = train_step(model, state, batch.to(torch.device("cuda")), graph_regression_loss, gen)
        out = {"eager_loss": step.loss.item(), "eager_launches": dict(zip(KERNEL_COUNTS, launch_counts())),
               "eager_grads": torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
               "eager_params": flat_params(model)}
        del model, state
    model, state = build_lba_training(SEED, "cuda", dtype, lr=TRAIN_LR, dropout=0.1, remat=remat)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    steps = TrainSteps(model, state, graph_regression_loss, gen)
    pinned = [batch.pinned()]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = steps(pinned)
    replay = steps(pinned)
    torch.cuda.synchronize()
    out.update(
        losses=[first.loss.item(), replay.loss.item()], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        grads=torch.cat([p.grad.reshape(-1) for p in model.parameters()]), params=flat_params(model),
        replay_launches=launches_by_name(steps.call.kernel_names(pinned)),
    )
    return out


def _family_remat(cfg: dict, train: list, remat) -> dict:
    """Two captured training steps of the gcp-family model ``cfg``
    composes, with ``remat``, on ``train`` (pinned batches): the peak
    memory, and one replay's busy time and launches under the profiler."""
    model, name = tasks.build_model(cfg["model"], seed=SEED, device="cuda")
    model.encoder.remat = check_remat(remat)
    trainer = train_entry.build_trainer(cfg, model, tasks.build_loss(name), name, checkpoints=False)
    steps = TrainSteps(model, trainer.state, tasks.build_loss(name), torch.Generator(device="cuda").manual_seed(SEED))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = steps(train)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_replay(lambda: steps(train), steps.call, train)
    return {"remat": remat, "peak_mem_gb": peak, "loss": result.loss.tolist(), "step_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"], "launches": prof["launches"],
            "graph_kernel_nodes": prof["graph_kernel_nodes"], "scatters": prof["scatters"]}


def phase_remat(batch, data_root: str) -> dict:
    """Per-layer rematerialization on the card.  The full-width LBA (16 x
    448 atoms, 208,896 edge rows, 8 x 8 layers, dropout 0.1 from one
    seeded generator) with remat False, True and "dots", captured in fp32
    and bf16, and in fp32 also eagerly (_remat_lba): the eager step's loss,
    gradients and parameters and the captured run's losses, the replay's
    gradients and the parameters after it, with remat against without,
    fp32 held to REMAT_ATOL, bf16 printed; each run's launches
    (remat_launches: the recompute runs each layer's K1 sums and K2 again)
    and peak memory.  Then the gcp-family stack REMAT_FAMILY at its
    chip_smoke depth (GCP_FAMILY_LAYERS x 8) on cfg-train's records, with
    and without remat (_family_remat): both peaks and replays' busy times;
    remat must lower the peak."""
    results = {"lba": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dname = "fp32" if dtype == torch.float32 else "bf16"
        eager = dtype == torch.float32
        runs = {str(mode): _remat_lba(batch, dtype, mode, eager) for mode in REMAT_MODES}
        ref = runs["False"]
        table = {}
        for mode, run in runs.items():
            want = dict(zip(KERNEL_COUNTS, remat_launches(dtype, mode != "False")))
            apart = {
                "losses": max(abs(a - b) for a, b in zip(run["losses"], ref["losses"])),
                "replay_grads": (run["grads"] - ref["grads"]).abs().max().item(),
                "params": (run["params"] - ref["params"]).abs().max().item(),
            }
            if eager:
                apart.update(
                    eager_loss=abs(run["eager_loss"] - ref["eager_loss"]),
                    eager_grads=(run["eager_grads"] - ref["eager_grads"]).abs().max().item(),
                    eager_params=(run["eager_params"] - ref["eager_params"]).abs().max().item(),
                )
            table[mode] = {
                "losses": run["losses"], "eager_loss": run.get("eager_loss"), "peak_mem_gb": run["peak_mem_gb"],
                "eager_launches": run.get("eager_launches"), "replay_launches": run["replay_launches"],
                "want": want, "vs_no_remat_max_abs": apart,
            }
        results["lba"][dname] = table
        del runs, ref
        print(f"phase remat lba {dname}: " + json.dumps(table), flush=True)
        for mode, row in table.items():
            check(row["eager_launches"] in (None, row["want"]) and row["replay_launches"] == row["want"],
                  f"remat {dname} {mode}: launches {row['eager_launches']} / {row['replay_launches']}, "
                  f"want {row['want']}")
            check(all(math.isfinite(v) for v in row["losses"]), f"remat {dname} {mode}: losses {row['losses']}")
            if dname == "fp32":
                worst = max(row["vs_no_remat_max_abs"].values())
                check(worst <= REMAT_ATOL, f"remat fp32 {mode}: apart from the step without remat by "
                      f"{row['vs_no_remat_max_abs']}")
    base = ["experiment=gcpnet_lba_ablations", f"paths.data_dir={data_root}/", "trainer.max_epochs=1", "test=false",
            f"model.model_cfg.num_encoder_layers={GCP_FAMILY_LAYERS}", *GCP_FAMILY_RUNS[REMAT_FAMILY]]
    cfg = compose(CONFIG_DIR, "train.yaml", base)
    dm = build_datamodule(cfg["datamodule"], device="cuda")
    dm.setup()
    train = [b.pinned() for b in itertools.islice(dm.train_batches(seed=0), 1)]
    del dm
    results["family"] = {str(mode): _family_remat(cfg, train, mode) for mode in (False, True)}
    plain, remat = results["family"]["False"], results["family"]["True"]
    print("phase remat family: " + json.dumps(results["family"]), flush=True)
    for row in (plain, remat):
        check(not row["scatters"] and row["launches"]["K2"] == 0, f"remat family: {row}")
    check(remat["launches"]["K1"] > plain["launches"]["K1"], "remat family: the recompute ran no K1")
    check(remat["peak_mem_gb"] < plain["peak_mem_gb"],
          f"remat family: peak {remat['peak_mem_gb']:.2f} GB with remat, {plain['peak_mem_gb']:.2f} without")
    print("phase remat: ok")
    return results


def dense_lba_batches(seed: int = SEED) -> tuple:
    """The first LBA batch of synthetic_batches(seed) (16 x 448 atoms,
    in-degrees 24-32) twice: receiver-sorted with CSR splits, and in the
    dense layout (DENSE_DEGREE, DENSE_OUT_DEGREE)."""
    rng = np.random.default_rng(seed)
    graphs = [random_lba_graph(rng, NODES, EDGES_PER_NODE) for _ in range(GRAPHS)]
    bucket = Bucket(NODES * GRAPHS, NODES * EDGES_PER_NODE * GRAPHS + EDGE_SLACK, GRAPHS)
    sorted_batch = collate_shards([graphs], bucket, ("label",), sort_edges=True, sort_tile=1)
    dense = collate_shards([graphs], bucket, ("label",), dense_degree=DENSE_DEGREE, dense_out_degree=DENSE_OUT_DEGREE)
    return sorted_batch, dense


def steps_apart(name: str, got: dict, want: dict, params_by_share: bool = False) -> dict:
    """Two fp32 step outcomes (_step_outcome) held to TRAIN_CHECK_ATOL as
    card_vs_cpu_step holds them, the updated parameters outside
    adam_sign_flips (or, ``params_by_share``, by the share apart)."""
    param_diff = (got["params"] - want["params"]).abs()
    flips = adam_sign_flips(got["grads"], want["grads"],
                            TRAIN_CHECK_ATOL["grads_norm_rel"] * want["grads"].norm().item())
    held = param_diff[~flips]
    r = {
        "loss_abs_diff": abs(got["loss"] - want["loss"]),
        "grad_norm_abs_diff": abs(got["grad_norm"] - want["grad_norm"]),
        "grads_norm_rel_err": norm_rel_err(got["grads"], want["grads"]),
        "params_max_abs_diff": param_diff.max().item(),
        "params_max_abs_diff_outside_sign_flips": held.max().item() if held.numel() else 0.0,
        "sign_flips": int(flips.sum()),
        "params_share_above_1e-6": (param_diff > 1e-6).float().mean().item(),
    }
    check(r["loss_abs_diff"] <= TRAIN_CHECK_ATOL["loss"], f"{name}: loss differs {r}")
    check(r["grad_norm_abs_diff"] <= TRAIN_CHECK_ATOL["grad_norm"], f"{name}: grad norm differs {r}")
    check(r["grads_norm_rel_err"] <= TRAIN_CHECK_ATOL["grads_norm_rel"], f"{name}: gradients differ {r}")
    if not params_by_share:
        check(r["params_max_abs_diff_outside_sign_flips"] <= TRAIN_CHECK_ATOL["params"], f"{name}: parameters {r}")
    check(r["params_share_above_1e-6"] <= TRAIN_CHECK_ATOL["params_share_above_1e-6"], f"{name}: parameters {r}")
    return r


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` with ``values`` set inside the block."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _layout_step(name: str, build, batches: dict, loss_fn, want: dict, params_by_share: bool = False) -> dict:
    """One fp32 step (no dropout) of ``build`` on each of ``batches``
    (``{"default": ..., "dense": ...}``) from the same weights; the dense
    step's launches must be ``want``; the two held by steps_apart."""
    outcome = {}
    for layout, batch in batches.items():
        reset_counts()
        outcome[layout] = _step_outcome(build, "cuda", batch, loss_fn)
        outcome[layout]["launches"] = dict(zip(KERNEL_COUNTS, launch_counts()))
    r = {"launches": {k: v["launches"] for k, v in outcome.items()}, "want": want,
         "loss": outcome["dense"]["loss"], "step_seconds": {k: v["seconds"] for k, v in outcome.items()}}
    r["apart"] = steps_apart(name, outcome["dense"], outcome["default"], params_by_share)
    print(f"phase {name}: " + json.dumps(r), flush=True)
    check(r["launches"]["dense"] == want, f"{name}: launches {r['launches']['dense']}, want {want}")
    return r


def phase_dense(eq_root: str, ar_root: str) -> dict:
    """The dense and sender-dense layouts on the card.  The full-width LBA
    on the dense layout (dense_lba_batches: 229,376 slot rows, sender
    budget 64): an fp32 forward against the sorted one's (FORWARD_ATOL);
    an fp32 step against the receiver-sorted step on the same graphs and
    weights (steps_apart at TRAIN_CHECK_ATOL); a captured bf16 step
    (dropout 0.1), one replay profiled.  K2/K3 run, K1 on the sender side
    only (k1_steps_dense), no scatter.  Then one fp32 EQ step under
    GCPNET_EQ_DENSE=1 and one AR step under GCPNET_AR_DENSE=1 on eq-data's
    and ar-data's records (each split's first validation decoy, the
    graphs read from their caches) against the default layouts' (AR's
    switch only checks the sender budget, so its batch is the default
    one)."""
    sorted_batch, dense = dense_lba_batches()
    check(dense.num_edges == NODES * GRAPHS * DENSE_DEGREE and dense.edge_dense_degree == DENSE_DEGREE,
          f"dense: {dense.num_edges} rows")
    results = {"rows": {"dense": dense.num_edges, "sorted": sorted_batch.num_edges,
                        "real": int(np.asarray(dense.edge_pad_mask).sum())}}
    model = build_model(SEED, "cuda", torch.float32)
    with torch.inference_mode():
        want_out = predict(model, sorted_batch).float().cpu()
        reset_counts()
        got_out = predict(model, dense).float().cpu()
    forward = {"launches": dict(zip(KERNEL_COUNTS, launch_counts())),
               "max_abs_vs_sorted": (got_out - want_out).abs().max().item()}
    results["forward"] = forward
    del model
    k1_train, k1_eval = k1_steps_dense("lba", 8)
    check(forward["launches"] == {"K1": k1_eval, "K2": 8, "K3_bf16": 0, "K3_fp32": 0},
          f"dense forward: launches {forward['launches']}")
    check(forward["max_abs_vs_sorted"] <= FORWARD_ATOL, f"dense forward: {forward}")
    build = lambda dev: build_lba_training(SEED, dev, torch.float32, lr=TRAIN_LR, dropout=0.0)  # noqa: E731
    results["lba_fp32"] = _layout_step("dense lba fp32", build, {"default": sorted_batch, "dense": dense},
                                       graph_regression_loss, {"K1": k1_train, "K2": 8, "K3_bf16": 0, "K3_fp32": 8})
    model, state, gen = _lba_training(torch.bfloat16)
    steps = TrainSteps(model, state, graph_regression_loss, gen)
    pinned = [dense.pinned()]
    first = steps(pinned)
    prof = profile_replay(lambda: steps(pinned), steps.call, pinned)
    want = {"K1": k1_train, "K2": 8, "K3_bf16": 8, "K3_fp32": 0}
    results["lba_bf16_captured"] = {
        "loss": first.loss.item(), "step_busy_ms": prof["device_busy_ms"], "device_idle_share": prof["device_idle_share"],
        "launches": prof["launches"], "graph_kernel_nodes": prof["graph_kernel_nodes"], "scatters": prof["scatters"],
        "wall_ms": prof["wall_ms"],
    }
    del model, state, steps
    print("phase dense lba bf16: " + json.dumps(results["lba_bf16_captured"]), flush=True)
    check(prof["launches"] == want, f"dense lba bf16: a replay's launches {prof['launches']}, want {want}")
    check(not prof["scatters"], f"dense lba bf16: scatters {prof['scatters']}")
    layers = FIT_LAYERS["eq"]
    batches = {"default": next(eq_datamodule(eq_root).val_batches())}
    with environ(GCPNET_EQ_DENSE="1"):
        batches["dense"] = next(eq_datamodule(eq_root).val_batches())
    check(batches["dense"].edge_dense_degree == 32, "dense eq: the switch took no effect")
    k1 = k1_steps_dense("eq", layers, by_sender=True)[0]
    results["eq"] = _layout_step("dense eq", lambda dev: _eq_model(dev, layers), batches, eq_loss,
                                 {"K1": k1, "K2": layers, "K3_bf16": 0, "K3_fp32": layers}, params_by_share=True)
    layers = FIT_LAYERS["ar"]
    batches = {"default": next(ar_datamodule(ar_root).val_batches())}
    with environ(GCPNET_AR_DENSE="1"):
        dm = ar_datamodule(ar_root)
        batches["dense"] = next(dm.val_batches())
    check(batches["dense"].sender_out_degree == dm.k_max + 2 * dm.k_min, "dense ar: the switch took no effect")
    results["ar"] = _layout_step("dense ar", lambda dev: _ar_model(dev, layers), batches, ar_loss,
                                 {"K1": k1_steps("ar", layers)[0], "K2": layers, "K3_bf16": 0, "K3_fp32": layers},
                                 params_by_share=True)
    print("phase dense: ok")
    return results


def clash_mask_numpy(s) -> np.ndarray:
    """The JAX ``between_residue_clashes`` in numpy on the host, its
    per-atom operands made here from the structure as the JAX function
    makes them (not the port's ``clash_operands``), over the pairs a k-d
    tree finds within reach of a clash (the largest bound, 2 x the largest
    radius - 1.5 A, plus 0.5): every other pair is farther apart than any
    bound.  Each pair's test is symmetric, so it marks both atoms."""
    from scipy.spatial import cKDTree

    x = s.coords.astype(np.float64)
    out = np.zeros(x.shape[0], dtype=bool)
    if x.shape[0] < 2:
        return out
    radii = np.asarray([amber_violations.VDW_RADII.get(e, 1.7) for e in s.elements])
    res_idx = s.residue_index()
    names = [a.name for a in s.atoms]
    is_c = np.asarray([n == "C" for n in names])
    is_n = np.asarray([n == "N" for n in names])
    resseq = np.asarray([a.resseq for a in s.atoms], dtype=np.int64)
    chain_ids = {c: k for k, c in enumerate({a.chain for a in s.atoms})}
    chain = np.asarray([chain_ids[a.chain] for a in s.atoms], dtype=np.int64)
    is_sg = np.asarray([a.name == "SG" and a.resname == "CYS" for a in s.atoms])
    reach = 2 * float(radii.max()) - amber_violations.CLASH_OVERLAP_TOL + 0.5
    pairs = cKDTree(x).query_pairs(reach, output_type="ndarray")
    i, j = pairs[:, 0], pairs[:, 1]
    diff = x[i] - x[j]
    dist = np.sqrt(np.sum(diff * diff, axis=-1) + 1e-12)
    lower = radii[i] + radii[j] - amber_violations.CLASH_OVERLAP_TOL
    same_chain = chain[i] == chain[j]
    bonded = is_c[i] & is_n[j] & (resseq[j] == resseq[i] + 1)
    bonded_t = is_n[i] & is_c[j] & (resseq[i] == resseq[j] + 1)
    clash = ((dist < lower) & (res_idx[i] != res_idx[j])
             & ~((bonded | bonded_t) & same_chain) & ~(is_sg[i] & is_sg[j]))
    out[i[clash]] = True
    out[j[clash]] = True
    return out


def phase_scorers(eq_root: str, work: str, refined_pdb: str) -> dict:
    """The external scorers and AMBER's violations.  EQ's labels through
    ``lddt_exec_path``: a stand-in lddt executable (write_lddt_stub) that
    prints the native per-residue lDDT of eq-data's validation decoys,
    against the native labels eq-data cached (atol 1e-6: six printed
    decimals); the graph cache keyed on the scorer (both kinds of file
    beside each other).  Then find_violations of ar-predict's refined
    decoy (its clash check on the card, in blocks) against the same with
    the clash check in numpy on the host (clash_mask_numpy): equal masks
    and counts."""
    native_dm = eq_datamodule(eq_root)
    names = native_dm.splits["valid"]
    scores, native = {}, {}
    t0 = time.perf_counter()
    for name in names:
        decoy = native_dm._decoy_path(name)
        scores[os.path.basename(decoy)] = matched_lddt(decoy, native_dm._native_path(name), per_residue=True)
        native[name] = native_dm.featurize(name).extras["label"]
    calls = os.path.join(work, "lddt_calls")
    stub = write_lddt_stub(os.path.join(work, "lddt"), scores, log=calls)
    t1 = time.perf_counter()
    dm = EQDataModule.from_data_dir(eq_root, batch_size=1, max_nodes_per_batch=EQ_BUCKET[0],
                                    max_residues_per_batch=EQ_MAX_RESIDUES, lddt_exec_path=stub)
    dm.setup()
    labels = {name: dm.featurize(name).extras["label"] for name in names}
    t2 = time.perf_counter()
    with open(calls) as f:
        called = f.read().split()
    cached = os.listdir(os.path.join(eq_root, "model_data_cache"))
    lddt = {
        "decoys": len(names), "binary_calls": len(called), "native_seconds": t1 - t0, "binary_seconds": t2 - t1,
        "max_abs_vs_native": max(float(np.abs(labels[n] - native[n]).max()) for n in names),
        "cached_native": sum(f"{n}.graph.npz" in cached for n in names),
        "cached_binary": sum(any(c.startswith(f"{n}_lddt-") for c in cached) for n in names),
    }
    print("phase scorers lddt: " + json.dumps(lddt), flush=True)
    check(lddt["binary_calls"] == len(names) > 0, f"scorers: the binary ran {lddt['binary_calls']} times")
    check(lddt["max_abs_vs_native"] <= 1e-6, f"scorers: binary labels apart from native {lddt}")
    check(lddt["cached_native"] == lddt["cached_binary"] == len(names), f"scorers: the graph cache {lddt}")
    s = parse_pdb(refined_pdb, heavy_only=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = amber_violations.find_violations(s, "cuda")
    t1 = time.perf_counter()
    host_mask = clash_mask_numpy(s)
    t2 = time.perf_counter()
    res_idx = s.residue_index()
    host_res = np.zeros(card["per_residue_violation_mask"].shape[0], dtype=bool)
    host_res[res_idx[host_mask]] = True
    bond = amber_violations.between_residue_bond_violations(s)["per_residue_violation_mask"]
    viol = {
        "atoms": len(s.atoms), "residues": int(host_res.shape[0]), "card_seconds": t1 - t0, "host_seconds": t2 - t1,
        "clashing_atoms": int(card["per_atom_clash_mask"].sum()), "host_clashing_atoms": int(host_mask.sum()),
        "num_residue_violations": card["num_residue_violations"],
        "host_num_residue_violations": float((bond | host_res).sum()),
        **{k: v for k, v in card.items() if k.startswith("violations_")},
    }
    print("phase scorers violations: " + json.dumps(viol), flush=True)
    check(np.array_equal(card["per_atom_clash_mask"], host_mask), "scorers: clash masks differ")
    check(np.array_equal(card["per_residue_violation_mask"], bond | host_res), "scorers: residue masks differ")
    check(viol["num_residue_violations"] == viol["host_num_residue_violations"], f"scorers: counts {viol}")
    print("phase scorers: ok")
    return {"lddt": lddt, "violations": viol}


def datum_samples(model, graph, copies: int) -> np.ndarray:
    """The argmax samples (temperature 1e-6) of ``copies`` copies of
    ``graph`` on the model's device, ``[copies, n]``."""
    n = graph.num_nodes
    bucket = Bucket(n * copies, graph.num_edges * copies, copies)
    batch = next(batches_from_dataset([graph] * copies, bucket))
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return model.sample(batch.to(dev), n, 1e-6, gen).cpu().numpy().reshape(copies, n)


def kernel_line(report) -> dict:
    """The contract line: K1 and K2 at bf16 (the production precision) on
    the tile-aligned layout the main path uses, fp32 and K1's CSR layout
    beside them; ``launches`` the wrappers' count over the captured bf16
    training run (its first step's eager launches and the capture's
    records), ``replay_launches`` the kernels one replay of that graph
    launches, read from its kernel nodes, beside the run's ``replays``; the
    prediction run's count beside them; K3 as its two instantiations, bf16
    (the bf16 training run) and fp32 (split TF32, the fp32 training run).
    Under "nms", each kernel at the NMS step's shape and its launches a
    step of the NMS fit, read from the graph of one replay of a train chunk
    (FIT_CHUNK steps) by instantiation (the fit is fp32, so the bf16 K3's
    count is 0); under "rs" the same at the RS step's shape and the RS
    fit; under "psr" at the PSR step's shape and the PSR fit (bf16, so the
    fp32 K3's count is 0); under "cpd" at the CPD step's shape and the CPD
    fit (bf16; K1 a step as k1_steps counts it); under "eq" at the EQ
    step's shape and the EQ fit (bf16); under "ar" at the AR step's shape
    (the silu stack) and the AR fit (bf16); under "cfg" the launches of the
    config-driven LBA fit (cfg-train, bf16), whose shape is psr's; under
    "gcp_family" a step's launches in each gcp-family run and the rs-e3
    fit; under "acts" K2 and K3 at the main path's shape on the stacks with
    selu, gelu, sigmoid and tanh, and a step's launches in their fits."""
    k1, k2, k3 = report["K1"], report["K2"], report["K3"]
    forward, train, train_fp32 = report["forward"], report["train"], report["train_fp32"]
    nk, rk, pk = report["nms_kernels"], report["rs_kernels"], report["psr_kernels"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    replaces_k3 = "gcpnet_tpu/ops/pallas_fused.py:175"
    # the layer body, tile rows and shared memory of K2 and K3
    body_keys = ("body", "tile_rows", "smem_bytes")

    def body(res, prefix=""):
        return {f"{prefix}{k}": res[k] for k in body_keys if k in res}

    def per_step(profiles):
        replayed = profiles["profile_captured"]["launches"]
        return {k: n / profiles["chunk_steps"] for k, n in replayed.items()}

    nms_steps, rs_steps = per_step(report["nms_fit"]), per_step(report["rs_profile"])
    psr_steps = per_step(report["psr_profile"])
    ck, cpd_steps = report["cpd_kernels"], per_step(report["cpd_profile"])
    ek, eq_steps = report["eq_kernels"], per_step(report["eq_profile"])
    ak, ar_steps = report["ar_kernels"], per_step(report["ar_profile"])
    cfg_run, cfg_steps = report["cfg_train"], per_step(report["cfg_train"])

    def cfg(count):
        """The config-driven LBA fit's launches (cfg-train) of a kernel: the
        wrappers' count over the run, and a step of a chunk replay; its
        shape is psr's (the same bucket and stack)."""
        return {"launches": cfg_run["launches"][count], "launches_per_step": cfg_steps[count]}

    def family(count):
        """A step's launches of a kernel in each gcp-family run and in the
        E(3) RS fit (rs-e3), read from a replay's graph: the plain stacks
        launch K1 alone."""
        runs = {**report["gcp_family"], "rs_e3": report["rs_e3"]["fit"]}
        return {name: run["launches_per_step"][count] for name, run in runs.items() if name != "check"}

    def acts(kernel, count, *dnames):
        """The acts phase's figures of a kernel (K2, or K3 in ``dnames``'
        precision): at each of ACT_STACKS' stacks its error, ms, bound and
        share by precision, and a step's ``count`` launches in each fit
        (bf16: the fp32 K3's count is 0)."""
        res = report["acts"]
        keys = ("max_abs_err", "ms", "bound_ms", "bound_by", "share_of_bound")
        return {
            "card": res["card"],
            # K3 runs these stacks in the build for every code
            **({"source": "gcpnet_torch/csrc/edge_map_bwd_tc_all.cu"} if kernel == "K3" else {}),
            **{name: {d: {k: res["kernels"][name][d][kernel][k] for k in keys} for d in dnames} for name in ACT_STACKS},
            "fit_launches_per_step": {name: res[name]["launches_per_step"][count] for name in ACT_FITS},
        }

    def row(name, source, replaces, run, count, main, dtype, **extra):
        return {
            "name": name, "route": "cuda", "source": f"gcpnet_torch/csrc/{source}", "replaces": replaces,
            "launches": run["launches"][count], **{k: main[k] for k in keys}, "dtype": dtype,
            "replay_launches": run["profile_captured"]["launches"][count], "replays": run["replays"],
            "gcp_family": family(count), **extra,
        }

    def nms(results, launches_per_step, **by_dtype):
        return {
            "shape": next(iter(results.values()))["shape"], "launches_per_step": launches_per_step,
            **{k: v for k, v in next(iter(results.values())).items() if k == "rows_summed"},
            **{d: {k: results[key][k] for k in (*keys, "share_of_bound", *body_keys) if k in results[key]}
               for d, key in by_dtype.items()},
        }

    return {
        "kernels": [
            row("segment_sum_sorted", "segment_sorted.cu", "gcpnet_tpu/ops/pallas_segment.py:160", train, "K1",
                k1["tile128_bf16"], "bf16", forward_launches=forward["launches"]["K1"],
                **{f"fp32_{k}": k1["tile128_fp32"][k] for k in keys},
                **{f"csr_{k}": k1["tile1_bf16"][k] for k in keys},
                **{f"csr_fp32_{k}": k1["tile1_fp32"][k] for k in keys},
                nms=nms(nk["K1"], nms_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"),
                rs=nms(rk["K1"], rs_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"),
                psr=nms(pk["K1"], psr_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"),
                cpd=nms(ck["K1"], cpd_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"),
                eq=nms(ek["K1"], eq_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"),
                ar=nms(ak["K1"], ar_steps["K1"], fp32="tile1_fp32", bf16="tile1_bf16"), cfg=cfg("K1")),
            row("edge_map", "edge_map_tc.cu", "gcpnet_tpu/ops/pallas_fused.py:117", train, "K2",
                k2["bf16"], "bf16", forward_launches=forward["launches"]["K2"],
                bound_rate=k2["bf16"]["bound_rate"], **body(k2["bf16"]), **body(k2["fp32"], "fp32_"),
                **{f"fp32_{k}": k2["fp32"][k] for k in (*keys, "bound_rate")},
                nms=nms(nk["K2"], nms_steps["K2"], fp32="fp32", bf16="bf16"),
                rs=nms(rk["K2"], rs_steps["K2"], fp32="fp32", bf16="bf16"),
                psr=nms(pk["K2"], psr_steps["K2"], fp32="fp32", bf16="bf16"),
                cpd=nms(ck["K2"], cpd_steps["K2"], fp32="fp32", bf16="bf16"),
                eq=nms(ek["K2"], eq_steps["K2"], fp32="fp32", bf16="bf16"),
                ar=nms(ak["K2"], ar_steps["K2"], fp32="fp32", bf16="bf16"), cfg=cfg("K2"),
                acts=acts("K2", "K2", "bf16", "fp32")),
            row("edge_map_backward_tc", "edge_map_bwd_tc.cu", replaces_k3, train, "K3_bf16",
                k3["bf16"], "bf16", forward_launches=forward["launches"]["K3_bf16"],
                bound_rate=k3["bf16"]["bound_rate"], **body(k3["bf16"]),
                nms=nms(nk["K3"], nms_steps["K3_bf16"], bf16="bf16"),
                rs=nms(rk["K3"], rs_steps["K3_bf16"], bf16="bf16"),
                psr=nms(pk["K3"], psr_steps["K3_bf16"], bf16="bf16"),
                cpd=nms(ck["K3"], cpd_steps["K3_bf16"], bf16="bf16"),
                eq=nms(ek["K3"], eq_steps["K3_bf16"], bf16="bf16"),
                ar=nms(ak["K3"], ar_steps["K3_bf16"], bf16="bf16"), cfg=cfg("K3_bf16"),
                acts=acts("K3", "K3_bf16", "bf16")),
            row("edge_map_backward_tc_fp32", "edge_map_bwd_tc.cu", replaces_k3, train_fp32, "K3_fp32",
                k3["fp32"], "fp32", bound_rate=k3["fp32"]["bound_rate"], **body(k3["fp32"]),
                bound_ms_cuda_cores=k3["fp32"]["bound_ms_cuda_cores"],
                nms=nms(nk["K3"], nms_steps["K3_fp32"], fp32="fp32"),
                rs=nms(rk["K3"], rs_steps["K3_fp32"], fp32="fp32"),
                psr=nms(pk["K3"], psr_steps["K3_fp32"], fp32="fp32"),
                cpd=nms(ck["K3"], cpd_steps["K3_fp32"], fp32="fp32"),
                eq=nms(ek["K3"], eq_steps["K3_fp32"], fp32="fp32"),
                ar=nms(ak["K3"], ar_steps["K3_fp32"], fp32="fp32"), cfg=cfg("K3_fp32"),
                acts=acts("K3", "K3_fp32", "fp32")),
        ]
    }


class TimedReport(dict):
    """The report, which also keeps the seconds since the previous entry
    for each entry set (``seconds``): a phase's time, its set-up in main
    included.  Each entry prints, flushed, its phase's seconds and the
    run's so far (``chip_smoke: phase <name> <s> s, total <t> s``), so a
    run that is cut shows the last phase it finished."""

    def __init__(self, start: float):
        super().__init__()
        self.seconds = {}
        self._start = self._last = start

    def __setitem__(self, key, value):
        now = time.perf_counter()
        self.seconds[key], self._last = now - self._last, now
        print(f"chip_smoke: phase {key} {self.seconds[key]:.1f} s, total {now - self._start:.1f} s", flush=True)
        super().__setitem__(key, value)


@contextlib.contextmanager
def required_esm():
    """GCPNET_REQUIRE_ESM=1 inside: an EQ sequence without its ESM-2
    embedding raises instead of reading zeros."""
    os.environ["GCPNET_REQUIRE_ESM"] = "1"
    try:
        yield
    finally:
        os.environ.pop("GCPNET_REQUIRE_ESM", None)


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
    # every graph keeps its nodes, from which profile_replay reads a
    # replay's kernels
    CapturedCall.keep_graphs = True
    os.makedirs(args.out_dir, exist_ok=True)
    # the simulated NMS splits (~70 MB) and checkpoints are removed at the end
    work = tempfile.mkdtemp(prefix="chip_smoke_nms_")
    data_root, ckpt_dir = os.path.join(work, "data"), os.path.join(args.out_dir, "nms_checkpoints")
    rs_ckpt_dir = os.path.join(args.out_dir, "rs_checkpoints")
    psr_root, psr_ckpt_dir = os.path.join(work, "atom3d"), os.path.join(args.out_dir, "psr_checkpoints")
    cpd_root, cpd_ckpt_dir = os.path.join(work, "cath"), os.path.join(args.out_dir, "cpd_checkpoints")
    eq_root, eq_ckpt_dir = os.path.join(work, "eq"), os.path.join(args.out_dir, "eq_checkpoints")
    ar_root, ar_ckpt_dir = os.path.join(work, "ar"), os.path.join(args.out_dir, "ar_checkpoints")
    cfg_run_dir = os.path.join(args.out_dir, "cfg_run")
    family_dir, rs_e3_dir = os.path.join(args.out_dir, "gcp_family"), os.path.join(args.out_dir, "rs_e3_checkpoints")
    overrides_dir, acts_dir = os.path.join(args.out_dir, "overrides"), os.path.join(args.out_dir, "acts")
    run_dirs = (ckpt_dir, rs_ckpt_dir, psr_ckpt_dir, cpd_ckpt_dir, eq_ckpt_dir, ar_ckpt_dir, cfg_run_dir, family_dir,
                rs_e3_dir, overrides_dir, acts_dir)
    for path in run_dirs:
        shutil.rmtree(path, ignore_errors=True)
    report = TimedReport(t_start)
    ahead = WrittenAhead()
    try:
        report["device"] = phase_device()
        # the data sets' records, written on the host while nvcc builds
        ahead.start("psr", write_psr_records, psr_root)
        ahead.start("cpd", write_cath_chains, cpd_root, seed=SEED, chains=CPD_CHAINS, lengths=CPD_LENGTHS)
        ahead.start("eq", write_eq_decoys, eq_root, seed=SEED, targets=EQ_TARGETS, decoys=EQ_DECOYS,
                    residues=EQ_RESIDUES)
        ahead.start("ar", write_ar_pairs, ar_root, seed=SEED, pairs=AR_PAIRS)
        ahead.start("lba", write_lba_records, os.path.join(work, "cfg_data", "ATOM3D"))
        report["build"] = phase_build(args.out_dir)
        batches = synthetic_batches(FORWARD_BATCHES, GRAPHS, NODES, EDGES_PER_NODE, SEED)
        csr = synthetic_batches(1, GRAPHS, NODES, EDGES_PER_NODE, SEED, sort_tile=1)[0]
        report["K1"] = phase_k1({128: batches[0], 1: csr})
        report["K2"] = phase_k2(batches[0], bench_message_passing())
        report["K3"] = phase_k3(batches[0], bench_message_passing())
        # every K1 timing (queued_ms) before the first CUDA graph
        dm, report["nms_data"] = phase_nms_data(data_root)
        report["nms_kernels"] = phase_nms_kernels(dm)
        rs_dm, report["rs_data"] = phase_rs_data()
        report["rs_kernels"] = phase_rs_kernels(rs_dm)
        psr_dm, report["psr_data"] = phase_psr_data(psr_root, ahead)
        report["psr_kernels"] = phase_psr_kernels(psr_dm)
        del psr_dm
        cpd_dm, report["cpd_data"] = phase_cpd_data(cpd_root, ahead)
        report["cpd_kernels"] = phase_cpd_kernels(cpd_dm)
        del cpd_dm
        report["esm"] = phase_esm(eq_root, work, ahead)
        with required_esm():
            eq_dm, report["eq_data"] = phase_eq_data(eq_root, report["esm"]["eq_written"],
                                                     report["esm"]["eq_write_seconds"])
        report["eq_kernels"] = phase_eq_kernels(eq_dm)
        del eq_dm
        ar_dm, report["ar_data"] = phase_ar_data(ar_root, ahead)
        report["ar_kernels"] = phase_ar_kernels(ar_dm)
        del ar_dm
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
        del rs_trainer
        report["determinism"] = phase_determinism(rs_dm)
        report["psr_check"] = phase_psr_check(psr_root)
        psr_trainer, psr_dm, report["psr_fit"] = phase_psr_fit(
            psr_root, psr_ckpt_dir, report["psr_data"]["graphs_per_batch"]
        )
        report["psr_profile"] = phase_psr_profile(psr_trainer, psr_dm, report["psr_fit"])
        del psr_trainer, psr_dm
        report["cpd_check"] = phase_cpd_check(cpd_root)
        cpd_trainer, cpd_dm, report["cpd_fit"] = phase_cpd_fit(
            cpd_root, cpd_ckpt_dir, report["cpd_data"]["graphs_per_batch"]
        )
        report["cpd_profile"] = phase_cpd_profile(cpd_trainer, cpd_dm, report["cpd_fit"])
        report["cpd_design"] = phase_cpd_design(cpd_trainer, cpd_dm)
        del cpd_trainer, cpd_dm
        report["eq_check"] = phase_eq_check(os.path.join(work, "eq_check"))
        with required_esm():
            eq_trainer, eq_dm, report["eq_fit"] = phase_eq_fit(eq_root, eq_ckpt_dir)
        report["eq_profile"] = phase_eq_profile(eq_trainer, eq_dm, report["eq_fit"])
        del eq_trainer, eq_dm
        report["ar_check"] = phase_ar_check(os.path.join(work, "ar_check"))
        ar_trainer, ar_dm, report["ar_fit"] = phase_ar_fit(ar_root, ar_ckpt_dir)
        report["ar_profile"] = phase_ar_profile(ar_trainer, ar_dm, report["ar_fit"], report["ar_data"])
        report["ar_predict"] = phase_ar_predict(ar_trainer, os.path.join(work, "ar_predict"))
        del ar_trainer, ar_dm
        gc.collect()
        report["cfg_train"] = phase_cfg_train(os.path.join(work, "cfg_data"), cfg_run_dir, ahead)
        report["cfg_eval"] = phase_cfg_eval(os.path.join(work, "cfg_data"), cfg_run_dir, report["cfg_train"])
        report["cfg_predict"] = phase_cfg_predict(eq_root, eq_ckpt_dir, os.path.join(work, "cfg_predict"))
        report["gcp_family"] = phase_gcp_family(os.path.join(work, "cfg_data"), family_dir)
        report["overrides"] = phase_overrides(psr_root, eq_root, os.path.join(work, "eq_check"),
                                              os.path.join(work, "cfg_data"), overrides_dir)
        report["acts"] = phase_acts(batches[0], os.path.join(work, "cfg_data"), acts_dir,
                                    report["device"]["nvidia_smi"])
        report["rs_e3"] = phase_rs_e3(rs_dm, rs_e3_dir)
        del rs_dm
        gc.collect()
        report["ddp"] = phase_ddp(work)
        report["remat"] = phase_remat(batches[0], os.path.join(work, "cfg_data"))
        report["dense"] = phase_dense(eq_root, ar_root)
        report["scorers"] = phase_scorers(eq_root, work, report["ar_predict"]["rows"][0]["refined_pdb"])
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        ahead.close()
        for path in (work, *run_dirs):
            shutil.rmtree(path, ignore_errors=True)
        report.seconds["total"] = time.perf_counter() - t_start
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump({**report, "seconds": report.seconds}, f, indent=1)
    print("chip_smoke: seconds by phase " + json.dumps({k: round(v, 1) for k, v in report.seconds.items()}))
    print(f"chip_smoke: every phase ok in {report.seconds['total']:.1f} s")
    print(json.dumps(kernel_line(report)))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": report["device"]["kind"], "count": report["device"]["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
