"""The port's CUDA kernels, its prediction and its gradients on the card
(marked ``gpu``).

This file imports no JAX, so it also runs on a machine that has none; there
it runs without the repository's ``conftest.py``, which sets JAX up:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Without a CUDA device every test skips.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gcpnet_torch import predict as port_predict
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.ar import ARDataModule
from gcpnet_torch.data.ar_synthetic import write_ar_pairs
from gcpnet_torch.data.atom3d import ATOM3DDataModule
from gcpnet_torch.data.batching import Bucket, batches_from_dataset, sorted_index
from gcpnet_torch.data.cath import CATHDataModule
from gcpnet_torch.data.cath_synthetic import write_cath_chains
from gcpnet_torch.data.eq import EQDataModule
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.models.ar import GCPNetAR, ar_loss
from gcpnet_torch.models.cpd import GCPNetCPD, cpd_loss
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.models.lba import GCPNetLBA, GCPNetPSR, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.graph import GraphData
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops.build import library
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
    pack_stack,
)
from gcpnet_torch.ops.segment import SortedIndex, gather_rows, segment_count, segment_sum
from gcpnet_torch.ops.segment_sorted import DTYPE_CODES, segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.graphs import CapturedCall, EvalSteps, TrainSteps
from gcpnet_torch.train.optim import build_optimizer, build_schedule
from gcpnet_torch.train.state import TrainState
from gcpnet_torch.train.step import train_step
from gcpnet_torch.train.trainer import Trainer

pytestmark = pytest.mark.gpu

# K1 launches of a training step of 2 interaction layers: in the forward,
# each layer's mean (or sum) and node frames, and outside the layers the
# centring, the embedding's node frames and the head's node frames and pool
# (NMS: no head; CPD: node frames alone, and 1 decoder layer's sum); in
# the backward each layer's two gathers of node rows (a decoder layer's
# four, and CPD's sequence gather), K1 over the cotangent rows
K1_POOLED_STEP = 4 + 2 * 2 + 2 * 2  # LBA, PSR, RS, EQ
K1_NMS_STEP = 2 + 2 * 2 + 2 * 2
K1_CPD_STEP = (3 + 2 * 2 + 1) + (2 * 2 + 4 + 1)
K1_AR_STEP = 2 + 2 * 2 + 2 * 2  # AR: the centring and the embedding's node frames outside the layers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _k1_tol(dtype):
    # bf16: both round a float32 sum once; the order can flip that rounding
    return dict(atol=1e-4) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)


def _k1_check(data, splits, num_nodes):
    """K1 against its plain version and against torch.segment_reduce over
    the clamped ranges."""
    before = segment_sum_sorted.launches
    got = segment_sum_sorted(data, splits, num_nodes)
    torch.cuda.synchronize()
    assert segment_sum_sorted.launches == before + 1
    tol = _k1_tol(data.dtype)
    want = segment_sum_sorted_plain(data, splits, num_nodes)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    bounds = splits.long().clamp(0, data.shape[0])
    library = torch.segment_reduce(
        data[bounds[0] : bounds[-1]].float(), "sum", lengths=bounds[1:] - bounds[:-1], unsafe=True
    )
    np.testing.assert_allclose(got.float().cpu().numpy(), library.cpu().numpy(), **tol)


# 148: the main path's width, 16-byte vectors; 4: one vector a row; 9 and
# 6: not a multiple of 4, one column a thread
K1_DIMS = [148, 9, 4, 6]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", K1_DIMS)
@pytest.mark.parametrize("tile", [128, 1])
def test_k1_cuda_matches_plain(rng, cuda, tile, dim, dtype):
    batch = port_predict.synthetic_batches(1, 2, 70, 6, seed=2, sort_tile=tile)[0]
    splits = torch.from_numpy(batch.edge_row_splits).to(cuda)
    data = torch.from_numpy(rng.normal(size=(batch.num_edges, dim)).astype(np.float32)).to(cuda, dtype)
    _k1_check(data, splits, batch.num_nodes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", K1_DIMS)
def test_k1_empty_segments_and_splits_past_the_rows(rng, cuda, dim, dtype):
    """Runs of empty segments (inside a block of nodes and across blocks),
    rows before the first split, and splits past the last row (clamped)."""
    rows, nodes = 300, 45
    lengths = rng.integers(0, 30, size=nodes)
    lengths[3:14] = 0  # more empty nodes in a row than a block holds
    lengths[-5:] = 40  # the last nodes run past the rows
    splits = np.concatenate([[7], 7 + np.cumsum(lengths)]).astype(np.int32)
    assert splits[-1] > rows
    data = torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32)).to(cuda, dtype)
    _k1_check(data, torch.from_numpy(splits).to(cuda), nodes)


STACK_SETTINGS = {
    "production": ModuleCfg(),
    "norm_gate_vector_residual": ModuleCfg(
        vector_gate=False, vector_nonlinearity="relu", vector_residual=True
    ),
}
# the activations of the kernels' layer table: relu (LBA), leaky relu on the
# scalars (RS), and leaky relu in the vector gate's act_v(s) @ Wg as well
# (no shipped model: the vector slot takes every code the scalar slot does)
ACTIVATION_SETTINGS = {
    "production": ModuleCfg(),
    "leaky": ModuleCfg(scalar_nonlinearity="leakyrelu"),
    "leaky_gate": ModuleCfg(scalar_nonlinearity="leakyrelu", vector_nonlinearity="leakyrelu"),
}
# silu (act code 3) on scalars and vectors: in the vector gate (AR's GCP3
# stack), and in the norm gate without one
SILU_SETTINGS = {
    "silu_gate": ModuleCfg(selected_gcp="GCP3", scalar_nonlinearity="silu", vector_nonlinearity="silu"),
    "silu_norm": ModuleCfg(scalar_nonlinearity="silu", vector_nonlinearity="silu", vector_gate=False),
}


# the transcendental codes the layer table took last (selu, gelu, sigmoid, tanh), each as
# the scalar activation and as the vector one, under both gates:
# chip_smoke.py's acts phase's four stacks
TRANSCENDENTAL_SETTINGS = {
    "gelu_sigmoid_gate": ModuleCfg(scalar_nonlinearity="gelu", vector_nonlinearity="sigmoid"),
    "selu_tanh_gate": ModuleCfg(scalar_nonlinearity="selu", vector_nonlinearity="tanh"),
    "sigmoid_gelu_norm": ModuleCfg(scalar_nonlinearity="sigmoid", vector_nonlinearity="gelu", vector_gate=False),
    "tanh_selu_norm": ModuleCfg(scalar_nonlinearity="tanh", vector_nonlinearity="selu", vector_gate=False),
}
# every name of nn.primitives.get_nonlinearity (the JAX package's table)
EVERY_ACTIVATION = ["relu", "leakyrelu", "selu", "silu", "swish", "gelu", "sigmoid", "tanh"]


def _message_passing(
    cfg: ModuleCfg, num_message_layers: int = 4, residual: bool = True, node_dims=(16, 4),
    output_dims=(16, 4), edge_dims=(8, 4),
) -> GCPMessagePassing:
    mp_cfg = MPCfg(num_message_layers=num_message_layers, use_residual_message_gcp=residual)
    return GCPMessagePassing(
        node_dims, output_dims, edge_dims, cfg, LayerCfg(mp_cfg=mp_cfg),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )


def _stack_inputs(rng, stack, e, dtype, device):
    """Messages (a quarter of the rows with zero vectors, where the norm's
    eps decides) and frames."""
    msg = rng.normal(size=(e, stack.in_dim)).astype(np.float32)
    msg[: e // 4, stack.layers[0].dims[0] :] = 0.0
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    return (torch.from_numpy(msg).to(device, dtype), torch.from_numpy(frames).to(device, dtype))


# K2 against its plain version.  float32, max |kernel - plain| <= 1e-4:
# split TF32 keeps float32's precision in every product; the summation
# order differs.  bf16, max |kernel - plain| <= 2e-2 * max(1, max |plain|):
# both take bf16 operands, float32 accumulators and round each product's
# output to bf16; the plain version also rounds its elementwise work
# (squares, sums, bias additions) to bf16, where the kernel rounds once
# after it, so the two part by a few bf16 roundings (2^-8 relative each) a
# layer: chip_smoke.py's bound, where 8 layers read 0.0106 on the H100.
K2_FP32_ATOL = 1e-4
K2_BF16_TOL = 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("settings", sorted(STACK_SETTINGS) + ["leaky_gate"])
def test_k2_cuda_matches_plain(rng, cuda, settings, dtype):
    cfg = {**STACK_SETTINGS, **ACTIVATION_SETTINGS}[settings]
    stack = _message_passing(cfg).to(cuda, dtype).packed_stack()
    e = 1000  # not a multiple of the kernel's 64-row tile
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    before = edge_map.launches
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        torch.cuda.synchronize()
        want = edge_map_plain(msg, frames, stack)
    assert edge_map.launches == before + 1
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=K2_FP32_ATOL)
    else:
        assert _max_rel_err(got, want) <= K2_BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_is_deterministic(rng, cuda, dtype):
    with torch.no_grad():
        stack = _message_passing(ModuleCfg()).to(cuda, dtype).packed_stack()
        msg, frames = _stack_inputs(rng, stack, 5000, dtype, cuda)
        first = edge_map(msg, frames, stack)
        again = edge_map(msg, frames, pack_stack(stack.layers, stack.residual))  # images built anew
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_rejects_a_stack_too_wide_for_its_tile(rng, cuda, dtype):
    """A first layer of 4,808 input scalars: its rows of the tile alone
    exceed the block's shared memory, at 64 rows as at the 32 that K2 takes
    for a stack too wide for 64."""
    with torch.no_grad():
        stack = _message_passing(ModuleCfg(), node_dims=(2400, 4)).to(cuda, dtype).packed_stack()
    msg, frames = _stack_inputs(rng, stack, 100, dtype, cuda)
    before = edge_map.launches
    with pytest.raises(NotImplementedError, match="shared memory"), torch.no_grad():
        edge_map(msg, frames, stack)
    assert edge_map.launches == before


def test_k2_builds_images_once_per_cached_stack(rng, cuda):
    """Under inference mode the packed stack is cached, and with it K2's
    weight images: the second call builds none."""
    mp = _message_passing(ModuleCfg()).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        stack = mp.packed_stack()
        msg, frames = _stack_inputs(rng, stack, 300, torch.bfloat16, cuda)
        first = edge_map(msg, frames, stack)
        images = stack.images[torch.bfloat16]
        assert mp.packed_stack() is stack
        again = edge_map(msg, frames, mp.packed_stack())
    assert stack.images[torch.bfloat16] is images and list(stack.images) == [torch.bfloat16]
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("settings", ["production", "leaky_gate", "silu_gate"])
def test_k2_bf16_is_the_state_k3_recomputes(rng, cuda, settings, residual, dtype):
    """K2 and K3's forward sweep run the same layer body, in bf16 and in
    float32 (split TF32): the state K3 keeps in its scratch before each
    layer l >= 1 equals, bit for bit, K2's output for the stack's first l
    layers.  K3 is launched with one block per tile, so that each block's
    scratch holds its own tile."""
    with torch.no_grad():
        cfg = {**ACTIVATION_SETTINGS, **SILU_SETTINGS}[settings]
        stack = _message_passing(cfg, residual=residual).to(cuda, dtype).packed_stack()
    lib = library("edge_map_bwd_tc")
    code = DTYPE_CODES[dtype]
    tiles, tile = 5, k3_tile(stack, dtype)[0]
    assert tile == (64 if dtype == torch.bfloat16 else 32)
    e = tiles * tile
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    w_len = stack.weights.numel()
    widths = [s_in + 3 * v_in for s_in, v_in, *_ in (layer.dims for layer in stack.layers[1:])]
    stash_len = tile * sum(widths)
    images = torch.empty(
        lib.gcp_edge_map_bwd_tc_image_bytes(stack.meta.ctypes.data, stack.meta.size, code),
        dtype=torch.uint8, device=cuda,
    )
    partials = torch.empty(tiles * w_len, device=cuda)
    scratch = torch.empty(tiles * stash_len, dtype=dtype, device=cuda)
    d_msg, d_w = torch.empty_like(msg), torch.empty_like(stack.weights)
    err = lib.gcp_edge_map_bwd_tc(
        msg.data_ptr(), frames.data_ptr(), grad_out.data_ptr(), stack.weights.data_ptr(), stack.meta.ctypes.data,
        stack.meta.size, d_msg.data_ptr(), d_w.data_ptr(), images.data_ptr(), partials.data_ptr(),
        scratch.data_ptr(), w_len, stash_len, e, tiles, code, torch.cuda.current_stream().cuda_stream,
    )
    assert err == 0
    scratch = scratch.view(tiles, stash_len)
    offset = 0
    for l, width in enumerate(widths, start=1):
        s_out, v_out = stack.layers[l - 1].dims[3:]
        slot = scratch[:, offset : offset + tile * width]
        offset += tile * width
        scalars = slot[:, : tile * s_out].reshape(e, s_out)
        # [tile][row * 3 + c][v_out] -> [E][c * v_out + o], K2's layout
        vectors = slot[:, tile * s_out :].reshape(tiles, tile, 3 * v_out).reshape(e, 3 * v_out)
        with torch.no_grad():
            out = edge_map(msg, frames, pack_stack(stack.layers[:l], residual))
        assert torch.equal(out[:, :s_out], scalars), l
        assert torch.equal(out[:, s_out:], vectors), l


def _max_rel_err(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()


def _norm_rel_err(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()


def _k3_leaf_errs(d_msg, d_w, want_msg, want_w, stack):
    """The norm-relative error of d message and of each weight matrix and
    bias of each layer ("3.b_gate": layer 3's gate bias)."""
    errs = {"d_message": _norm_rel_err(d_msg, want_msg)}
    for i, (got, want) in enumerate(zip(stack.layer_weights(d_w), stack.layer_weights(want_w))):
        errs.update({f"{i}.{name}": _norm_rel_err(got[name], w) for name, w in want.items() if w is not None})
    return errs


# K3's bounds, leaf by leaf, in norm (relu kinks, as in chip_smoke.py).
# float32: float32-grade products (split TF32), the summation order differs.
K3_FP32_LEAF_TOL = 1e-4
# bf16: the kernel computes as the JAX kernel does (bf16 operands, float32
# accumulators, each product's output rounded to bf16), as does the plain
# bf16 version (chip_smoke.py gives the reasons at the main path's shape).
# Here a leaf sums fewer rows (1,000, a quarter with zero vectors), so
# bf16's roundings (2^-8 relative each) average out less: on the H100 the
# kernel's leaves read at most 0.073 from the float32 plain version on the
# same bf16 inputs and 0.080 from the plain bf16 version (whose own leaves
# read up to 0.099 from float32); at the main path's shape a build that
# misses a part of the work reads at least 0.16 on the leaves that part
# feeds.  The bound against both is 32 * 2^-8.
K3_BF16_LEAF_TOL = 2.0**-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("settings", sorted(STACK_SETTINGS))
def test_k3_cuda_matches_plain(rng, cuda, settings, residual, dtype):
    with torch.no_grad():
        stack = _message_passing(STACK_SETTINGS[settings], residual=residual).to(cuda, dtype).packed_stack()
    e = 1000  # not a multiple of the kernel's tiles (32 rows in float32, 64 in bf16)
    msg = rng.normal(size=(e, stack.in_dim)).astype(np.float32)
    msg[: e // 4, stack.layers[0].dims[0] :] = 0.0  # zero vectors: the norm's eps decides
    msg = torch.from_numpy(msg).to(cuda, dtype)
    frames = torch.from_numpy(rng.normal(size=(e, 9)).astype(np.float32)).to(cuda, dtype)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    before = edge_map_backward.launches
    by_dtype = dict(edge_map_backward.dtype_launches)
    d_msg, d_w = edge_map_backward(msg, frames, stack, grad_out)
    torch.cuda.synchronize()
    assert edge_map_backward.launches == before + 1
    assert edge_map_backward.dtype_launches == {d: n + (d == dtype) for d, n in by_dtype.items()}
    assert d_msg.dtype == dtype and d_w.dtype == torch.float32
    want_msg, want_w = edge_map_backward_plain(msg, frames, stack, grad_out)
    if dtype == torch.float32:
        # float32-grade products (split TF32); the summation order differs
        assert _max_rel_err(d_msg, want_msg) <= 1e-4
        assert _max_rel_err(d_w, want_w) <= 1e-4
        leaves = _k3_leaf_errs(d_msg, d_w, want_msg, want_w, stack)
        assert max(leaves.values()) <= K3_FP32_LEAF_TOL, leaves
    else:
        up_msg, up_w = edge_map_backward_plain(msg.float(), frames.float(), stack, grad_out.float())
        leaves = _k3_leaf_errs(d_msg, d_w, up_msg, up_w, stack)
        assert max(leaves.values()) <= K3_BF16_LEAF_TOL, leaves
        leaves = _k3_leaf_errs(d_msg, d_w, want_msg, want_w, stack)
        assert max(leaves.values()) <= K3_BF16_LEAF_TOL, leaves


def _nms_message_passing() -> GCPMessagePassing:
    """One message passing layer of the NMS model at its full width (hidden
    64/16, edges 32/4, 8 ResGCP2 layers): the stack takes [E, 160 + 3 * 36]
    messages to [E, 64 + 3 * 16], hidden vectors 9 then 4."""
    mp = _message_passing(
        ModuleCfg(), num_message_layers=8, node_dims=(64, 16), output_dims=(64, 16), edge_dims=(32, 4)
    )
    dims = [m.input_dims + m.output_dims for m in mp.stack]
    assert dims == [(160, 36, 64, 16)] + [(64, 16, 64, 16)] * 7
    return mp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_match_plain_at_nms_widths(rng, cuda, dtype):
    """K2 and K3 at the NMS model's stack widths (268 -> 112 a row, a
    narrower scalar state than LBA's 340 -> 148), on 1,900 rows (the
    tiles' ragged edge included), against their plain versions at the
    bounds of test_k2_cuda_matches_plain and test_k3_cuda_matches_plain."""
    with torch.no_grad():
        stack = _nms_message_passing().to(cuda, dtype).packed_stack()
    assert [layer.dims for layer in stack.layers] == [(160, 36, 9, 64, 16)] + [(64, 16, 4, 64, 16)] * 7
    e = 1900
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=K2_FP32_ATOL)
    else:
        assert _max_rel_err(got, want) <= K2_BF16_TOL
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


def _k3_check_with_kink_rule(msg, frames, stack, grad_out):
    """K3 against its plain version.  float32: at 8 layers a row may hold a
    pre-activation within float32 rounding of 0, where the kernel and the
    plain version take different sides of a kink (relu, leaky relu, whose
    derivative steps by 1 - slope, or selu) and the row's d message differs
    by O(1).  Each row that parts from the plain version must be such a
    kink (a kink margin under KINK_MARGIN in float64), and no more than
    max_kink_rows of them (ops/edge_map.py gives the reasons, as in
    chip_smoke.py's phase K3); with their cotangents set to 0 every result
    is held to 1e-4.  bf16: every leaf against the plain bf16 version and
    the float32 one, in norm (K3_BF16_LEAF_TOL)."""
    e = msg.shape[0]
    d_msg, d_w = edge_map_backward(msg, frames, stack, grad_out)
    want_msg, want_w = edge_map_backward_plain(msg, frames, stack, grad_out)
    if msg.dtype == torch.float32:
        scale = max(1.0, want_msg.abs().max().item())
        kinks = ((d_msg - want_msg).abs().amax(dim=1) > 1e-4 * scale).nonzero().flatten()
        assert kinks.numel() <= max_kink_rows(e), kinks.tolist()
        margins = kink_margins(msg, frames, stack)[kinks]
        assert bool((margins <= KINK_MARGIN).all()), (kinks.tolist(), margins.tolist())
        grad_out = grad_out.clone()
        grad_out[kinks] = 0.0
        d_msg, d_w = edge_map_backward(msg, frames, stack, grad_out)
        want_msg, want_w = edge_map_backward_plain(msg, frames, stack, grad_out)
        assert _max_rel_err(d_msg, want_msg) <= 1e-4 and _max_rel_err(d_w, want_w) <= 1e-4
        leaves = _k3_leaf_errs(d_msg, d_w, want_msg, want_w, stack)
        assert max(leaves.values()) <= K3_FP32_LEAF_TOL, leaves
    else:
        leaves = _k3_leaf_errs(d_msg, d_w, want_msg, want_w, stack)
        assert max(leaves.values()) <= K3_BF16_LEAF_TOL, leaves
        up_msg, up_w = edge_map_backward_plain(msg.float(), frames.float(), stack, grad_out.float())
        leaves = _k3_leaf_errs(d_msg, d_w, up_msg, up_w, stack)
        assert max(leaves.values()) <= K3_BF16_LEAF_TOL, leaves


def _lba_width_message_passing(cfg: ModuleCfg) -> GCPMessagePassing:
    """One message passing layer at LBA's (and RS's) full width: hidden
    100/16, edges 32/4, 8 ResGCP2 layers, [E, 340] -> [E, 148]."""
    return _message_passing(
        cfg, num_message_layers=8, node_dims=(100, 16), output_dims=(100, 16), edge_dims=(32, 4)
    )


# the RS training batch's row count: its bucket's edge rows (64 anchors and
# their enantiomers, 64 nodes a graph, twice as many edges)
RS_BATCH_ROWS = 16384


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("settings", sorted(ACTIVATION_SETTINGS))
def test_k2_k3_match_plain_at_lba_widths(rng, cuda, settings, dtype):
    """K2 and K3 at LBA's widths on the RS batch's 16,384 rows, with relu,
    leaky relu on the scalars (RS's stack) and leaky relu in the vector gate
    too: K2 at the bounds of test_k2_cuda_matches_plain (fp32 relative to
    max(1, max |plain|), as chip_smoke.py holds it), K3 under the kink rule
    (_k3_check_with_kink_rule)."""
    with torch.no_grad():
        stack = _lba_width_message_passing(ACTIVATION_SETTINGS[settings]).to(cuda, dtype).packed_stack()
    assert stack.in_dim == 340 and stack.out_dim == 148
    codes = {(layer.act_s, layer.act_v) for layer in stack.layers}
    assert codes == {("relu" if settings == "production" else "leakyrelu",
                      "leakyrelu" if settings == "leaky_gate" else None), (None, None)}
    e = RS_BATCH_ROWS
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    before = (edge_map.launches, edge_map_backward.launches)
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, want) <= (1e-4 if dtype == torch.float32 else K2_BF16_TOL)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)
    assert edge_map.launches == before[0] + 1 and edge_map_backward.launches > before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("settings", ["production", "leaky_gate"])
def test_k3_is_deterministic(rng, cuda, settings, dtype):
    with torch.no_grad():
        stack = _message_passing(ACTIVATION_SETTINGS[settings]).to(cuda, dtype).packed_stack()
    e = 5000
    args = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
        for shape in ((e, stack.in_dim), (e, 9), (e, stack.out_dim))
    ]
    first = edge_map_backward(args[0], args[1], stack, args[2])
    again = edge_map_backward(args[0], args[1], stack, args[2])
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["message", "weight"])
@pytest.mark.parametrize("settings", ["production", "leaky_gate", *sorted(TRANSCENDENTAL_SETTINGS)])
def test_k2_k3_keep_nans(rng, cuda, settings, where, dtype):
    """A NaN of the card's own form (every mantissa bit set) in one message
    row or in one weight: K2's output is a NaN exactly where the plain
    version's is, and K3's results wherever the plain backward's are (K3
    takes relu's derivative at a NaN as 0, as JAX does, where torch passes
    the cotangent on, so its NaNs may spread further; leaky relu's is the
    slope in both; selu's is a NaN, as JAX's, where torch's is the scale;
    the other transcendental codes' a NaN in both).  Each transcendental
    code as the scalar and as the vector activation, under both gates."""
    with torch.no_grad():
        cfg = {**ACTIVATION_SETTINGS, **TRANSCENDENTAL_SETTINGS}[settings]
        stack = _message_passing(cfg).to(cuda, dtype).packed_stack()
        e = 300
        msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
        if where == "message":  # the last vector column of row 5
            if dtype == torch.float32:
                msg.view(torch.int32)[5, -1] = 0x7FFFFFFF
            else:
                msg.view(torch.int16)[5, -1] = 0x7FFF
        else:  # the last layer's vector_up, before K2 builds its images
            stack.layer_weights(stack.weights)[-1]["w_up"].view(torch.int32)[0, 0] = 0x7FFFFFFF
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(want.isnan().any()) and not bool(want.isnan().all())
    assert torch.equal(got.isnan(), want.isnan())
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    got = edge_map_backward(msg, frames, stack, grad_out)
    want = edge_map_backward_plain(msg, frames, stack, grad_out)
    for g, w in zip(got, want):
        assert bool(w.isnan().any())
        assert bool(g.isnan()[w.isnan()].all())


class _OpsOn(TorchDispatchMode):
    """Records every aten op that takes a tensor sharing ``tensor``'s
    storage."""

    def __init__(self, tensor):
        super().__init__()
        self.storage = tensor.untyped_storage().data_ptr()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = [*args, *kwargs.values()]
        leaves += [x for a in leaves if isinstance(a, (list, tuple)) for x in a]
        if any(isinstance(a, torch.Tensor) and a.untyped_storage().data_ptr() == self.storage for a in leaves):
            self.ops.append(str(func))
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_bf16_makes_no_transposed_copy(rng, cuda, dtype):
    """K3 reads the staged weights both ways inside the kernel (bf16 through
    ldmatrix, float32 a word a lane): no op on the card touches the weight
    buffer, so no transposed copy of the weights is made."""
    with torch.no_grad():
        stack = _message_passing(ModuleCfg()).to(cuda, dtype).packed_stack()
    e = 200
    args = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
        for shape in ((e, stack.in_dim), (e, 9), (e, stack.out_dim))
    ]
    with _OpsOn(stack.weights) as ops:
        d_msg, d_w = edge_map_backward(*args[:2], stack, args[2])
    torch.cuda.synchronize()
    assert ops.ops == []
    assert bool(torch.isfinite(d_msg).all()) and bool(torch.isfinite(d_w).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_rejects_a_stack_too_wide_for_its_tile(rng, cuda, dtype):
    """A first layer of 4,808 input scalars: its rows of the tile alone
    exceed the block's shared memory, for float32's 32-row tile and its
    16-row half as for bf16's 64 and 32 (K3 halves its tile for a stack too
    wide for the full one; 1,208 fit float32's 32 rows)."""
    with torch.no_grad():
        stack = _message_passing(ModuleCfg(), node_dims=(2400, 4)).to(cuda, dtype).packed_stack()
    msg, frames = _stack_inputs(rng, stack, 100, dtype, cuda)
    grad_out = torch.zeros((100, stack.out_dim), dtype=dtype, device=cuda)
    before = edge_map_backward.launches
    with pytest.raises(NotImplementedError, match="shared memory"):
        edge_map_backward(msg, frames, stack, grad_out)
    assert edge_map_backward.launches == before


def test_lba_gradients_on_card_match_cpu(cuda):
    """The fused path keeps the autograd graph on the card: a 2-layer LBA
    loss gives every parameter the CPU's gradient (the message stacks' and
    the embeddings' included), through K1, K2 and K3."""
    model_cfg, module_cfg, layer_cfg = port_predict.lba_configs()
    model_cfg = model_cfg.replace(num_encoder_layers=2)
    batch = port_predict.synthetic_batches(1, 2, 40, 28, seed=1)[0]
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = GCPNetLBA(
            model_cfg, module_cfg, layer_cfg,
            generator=torch.Generator().manual_seed(0), device=dev,
        )
        launches = edge_map_backward.launches
        b = batch.to(torch.device(dev))
        loss, _ = graph_regression_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert edge_map_backward.launches == launches + 2
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def test_nms_gradients_on_card_match_cpu(cuda, tmp_path):
    """The NMS model at full width (2 of its 4 interaction layers) on 10
    simulated 20-body graphs: the loss and every parameter's gradient on the
    card against the CPU, through K1, K2 and the fp32 K3, with the position
    updates carried from layer to layer."""
    dm = NMSDataModule(
        data_root=str(tmp_path), data_mode="small_20body", batch_size=10, num_train=10, num_valid=10,
        num_test=10, sim_device="cpu",
    )
    dm.prepare_data()
    dm.setup()
    batch = next(dm.val_batches())
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = GCPNetNMS(
            *train_cli.task_configs("nms", num_encoder_layers=2, dropout=0.0),
            generator=torch.Generator().manual_seed(0), device=dev,
        )
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        loss, _ = nms_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (K1_NMS_STEP, 2, 2)
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def test_rs_gradients_on_card_match_cpu(cuda):
    """The RS model at full width (2 of its 8 interaction layers, leaky relu
    in every message stack) on a paired batch of 8 anchors and their
    enantiomers: the loss and every parameter's gradient on the card against
    the CPU, through K1, K2 and the fp32 K3."""
    dm = RSDataModule(batch_size=8, synthetic_sizes={"train": 32, "valid": 16, "test": 16})
    dm.setup()
    batch = next(dm.train_batches(seed=0))
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = GCPNetRS(
            *train_cli.task_configs("rs", num_encoder_layers=2, dropout=0.0),
            generator=torch.Generator().manual_seed(0), device=dev,
        )
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        loss, _ = rs_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (K1_POOLED_STEP, 2, 2)
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def _psr_datamodule(root, batch_size: int, max_nodes: int, **records) -> ATOM3DDataModule:
    """PSR on synthetic chain records (chip_smoke.write_psr_records)."""
    from chip_smoke import write_psr_records

    write_psr_records(str(root), **records)
    dm = ATOM3DDataModule(task="PSR", data_dir=str(root), batch_size=batch_size, max_nodes_per_batch=max_nodes)
    dm.setup()
    return dm


def test_psr_gradients_on_card_match_cpu(cuda, tmp_path):
    """The PSR model at full width (2 of its 5 interaction layers) on two
    synthetic decoys of 300-400 heavy atoms: the loss and every parameter's
    gradient on the card against the CPU, through K1, K2 and the fp32 K3."""
    dm = _psr_datamodule(tmp_path, 2, 1024, targets={"train": 1, "val": 1, "test": 1}, decoys=2, atoms=(300, 400))
    batch = next(dm.val_batches())
    assert int(batch.graph_pad_mask.sum()) == 2
    model_cfg, module_cfg, layer_cfg = port_predict.lba_configs()
    model_cfg = model_cfg.replace(num_encoder_layers=2, dropout=0.0, dense_dropout=0.0)
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = GCPNetPSR(
            model_cfg, module_cfg, layer_cfg.replace(dropout=0.0),
            generator=torch.Generator().manual_seed(0), device=dev,
        )
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        loss, _ = graph_regression_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (K1_POOLED_STEP, 2, 2)
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def _cpd_datamodule(root, batch_size: int, max_nodes: int, chains: dict) -> CATHDataModule:
    """CPD on synthetic CATH chains (data.cath_synthetic)."""
    write_cath_chains(str(root), chains=chains, lengths=(40, 120))
    dm = CATHDataModule(data_dir=str(root), batch_size=batch_size, max_nodes_per_batch=max_nodes)
    dm.setup()
    return dm


def _cpd_model(dev, encoder_layers: int = 2, decoder_layers: int = 1) -> GCPNetCPD:
    model_cfg, module_cfg, layer_cfg = train_cli.task_configs(
        "cpd", encoder_layers, dropout=0.0, num_decoder_layers=decoder_layers
    )
    return GCPNetCPD(model_cfg, module_cfg, layer_cfg, autoregressive_decoder=True,
                     generator=torch.Generator().manual_seed(0), device=dev)


def test_cpd_gradients_on_card_match_cpu(cuda, tmp_path):
    """The CPD model at full width (2 of its 9 encoder layers, 1 of its 3
    decoder layers) on two synthetic chains: the logits, the loss and every
    parameter's gradient on the card against the CPU, through K1 (the
    encoder's means and the decoder's sum), K2 and the fp32 K3."""
    dm = _cpd_datamodule(tmp_path, 2, 256, {"train": 1, "validation": 2, "test": 1})
    batch = next(dm.val_batches())
    assert int(batch.graph_pad_mask.sum()) == 2
    grads, out = {}, {}
    for dev in ("cuda", "cpu"):
        model = _cpd_model(dev)
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        logits = model(b)
        loss, _ = cpd_loss(logits, b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (K1_CPD_STEP, 2, 2)
        out[dev] = (logits.detach().cpu().numpy(), loss.item())
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=1e-4)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def test_cpd_argmax_samples_on_card_match_cpu(cuda, tmp_path):
    """The autoregressive sampler at temperature 1e-6 (an argmax) on three
    copies of a synthetic chain: each position's logits on the card are the
    CPU's, and so are the sequences.  On the card every sum runs through K1:
    the centring's, the embedding's node frames, two a encoder layer, and
    each decoder layer's sum at each position with a valid node."""
    dm = _cpd_datamodule(tmp_path, 1, 256, {"train": 1, "validation": 1, "test": 1})
    _, graph = next(dm.named_graphs("test"))
    n, copies = graph.num_nodes, 3
    batch = next(batches_from_dataset([graph] * copies, Bucket(n * copies, graph.num_edges * copies, copies)))
    seqs, logits = {}, {}
    for dev in ("cuda", "cpu"):
        model = _cpd_model(dev, 2, 3)
        logits[dev] = []
        model.invariant_node_projection.register_forward_hook(lambda m, i, out: logits[dev].append(out.cpu()))
        gen = torch.Generator(device=dev).manual_seed(0)
        k1 = segment_sum_sorted.launches
        seqs[dev] = model.sample(batch.to(torch.device(dev)), n, 1e-6, gen).cpu().numpy()
        if dev == "cuda":
            positions = int(batch.valid_node_mask()[:n].sum())
            assert segment_sum_sorted.launches - k1 == 2 + 2 * 2 + 3 * positions
    assert len(logits["cuda"]) == len(logits["cpu"]) == n
    for got, want in zip(logits["cuda"], logits["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(seqs["cuda"], seqs["cpu"])
    assert (seqs["cpu"].reshape(copies, n) == seqs["cpu"][:n]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_k3_match_plain_at_a_psr_batch(rng, cuda, tmp_path, dtype):
    """K1, K2 and K3 at a PSR training batch: the JAX bucket's 16,384 nodes
    and 524,288 receiver-sorted CSR rows (K1 sums the real rows into the
    nodes), LBA's stack widths (PSR's), against their plain versions: K1 at
    _k1_check's bounds, K2 at test_k2_k3_match_plain_at_lba_widths', K3
    under the kink rule (_k3_check_with_kink_rule)."""
    dm = _psr_datamodule(tmp_path, 16, 16384, targets={"train": 2, "val": 1, "test": 1}, decoys=8)
    batch = next(dm.train_batches(seed=0))
    assert (batch.num_nodes, batch.num_edges) == (16384, 16384 * 32)
    splits = torch.as_tensor(batch.edge_row_splits).to(cuda)
    data = torch.from_numpy(rng.normal(size=(batch.num_edges, 148)).astype(np.float32)).to(cuda, dtype)
    _k1_check(data, splits, batch.num_nodes)
    with torch.no_grad():
        stack = _lba_width_message_passing(ModuleCfg()).to(cuda, dtype).packed_stack()
    e = batch.num_edges
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    frames = frames * torch.as_tensor(batch.edge_pad_mask).to(cuda)[:, None]
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, want) <= (1e-4 if dtype == torch.float32 else K2_BF16_TOL)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


def test_k2_k3_run_a_gelu_stack(rng, cuda):
    """A stack with gelu on the scalars (sigmoid in the vector gate) goes
    through K2 and K3, as the JAX package's Pallas edge map takes it: the
    wrappers count one launch each, and the result and the gradients match
    the plain version (fp32, K3 leaf by leaf at K3_FP32_LEAF_TOL)."""
    stack = _message_passing(TRANSCENDENTAL_SETTINGS["gelu_sigmoid_gate"]).to(cuda).packed_stack()
    assert {layer.act_s for layer in stack.layers} == {"gelu", None}
    e = 1000
    msg, frames = _stack_inputs(rng, stack, e, torch.float32, cuda)
    msg.requires_grad_()
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda)
    before = (edge_map.launches, edge_map_backward.launches)
    out = edge_map(msg, frames, stack)
    d_msg, d_w = torch.autograd.grad(out, (msg, stack.weights), grad_out)
    assert (edge_map.launches, edge_map_backward.launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want = edge_map_plain(msg, frames, stack)
    want_msg, want_w = edge_map_backward_plain(msg.detach(), frames, stack, grad_out)
    assert _max_rel_err(out.detach(), want) <= 1e-4
    assert _max_rel_err(d_msg, want_msg) <= 1e-4 and _max_rel_err(d_w, want_w) <= 1e-4
    leaves = _k3_leaf_errs(d_msg, d_w, want_msg, want_w, stack)
    assert max(leaves.values()) <= K3_FP32_LEAF_TOL, leaves


def test_edge_map_refuses_an_activation_outside_the_table(rng, cuda):
    """A name outside get_nonlinearity's table (and so outside the kernels'
    layer table) raises on the card, naming it, in K2 and in K3."""
    stack = _message_passing(ModuleCfg()).to(cuda).packed_stack()
    layers = (dataclasses.replace(stack.layers[0], act_s="mish"), *stack.layers[1:])
    stack = pack_stack(layers, stack.residual)
    msg = torch.zeros((8, stack.in_dim), device=cuda)
    frames = torch.zeros((8, 9), device=cuda)
    with pytest.raises(NotImplementedError, match="'mish'.*tanh"):
        edge_map(msg, frames, stack)
    with pytest.raises(NotImplementedError, match="'mish'"):
        edge_map_backward(msg, frames, stack, torch.zeros((8, stack.out_dim), device=cuda))


def test_predict_on_card_matches_cpu(cuda):
    batch = port_predict.synthetic_batches(1, 2, 40, 28, seed=1)[0]
    k1, k2 = segment_sum_sorted.launches, edge_map.launches
    on_card = port_predict.predict(port_predict.build_model(0, cuda), batch)
    torch.cuda.synchronize()
    # 8 layers: a mean and node frames each, and 4 outside them
    assert (segment_sum_sorted.launches - k1, edge_map.launches - k2) == (2 * 8 + 4, 8)
    on_cpu = port_predict.predict(port_predict.build_model(0, "cpu"), batch)
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(), atol=1e-4)


# Captured steps (gcpnet_torch.train.graphs) against the eager ones.  The
# glue's index_add_ added with atomics in another order on every run, so a
# replay and an eager step were held to a tolerance, not bit for bit:
# float32 gradients ~1e-7 apart relative (its sums and gathers' backward
# now run through K1; test_fp32_runs_are_reproducible holds that).  Adam moves an entry by up to about lr a
# step whatever its gradient's size, so an entry whose gradient lies
# within rounding of 0 can take the other direction in the other run: the
# parameters may part by up to 2 lr a step, and at most
# REPLAY_PARAM_SHARE of them by more than REPLAY_PARAM_ATOL (a replay that
# read stale weights or skipped an update would move most of them by
# ~lr = 1e-3).  The losses are held
# relative to REPLAY_LOSS_RTOL and the gradient norms to 1e-3 (at full
# width two eager fp32 runs part by up to 3.2e-6 and 1.2e-4).
REPLAY_PARAM_ATOL = 1e-4
REPLAY_PARAM_SHARE = 0.01
REPLAY_LR = 1e-3
REPLAY_LOSS_RTOL = 1e-4


def _lba_training(cuda):
    """A 2-layer full-width LBA model with dropout 0.1, the adaptive clip,
    Adam at 1e-3 and a StepLR schedule, and its dropout generator."""
    model, state = train_cli.build_lba_training(
        0, cuda, torch.float32, lr=REPLAY_LR, dropout=0.1, adaptive_clip=True, num_encoder_layers=2
    )
    state.scheduler = build_schedule(state.optimizer, {"_target_": "StepLR", "step_size": 2, "gamma": 0.5})
    return model, state, torch.Generator(device=cuda).manual_seed(5)


def _wrapper_launches() -> tuple:
    return (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)


def _replayed_launches(call: CapturedCall, batches) -> tuple:
    """K1, K2 and K3 kernels that one replay of ``call``'s graph for
    ``batches`` launches, read from the graph's kernel nodes (a replay runs
    no Python, so the wrappers do not count its launches)."""
    names = call.kernel_names(batches)
    keys = ("seg_sum", "edge_map_tc_kernel", "edge_map_bwd_tc_kernel")
    return tuple(sum(count for name, count in names.items() if key in name) for key in keys)


def _lba_batches(n, nodes=40, seed=1):
    return port_predict.synthetic_batches(n, 2, nodes, 28, seed=seed)


def _train_state(model, state) -> dict:
    out = {f"param.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"opt.{i}.{k}": v.clone() for k, v in st.items()})
    out.update({
        "ring.buffer": state.ring.buffer.clone(), "ring.count": state.ring.count.clone(),
        "ring.head": state.ring.head.clone(), "schedule.count": state.scheduler.count.clone(),
        "lr": state.optimizer.lr.clone(),
    })
    return out


def _assert_params_close(got, want, steps: int) -> None:
    """Two runs' parameters (lists of tensors) after ``steps`` steps that
    may part: within 2 lr a step, and at most REPLAY_PARAM_SHARE of the
    entries beyond REPLAY_PARAM_ATOL."""
    diff = torch.cat([(g.detach() - w.detach()).abs().reshape(-1) for g, w in zip(got, want)])
    assert diff.max().item() <= 2 * REPLAY_LR * steps, diff.max().item()
    assert (diff > REPLAY_PARAM_ATOL).float().mean().item() <= REPLAY_PARAM_SHARE


def _assert_states_close(got: dict, want: dict, steps: int) -> None:
    assert got.keys() == want.keys()
    params = [k for k in want if k.startswith("param.")]
    _assert_params_close([got[k] for k in params], [want[k] for k in params], steps)
    for key in ("ring.count", "ring.head", "schedule.count", "lr"):
        assert torch.equal(got[key], want[key]), key


def test_replayed_steps_match_eager_steps(cuda, monkeypatch):
    """Three steps replayed (the first runs eagerly and is captured) against
    three eager steps from the same weights and generator seed: losses,
    norms, parameters, counts and the generator's offset.  The wrappers
    count the first call's launches (the eager step's and the capture's)
    and none of a replay's; the replayed graph's kernel nodes hold a step's
    K1, K2 and K3."""
    monkeypatch.setattr(CapturedCall, "keep_graphs", True)
    batches = _lba_batches(3)
    runs = {}
    for mode in ("eager", "replay"):
        model, state, gen = _lba_training(cuda)
        if mode == "eager":
            results = [train_step(model, state, b.to(cuda), graph_regression_loss, gen) for b in batches]
        else:
            steps = TrainSteps(model, state, graph_regression_loss, gen)
            results, counted = [], []
            for i, b in enumerate(batches):
                before = _wrapper_launches()
                pinned = b.pinned()
                results.append(steps([pinned]))
                counted.append(tuple(a - c for a, c in zip(_wrapper_launches(), before)))
            assert (steps.call.captures, steps.call.replays) == (1, 2)
            assert counted == [(2 * K1_POOLED_STEP, 4, 4), (0, 0, 0), (0, 0, 0)]
            assert _replayed_launches(steps.call, [pinned]) == (K1_POOLED_STEP, 2, 2)
        torch.cuda.synchronize()
        runs[mode] = dict(
            losses=[r.loss.item() for r in results], norms=[r.grad_norm.item() for r in results],
            ok=[bool(r.ok.all()) for r in results], state=_train_state(model, state), step=state.step,
            generator=gen.get_state(),
        )
    eager, replay = runs["eager"], runs["replay"]
    assert eager["ok"] == replay["ok"] == [True] * 3 and eager["step"] == replay["step"] == 3
    np.testing.assert_allclose(replay["losses"], eager["losses"], rtol=REPLAY_LOSS_RTOL)
    np.testing.assert_allclose(replay["norms"], eager["norms"], rtol=1e-3)
    _assert_states_close(replay["state"], eager["state"], 3)
    assert torch.equal(replay["generator"], eager["generator"])


def test_chunk_graph_equals_single_replays(cuda):
    """Six steps as two chunks of 3 (the first eager, then captured; the
    second one replay of the 3-step graph) against six single-step calls
    (the first captured, five replays)."""
    batches = [b.pinned() for b in _lba_batches(6)]
    runs = {}
    for chunk in (1, 3):
        model, state, gen = _lba_training(cuda)
        steps = TrainSteps(model, state, graph_regression_loss, gen)
        losses = [steps(batches[i : i + chunk]).loss for i in range(0, 6, chunk)]
        torch.cuda.synchronize()
        assert steps.call.captures == 1 and steps.call.replays == 6 // chunk - 1
        runs[chunk] = dict(losses=torch.cat(losses).tolist(), state=_train_state(model, state), generator=gen.get_state())
    np.testing.assert_allclose(runs[3]["losses"], runs[1]["losses"], rtol=REPLAY_LOSS_RTOL)
    _assert_states_close(runs[3]["state"], runs[1]["state"], 6)
    assert torch.equal(runs[3]["generator"], runs[1]["generator"])


def test_a_new_shape_is_captured_again(cuda):
    """Batches of two shapes: each shape gets its graph on first sight and
    replays it after; the eval step and the forward as well, with the eager
    results."""
    small, large = _lba_batches(1, nodes=32)[0], _lba_batches(1, nodes=40)[0]
    model, state, gen = _lba_training(cuda)
    steps = TrainSteps(model, state, graph_regression_loss, gen)
    for batch in (small, small, large, large, small):
        steps([batch.pinned()])
    assert (steps.call.captures, steps.call.replays) == (2, 3)
    evals, forward = EvalSteps(model, graph_regression_loss), port_predict.Predictor(model)
    for batch in (small, large, small, large):
        losses, preds = evals([batch.pinned()])
        served = forward(batch)
        want = port_predict.predict(model, batch)
        np.testing.assert_allclose(preds[0].cpu().numpy(), want.cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(served.cpu().numpy(), want.cpu().numpy(), atol=1e-5)
    assert (evals.call.captures, evals.call.replays) == (2, 2)
    assert (forward.graphs.captures, forward.graphs.replays) == (2, 2)


def test_served_forward_follows_changed_weights(cuda):
    """The served forward (a graph that reads the packed weights cached
    under inference mode) after the weights change in place, by
    load_state_dict and by an in-place update: it captures again and
    serves the new weights' predictions, as the eager forward does."""
    batch = _lba_batches(1)[0]
    model = port_predict.build_model(0, cuda)
    forward = port_predict.Predictor(model)
    for _ in range(2):
        forward(batch)
    other = port_predict.build_model(1, "cpu").state_dict()
    model.load_state_dict(other)
    served = forward(batch)
    np.testing.assert_allclose(served.cpu().numpy(), port_predict.predict(model, batch).cpu().numpy(), atol=1e-5)
    assert (forward.graphs.captures, forward.graphs.replays) == (2, 1)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    served = forward(batch)
    np.testing.assert_allclose(served.cpu().numpy(), port_predict.predict(model, batch).cpu().numpy(), atol=1e-5)
    assert forward.graphs.captures == 3
    forward(batch)
    assert forward.graphs.replays == 2


def test_nan_batch_replayed_keeps_the_state(cuda):
    """A batch with a NaN label, replayed through the step's graph, leaves
    the parameters, moments, ring and schedule as they were, bit for bit."""
    batch = _lba_batches(1)[0]
    bad = dataclasses.replace(batch, extras={**batch.extras, "label": np.full_like(batch.extras["label"], np.nan)})
    model, state, gen = _lba_training(cuda)
    steps = TrainSteps(model, state, graph_regression_loss, gen)
    steps([batch.pinned()])
    steps([batch.pinned()])
    before = _train_state(model, state)
    result = steps([bad.pinned()])
    torch.cuda.synchronize()
    assert steps.call.replays == 2 and not bool(result.ok.any())
    after = _train_state(model, state)
    for key, value in before.items():
        assert torch.equal(after[key], value), key


def test_replays_do_not_sync(cuda):
    """Under torch.cuda.set_sync_debug_mode("error") a replay of the step,
    of the eval step and of the forward runs; a host read in the same mode
    raises (the mode is on)."""
    batch = _lba_batches(1)[0]
    model, state, gen = _lba_training(cuda)
    steps, evals = TrainSteps(model, state, graph_regression_loss, gen), EvalSteps(model, graph_regression_loss)
    forward = port_predict.Predictor(model)
    steps([batch.pinned()])
    evals([batch.pinned()])
    forward(batch)
    pinned = [batch.pinned(), batch.pinned()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = steps([pinned[0]])
        evals([pinned[1]])
        forward(batch)
        with pytest.raises(RuntimeError):
            result.loss.item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert steps.call.replays == evals.call.replays == forward.graphs.replays == 1


def test_resume_through_replays_continues(cuda, tmp_path):
    """An NMS fit (full width, 2 of 4 interaction layers, dropout 0.1,
    chunks of 2 steps) for 2 epochs, then a third two ways: the same
    Trainer going on through its graphs, and a new Trainer resumed from the
    last checkpoint, which captures anew.  The restored state is the saved
    one bit for bit; after the third epoch the two generators' states are
    equal bit for bit (the replays drew the same dropout masks), and the
    weights and losses agree to the replay tolerance."""
    dm = NMSDataModule(
        data_root=str(tmp_path / "data"), data_mode="small_20body", batch_size=4, num_train=16, num_valid=8,
        num_test=8, sim_device="cpu",
    )
    dm.prepare_data()
    dm.setup()

    def trainer(epochs, ckpt=None):
        model = GCPNetNMS(*train_cli.task_configs("nms", num_encoder_layers=2), generator=torch.Generator().manual_seed(0),
                          device=cuda)
        return Trainer(model, nms_loss, optimizer_cfg={"_target_": "Adam", "lr": REPLAY_LR}, max_epochs=epochs,
                       checkpoint_dir=ckpt, early_stopping_patience=None, scan_chunk_size=2)

    first = trainer(2, str(tmp_path / "ckpt"))
    first.fit(dm)
    resumed = trainer(3)
    resumed.load_checkpoint_state(first.ckpt.restore_last(map_location=cuda))
    assert resumed.state.step == first.state.step and resumed.epoch == first.epoch == 2
    assert torch.equal(resumed.generator.get_state(), first.generator.get_state())
    for (name, p), q in zip(first.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(first.state.optimizer.state_dict()["exp_avg"], resumed.state.optimizer.state_dict()["exp_avg"]):
        assert torch.equal(a, b)
    replays = first.train_graphs.call.replays
    first.max_epochs = 3
    first.fit(dm)
    resumed.fit(dm)
    assert first.train_graphs.call.replays > replays and resumed.train_graphs.call.replays > 0
    assert resumed.state.step == first.state.step == 12
    assert torch.equal(resumed.generator.get_state(), first.generator.get_state())
    _assert_params_close(list(resumed.model.parameters()), list(first.model.parameters()), 4)
    np.testing.assert_allclose(resumed.history["train/loss"], first.history["train/loss"][2:], rtol=REPLAY_LOSS_RTOL)


# --- the sorted indices (K1 in both directions), EQ -----------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_sum_and_gather_backward_run_k1(rng, cuda, dtype):
    """A sum over an unsorted index with its sorted form, and a gather's
    backward over it, on the card: K1 over the rows in segment order (one
    launch each), against index_add_ on the CPU; padding rows (outside every
    segment) are left out; the same bits on a second run; a count from
    prefix sums."""
    rows, segments, width = 5000, 700, 148
    index = rng.integers(0, segments, size=rows)
    valid = rng.random(rows) > 0.1
    perm, inv, splits = sorted_index(index, valid, segments)
    sidx = SortedIndex(*(torch.as_tensor(a).to(cuda) for a in (index, splits, perm, inv)))
    data = torch.as_tensor(rng.normal(size=(rows, width)), dtype=torch.float32) * torch.as_tensor(valid)[:, None]
    # the plain version on the same inputs, rounded to the dtype as the card's
    want = torch.zeros(segments, width).index_add_(0, torch.as_tensor(index), data.to(dtype).float())
    before = segment_sum_sorted.launches
    got = segment_sum(data.to(cuda, dtype), sidx, segments)
    again = segment_sum(data.to(cuda, dtype), sidx, segments)
    assert segment_sum_sorted.launches == before + 2 and torch.equal(got, again)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(), **_k1_tol(dtype))
    count = segment_count(sidx, segments, torch.as_tensor(valid).to(cuda))
    np.testing.assert_array_equal(count.cpu().numpy(), np.bincount(index[valid], minlength=segments))
    nodes = torch.as_tensor(rng.normal(size=(segments, width)), dtype=torch.float32)
    for device, idx in ((cuda, sidx), ("cpu", torch.as_tensor(index))):
        leaf = nodes.to(device, dtype).requires_grad_()
        gathered = gather_rows(leaf, idx)
        (gathered * data.to(device, dtype)).sum().backward()
        if device == cuda:
            card = leaf.grad.float().cpu()
    np.testing.assert_allclose(card.numpy(), leaf.grad.float().numpy(), **_k1_tol(dtype))
    # on the card an index without its sorted form is refused, not summed
    # by index_add_
    plain = torch.as_tensor(index).to(cuda)
    with pytest.raises(ValueError, match="sorted form"):
        leaf = nodes.to(cuda).requires_grad_()
        gather_rows(leaf, plain).sum().backward()
    with pytest.raises(ValueError, match="sorted form"):
        segment_sum(data.to(cuda), plain, segments)
    with pytest.raises(ValueError, match="sorted form"):
        segment_count(plain, segments)


def test_fp32_runs_are_reproducible(cuda):
    """Two eager fp32 RS runs of 16 steps at full width (2 of its 8 layers),
    without torch.use_deterministic_algorithms: the parameters end equal bit
    for bit (before the sorted indices, 97% of the entries parted over an
    epoch: the glue's index_add_ atomics)."""
    assert not torch.are_deterministic_algorithms_enabled()
    dm = RSDataModule(batch_size=64, synthetic_sizes={"train": 1024, "valid": 16, "test": 16})
    dm.setup()
    batches = [b.to(cuda) for b in itertools.islice(dm.train_batches(seed=0), 16)]
    assert len(batches) == 16
    runs = []
    for _ in range(2):
        trainer = train_cli.build_task_trainer("rs", 42, cuda, num_encoder_layers=2, precision=32)
        for b in batches:
            train_step(trainer.model, trainer.state, b, rs_loss, trainer.generator)
        torch.cuda.synchronize()
        runs.append(torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()]))
    assert torch.equal(runs[0], runs[1]), (runs[0] != runs[1]).double().mean().item()


def _eq_datamodule(root, max_nodes: int = 1024, residues=(40, 90)) -> EQDataModule:
    """EQ on synthetic decoys (data.eq_synthetic)."""
    write_eq_decoys(str(root), targets={"train": 1, "valid": 1, "test": 1}, decoys=2, residues=residues)
    dm = EQDataModule.from_data_dir(str(root), batch_size=1, max_nodes_per_batch=max_nodes, max_residues_per_batch=128)
    dm.setup()
    return dm


def _eq_model(dev, layers: int = 2) -> GCPNetEQ:
    return GCPNetEQ(*train_cli.task_configs("eq", layers, dropout=0.0), generator=torch.Generator().manual_seed(0), device=dev)


def test_eq_gradients_on_card_match_cpu(cuda, tmp_path):
    """The EQ model at full width (2 of its 5 GCPInteractions2 layers) on a
    synthetic decoy: the per-residue output, the loss and every parameter's
    gradient on the card against the CPU, through K1 (the sums over
    senders, the node frames, the residue mean and the gathers' backward),
    K2 and the fp32 K3."""
    batch = next(_eq_datamodule(tmp_path).val_batches())
    grads, out = {}, {}
    for dev in ("cuda", "cpu"):
        model = _eq_model(dev)
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        pred = model(b)
        loss, _ = eq_loss(pred, b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (K1_POOLED_STEP, 2, 2)
        out[dev] = (pred.detach().cpu().numpy(), loss.item())
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=1e-4)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


# the card's step tolerance for EQ's output under a rotation: fp32 (split
# TF32 in K2) as the card against the CPU (FORWARD_ATOL in chip_smoke.py);
# bf16 relative to the output's scale, as chip_smoke.py's BF16_STEP_TOL
# holds a bf16 step's loss
EQ_INVARIANCE_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eq_output_is_invariant_on_card(rng, cuda, tmp_path, dtype):
    """EQ's per-residue output through K1-K3 (2 full-width layers) is
    invariant under a random rotation and translation of x, chi and xi."""
    batch = next(_eq_datamodule(tmp_path).val_batches())
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    q = q.astype(np.float32)
    turned = batch.replace(x=batch.x @ q.T + rng.normal(scale=10.0, size=3).astype(np.float32),
                           chi=batch.chi @ q.T, xi=batch.xi @ q.T)
    model = _eq_model(cuda).to(dtype)
    real = torch.as_tensor(batch.extras["res_mask"] > 0)
    with torch.no_grad():
        before = edge_map.launches
        out = model(batch.to(cuda, dtype)).float().cpu()[real]
        again = model(turned.to(cuda, dtype)).float().cpu()[real]
        assert edge_map.launches == before + 4
    scale = out.abs().max().item()
    assert scale > 1e-3
    assert (again - out).abs().max().item() <= EQ_INVARIANCE_TOL[dtype] * max(1.0, scale)


# --- AR ---------------------------------------------------------------------------


def _ar_message_passing() -> GCPMessagePassing:
    """One AR layer's message passing at full width: hidden 100/32, edges
    16/4, 4 ResGCP3 layers with silu on scalars and vectors and the vector
    gate, the attention and the sum over senders: [E, 420] -> [E, 196]."""
    model_cfg, module_cfg, layer_cfg = train_cli.task_configs("ar")
    return GCPMessagePassing(
        (100, 32), (100, 32), (16, 4), module_cfg, layer_cfg, reduce_function="sum",
        use_scalar_message_attention=True, aggregate_with_row=True,
        generator=torch.Generator().manual_seed(0), device="cpu",
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_silu_match_plain_at_ar_widths(rng, cuda, dtype):
    """K2 and K3 with silu (act code 3) at AR's widths on 20,000 rows against
    their plain versions: K2 at the bounds of test_k2_cuda_matches_plain, K3
    under the kink rule, where silu's rows take margin inf (no kink), so
    every row must match.  K3's tile: 64 bf16 or 32 float32 rows, or half
    as many where the 68 input vector channels and 32 output ones do not
    fit them; K2's tile the same way (64 rows, or 32)."""
    with torch.no_grad():
        stack = _ar_message_passing().to(cuda, dtype).packed_stack()
    assert stack.in_dim == 420 and stack.out_dim == 196
    assert {(layer.act_s, layer.act_v) for layer in stack.layers} == {("silu", "silu"), (None, None)}
    rows, nbuf, smem = k2_layout(stack, dtype)
    assert rows in (64, 32) and nbuf in (1, 2) and smem <= 232448
    rows, smem = k3_tile(stack, dtype)
    assert rows in ((64, 32) if dtype == torch.bfloat16 else (32, 16)) and smem <= 232448
    e = 20000
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    assert bool(torch.isinf(kink_margins(msg[:100], frames[:100], stack)).all())
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, want) <= (1e-4 if dtype == torch.float32 else K2_BF16_TOL)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


def _check_act_and_gate(rng, cuda, act, gate, residual, dtype):
    """K2 against its plain version and K3 under the kink rule, with act on
    the scalars and the vectors (the stacks' last layers take the
    identity), in the vector gate (the gate product applies act_v to its A
    operand) or in the norm gate, on 1,000 rows."""
    cfg = ModuleCfg(scalar_nonlinearity=act, vector_nonlinearity=act, vector_gate=gate == "vector")
    with torch.no_grad():
        stack = _message_passing(cfg, residual=residual).to(cuda, dtype).packed_stack()
    assert {layer.act_s for layer in stack.layers} == {act, None}
    e = 1000
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, want) <= (K2_FP32_ATOL if dtype == torch.float32 else K2_BF16_TOL)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("gate", ["vector", "norm"])
@pytest.mark.parametrize("act", EVERY_ACTIVATION)
def test_k2_k3_bf16_every_act_and_gate(rng, cuda, act, gate, residual):
    """bf16 K2 and K3 with every activation name, under both gates, with
    and without ResGCP's residual (_check_act_and_gate: K3 leaf by leaf,
    K3_BF16_LEAF_TOL)."""
    _check_act_and_gate(rng, cuda, act, gate, residual, torch.bfloat16)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("gate", ["vector", "norm"])
@pytest.mark.parametrize("act", EVERY_ACTIVATION)
def test_k2_k3_fp32_every_act_and_gate(rng, cuda, act, gate, residual):
    """float32 K2 (max abs 1e-4 of max(1, max |plain|)) and K3 under the
    kink rule (relu, leaky relu and selu's kinks; every other row and leaf
    at 1e-4) with every activation name, under both gates, with and
    without ResGCP's residual."""
    _check_act_and_gate(rng, cuda, act, gate, residual, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_silu_norm_gate_match_plain(rng, cuda, dtype):
    """silu in the norm gate (no vector gate) and on the scalars, at the
    small widths of test_k2_cuda_matches_plain, on 1,000 rows."""
    with torch.no_grad():
        stack = _message_passing(SILU_SETTINGS["silu_norm"]).to(cuda, dtype).packed_stack()
    assert all(layer.w_gate is None for layer in stack.layers)
    e = 1000
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert _max_rel_err(got, want) <= (1e-4 if dtype == torch.float32 else K2_BF16_TOL)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("settings", ["production", "gelu_sigmoid_gate"])
def test_k2_k3_match_plain_at_20_layers(rng, cuda, settings, dtype):
    """A 20-layer ResGCP2 stack at the small widths (the layer table takes
    up to 32; it took 16 before): K2 against its plain version, K3 under
    the kink rule, on 1,000 rows; K3's scratch holds 19 layers' input
    state a tile.  bf16 K2 parts from its plain version by a few bf16
    roundings a layer, which add up like a random walk: K2_BF16_TOL, set
    at 8 layers, times sqrt(20 / 8) (on the H100 the gelu stack read
    0.0214, the relu one less)."""
    cfg = {**ACTIVATION_SETTINGS, **TRANSCENDENTAL_SETTINGS}[settings]
    with torch.no_grad():
        stack = _message_passing(cfg, num_message_layers=20).to(cuda, dtype).packed_stack()
    assert len(stack.layers) == 20
    e = 1000
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, want) <= (K2_FP32_ATOL if dtype == torch.float32 else K2_BF16_TOL * math.sqrt(20 / 8))
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


def _ar_batch(root, max_nodes: int = 1536):
    """A validation batch of AR on synthetic pairs (data.ar_synthetic) of
    40-90 residues, the JAX k_max of 128."""
    write_ar_pairs(str(root), pairs={"train": 1, "valid": 1, "test": 1}, train_residues=(40, 90),
                   eval_residues=(40, 90))
    dm = ARDataModule.from_data_dir(str(root), max_nodes_per_batch=max_nodes, max_residues_per_batch=128)
    dm.setup()
    return next(dm.val_batches())


def _ar_model(dev, layers: int = 2) -> GCPNetAR:
    return GCPNetAR(*train_cli.task_configs("ar", layers), generator=torch.Generator().manual_seed(0), device=dev)


def test_ar_gradients_on_card_match_cpu(cuda, tmp_path):
    """The AR model at full width (2 of its 4 layers) on a synthetic pair:
    the positions, the loss and every parameter's gradient on the card
    against the CPU, through K1 (the sums over senders, the node frames,
    the centring and the gathers' backward), K2 and the fp32 K3, both with
    silu."""
    batch = _ar_batch(tmp_path)
    grads, out = {}, {}
    for dev in ("cuda", "cpu"):
        model = _ar_model(dev)
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        pred = model(b)
        loss, _ = ar_loss(pred, b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (K1_AR_STEP, 2, 2)
        out[dev] = (pred.detach().cpu().numpy(), loss.item())
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    real = np.asarray(batch.node_pad_mask)
    np.testing.assert_allclose(out["cuda"][0][real], out["cpu"][0][real], atol=1e-3, rtol=1e-4)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * max(1.0, out["cpu"][1])
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


# AR's positions under a rotation, relative to their scale: fp32 (split
# TF32 in K2) as EQ_INVARIANCE_TOL; bf16 holds positions of ~50 A to 8
# bits, and its output adds a few such roundings (x, ca_x, the move): 8 ulps
AR_EQUIVARIANCE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ar_positions_are_equivariant_on_card(rng, cuda, tmp_path, dtype):
    """AR's predicted positions through K1-K3 (2 full-width layers) rotate
    and move with a random rotation and translation of x, chi, xi and the
    Ca table."""
    batch = _ar_batch(tmp_path)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = (q * np.sign(np.diag(r))).astype(np.float32)
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    shift = rng.normal(scale=10.0, size=3).astype(np.float32)
    real = np.asarray(batch.node_pad_mask)
    n_res = int(batch.extras["atom_residue_idx"][real].max()) + 1
    ca = batch.extras["ca_x"].copy()
    ca[:n_res] = ca[:n_res] @ q.T + shift
    turned = batch.replace(x=np.where(real[:, None], batch.x @ q.T + shift, 0.0).astype(np.float32),
                           chi=batch.chi @ q.T, xi=batch.xi @ q.T, extras={**batch.extras, "ca_x": ca})
    model = _ar_model(cuda).to(dtype)
    with torch.no_grad():
        before = edge_map.launches
        out = model(batch.to(cuda, dtype)).float().cpu().numpy()[real]
        again = model(turned.to(cuda, dtype)).float().cpu().numpy()[real]
        assert edge_map.launches == before + 4
    scale = np.abs(out).max()
    assert np.abs(again - (out @ q.T + shift)).max() <= AR_EQUIVARIANCE_TOL[dtype] * max(1.0, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_positions_are_equivariant_on_card(rng, cuda, dtype):
    """NMS's predicted positions through K1-K3 (2 layers of 2-layer stacks,
    two complete graphs of 5 bodies) rotate and move with the inputs, as
    ``tests/test_model_equivariance.py``'s NMS case holds the JAX model."""
    n = 5
    s, r = np.nonzero(~np.eye(n, dtype=bool))
    graphs = [
        GraphData(
            h=rng.normal(size=(n, 1)).astype(np.float32), chi=rng.normal(size=(n, 3, 3)).astype(np.float32),
            e=rng.normal(size=(n * (n - 1), 17)).astype(np.float32),
            xi=rng.normal(size=(n * (n - 1), 1, 3)).astype(np.float32), x=rng.normal(size=(n, 3)).astype(np.float32),
            senders=s.astype(np.int32), receivers=r.astype(np.int32),
            extras={"label": rng.normal(size=(n, 3)).astype(np.float32)},
        )
        for _ in range(2)
    ]
    batch = next(batches_from_dataset(graphs, Bucket(n * 2, n * (n - 1) * 2 + 1, 2)))
    model = GCPNetNMS(
        ModelCfg(h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
                 e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0),
        ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)), generator=torch.Generator().manual_seed(0),
        device=cuda,
    ).to(dtype)
    q, rr = np.linalg.qr(rng.normal(size=(3, 3)))
    q = (q * np.sign(np.diag(rr))).astype(np.float32)
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    shift = rng.normal(scale=10.0, size=3).astype(np.float32)
    turned = batch.replace(x=batch.x @ q.T + shift, chi=batch.chi @ q.T, xi=batch.xi @ q.T)
    with torch.no_grad():
        before = edge_map.launches
        out = model(batch.to(cuda, dtype)).float().cpu().numpy()
        got = model(turned.to(cuda, dtype)).float().cpu().numpy()
        assert edge_map.launches == before + 4
    scale = np.abs(out).max()
    assert np.abs(got - (out @ q.T + shift)).max() <= AR_EQUIVARIANCE_TOL[dtype] * max(1.0, scale)


# --- LBA on records and the config-driven entry points ---------------------------


def _lba_records_batch(root, complexes: int = 2, max_nodes: int = 1024):
    """A validation batch of ``complexes`` synthetic LBA complexes
    (chip_smoke.write_lba_records: pockets of 120-200 heavy atoms)."""
    from chip_smoke import write_lba_records

    write_lba_records(str(root), complexes={"train": 1, "val": complexes, "test": 1}, pocket_atoms=(120, 200))
    dm = ATOM3DDataModule(task="LBA", data_dir=str(root), batch_size=complexes, max_nodes_per_batch=max_nodes)
    dm.setup()
    return next(dm.val_batches())


LBA_INVARIANCE_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lba_affinity_is_invariant_on_card(rng, cuda, tmp_path, dtype):
    """LBA's affinity through K1 and K2 (2 full-width interaction layers; the
    fp32 K2 is split TF32) is invariant under a random rotation and
    translation of x, chi and xi, within LBA_INVARIANCE_TOL of its scale;
    the ligand flag rides along."""
    batch = _lba_records_batch(tmp_path)
    assert batch.extras["lig_flag"].any()
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    q = q.astype(np.float32)
    turned = batch.replace(x=batch.x @ q.T + rng.normal(scale=10.0, size=3).astype(np.float32),
                           chi=batch.chi @ q.T, xi=batch.xi @ q.T)
    model_cfg, module_cfg, layer_cfg = port_predict.lba_configs()
    model = GCPNetLBA(model_cfg.replace(num_encoder_layers=2), module_cfg, layer_cfg, num_atom_types=9,
                      generator=torch.Generator().manual_seed(0), device=cuda).to(dtype).eval()
    real = torch.as_tensor(batch.graph_pad_mask)
    with torch.no_grad():
        before = edge_map.launches
        out = model(batch.to(cuda, dtype)).float().cpu()[real]
        again = model(turned.to(cuda, dtype)).float().cpu()[real]
        assert edge_map.launches == before + 4
    scale = out.abs().max().item()
    assert scale > 1e-3
    assert (again - out).abs().max().item() <= LBA_INVARIANCE_TOL[dtype] * max(1.0, scale)


def test_config_train_and_eval_round_trip_on_card(cuda, tmp_path):
    """``python -m gcpnet_torch.train experiment=gcpnet_lba`` on a few
    synthetic LBA complexes at full width (1 interaction layer, bf16, the
    default trainer.accelerator: the card) runs K1, K2 and the bf16 K3;
    ``python -m gcpnet_torch.eval`` on its checkpoints gives its test/loss
    bit for bit."""
    from chip_smoke import write_lba_records
    from gcpnet_torch import eval as eval_entry
    from gcpnet_torch.train import entry

    write_lba_records(str(tmp_path / "ATOM3D"), complexes={"train": 6, "val": 3, "test": 3}, pocket_atoms=(120, 200))
    overrides = [
        "experiment=gcpnet_lba", f"paths.data_dir={tmp_path}/", f"paths.output_dir={tmp_path}/run",
        "model.model_cfg.num_encoder_layers=1", "datamodule.batch_size=3", "+datamodule.max_nodes_per_batch=1024",
        "trainer.max_epochs=1", "extras.print_config=false",
    ]
    before = _wrapper_launches(), edge_map_backward.dtype_launches[torch.bfloat16]
    metrics = entry.main(overrides)
    torch.cuda.synchronize()
    after = _wrapper_launches(), edge_map_backward.dtype_launches[torch.bfloat16]
    assert all(a > b for a, b in zip(after[0], before[0])) and after[1] > before[1]
    assert np.isfinite(metrics["test/loss"])
    again = eval_entry.main([*overrides, f"ckpt_path={tmp_path}/run/checkpoints"])
    assert again["test/loss"] == metrics["test/loss"]


# --- the rest of the GCP family: plain message stacks on the card ------------

# The settings of chip_smoke's gcp-family runs: each puts every message
# stack outside K2/K3's layer table, so the stacks run module by module and
# only K1 launches
FAMILY_SETTINGS = {
    "ablate_frame_updates": dict(ablate_frame_updates=True),
    "ablate_scalars": dict(ablate_scalars=True),
    "ablate_vectors": dict(ablate_vectors=True),
    "gcp1_sigma_frame_gate": dict(selected_gcp="GCP", sigma_frame_gate=True, vector_gate=False),
    "gcp2_frame_gate": dict(frame_gate=True, vector_gate=False),
}
# scatter kernels by name (a replay's graph must hold none)
SCATTER_NAMES = ("indexFuncSmallIndex", "indexFuncLargeIndex", "index_add", "indexing_backward", "scatter_add",
                 "_scatter_gather_elementwise", "embedding_backward", "compute_grad_weight")


def _family_lba(setting: str, dev) -> GCPNetLBA:
    model_cfg, module_cfg, layer_cfg = port_predict.lba_configs()
    return GCPNetLBA(
        model_cfg.replace(num_encoder_layers=2, dropout=0.0, dense_dropout=0.0),
        module_cfg.replace(**FAMILY_SETTINGS[setting]), layer_cfg,
        generator=torch.Generator().manual_seed(0), device=dev,
    )


def _e3_rs(dev) -> GCPNetRS:
    model_cfg, module_cfg, layer_cfg = train_cli.task_configs("rs", num_encoder_layers=2, dropout=0.0)
    return GCPNetRS(model_cfg, module_cfg.replace(enable_e3_equivariance=True), layer_cfg,
                    generator=torch.Generator().manual_seed(0), device=dev)


def _rs_batch():
    dm = RSDataModule(batch_size=8, synthetic_sizes={"train": 32, "valid": 16, "test": 16})
    dm.setup()
    return next(dm.train_batches(seed=0))


def _plain_case(case: str):
    """(a function making the model, host batch, loss) of a card test's model: LBA with a
    gcp-family setting at full width (2 layers) on a synthetic batch, or
    E(3) RS at full width (2 layers) on a paired batch."""
    if case == "rs_e3":
        return _e3_rs, _rs_batch(), rs_loss
    return (lambda dev: _family_lba(case, dev)), port_predict.synthetic_batches(1, 2, 40, 28, seed=1)[0], \
        graph_regression_loss


@pytest.mark.parametrize("case", sorted(FAMILY_SETTINGS) + ["rs_e3"])
def test_plain_stack_gradients_on_card_match_cpu(cuda, case):
    """A model whose message stacks are outside K2/K3's layer table keeps
    the autograd graph on the card module by module: the loss and every
    parameter's gradient against the CPU, K1 launched and K2 / K3 not."""
    build, batch, loss_fn = _plain_case(case)
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = build(dev)
        assert not any(m.fast_supported for m in model.modules() if isinstance(m, GCPMessagePassing))
        launches = _wrapper_launches()
        b = batch.to(torch.device(dev))
        loss, _ = loss_fn(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            k1, k2, k3 = (a - c for a, c in zip(_wrapper_launches(), launches))
            assert k1 > 0 and k2 == k3 == 0, (k1, k2, k3)
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        if want is None:  # an ablated branch
            assert got is None or torch.count_nonzero(got) == 0, name
            continue
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("case", ["ablate_frame_updates", "rs_e3"])
def test_plain_stack_replay_runs_no_k2_k3_or_scatter(cuda, monkeypatch, case):
    """A captured training step of a plain-stack model: a replay's graph
    holds K1 kernels and no K2, K3 or scatter kernel, and two replays
    agree with two eager steps."""
    monkeypatch.setattr(CapturedCall, "keep_graphs", True)
    build, batch, loss_fn = _plain_case(case)
    pinned = batch.pinned()
    losses = {}
    for mode in ("eager", "replay"):
        model = build(cuda)
        state = TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}))
        if mode == "eager":
            losses[mode] = [train_step(model, state, batch.to(cuda), loss_fn).loss.item() for _ in range(3)]
            continue
        steps = TrainSteps(model, state, loss_fn, torch.Generator(device=cuda).manual_seed(0))
        losses[mode] = [steps([pinned]).loss.item() for _ in range(3)]
        assert (steps.call.captures, steps.call.replays) == (1, 2)
        k1, k2, k3 = _replayed_launches(steps.call, [pinned])
        assert k1 > 0 and k2 == k3 == 0, (k1, k2, k3)
        names = steps.call.kernel_names([pinned])
        assert not [n for n in names if any(s in n for s in SCATTER_NAMES)], names
    np.testing.assert_allclose(losses["replay"], losses["eager"], rtol=1e-4)


@pytest.mark.parametrize("flip", ["frame_gate", "sigma_frame_gate", "enable_e3_equivariance",
                                  "ablate_frame_updates", "ablate_scalars", "ablate_vectors", "GCP v1"])
def test_edge_map_refuses_each_setting_outside_its_layer_table(rng, cuda, flip):
    """A packed stack that carries a setting outside the kernels' layer
    table raises on the card, naming the setting, before any launch."""
    cfg = ModuleCfg(selected_gcp="GCP") if flip == "GCP v1" else ModuleCfg(**{flip: True})
    mp = GCPMessagePassing((16, 4), (16, 4), (8, 4), cfg, LayerCfg(mp_cfg=MPCfg(num_message_layers=3)),
                           generator=torch.Generator().manual_seed(0), device=cuda)
    stack = mp.packed_stack()
    e = 64
    message = torch.from_numpy(rng.normal(size=(e, stack.in_dim)).astype(np.float32)).to(cuda)
    frames = torch.from_numpy(rng.normal(size=(e, 9)).astype(np.float32)).to(cuda)
    before = edge_map.launches
    with pytest.raises(NotImplementedError, match=flip):
        edge_map(message, frames, stack)
    assert edge_map.launches == before


# --- budget batches, layer_class overrides, gloo launches ------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_k3_match_plain_at_a_budget_batch(rng, cuda, tmp_path, dtype):
    """A PSR batch packed under an edge budget (``max_units`` 262,144 rows:
    ``make_bucket``'s 12,296 nodes), its real rows within the budget and
    with CSR splits: K1, K2 and K3 on it against their plain versions at
    test_k1_k2_k3_match_plain_at_a_psr_batch's bounds."""
    from chip_smoke import write_psr_records

    write_psr_records(str(tmp_path), targets={"train": 2, "val": 1, "test": 1}, decoys=8)
    dm = ATOM3DDataModule(task="PSR", data_dir=str(tmp_path), batch_size=16, max_units=262144)
    dm.setup()
    batch = next(dm.train_batches(seed=0))
    assert (batch.num_nodes, batch.num_edges) == (12296, 262144) and batch.edge_row_splits is not None
    assert 0 < int(batch.edge_pad_mask.sum()) <= 262144
    splits = torch.as_tensor(batch.edge_row_splits).to(cuda)
    data = torch.from_numpy(rng.normal(size=(batch.num_edges, 148)).astype(np.float32)).to(cuda, dtype)
    _k1_check(data, splits, batch.num_nodes)
    with torch.no_grad():
        stack = _lba_width_message_passing(ModuleCfg()).to(cuda, dtype).packed_stack()
    msg, frames = _stack_inputs(rng, stack, batch.num_edges, dtype, cuda)
    frames = frames * torch.as_tensor(batch.edge_pad_mask).to(cuda)[:, None]
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        want = edge_map_plain(msg, frames, stack)
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, want) <= (1e-4 if dtype == torch.float32 else K2_BF16_TOL)
    grad_out = torch.from_numpy(rng.normal(size=(batch.num_edges, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    _k3_check_with_kink_rule(msg, frames, stack, grad_out)


def test_lba_on_interactions2_step_on_card_matches_cpu(cuda):
    """``model.layer_class`` GCPInteractions2 on LBA (2 layers at full
    width): the loss and every parameter's gradient on the card against
    the CPU, through K1, K2 and the fp32 K3 once a layer."""
    batch = port_predict.synthetic_batches(1, 2, 40, 28, seed=1)[0]
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        trainer = train_cli.build_task_trainer("lba", 0, dev, num_encoder_layers=2, dropout=0.0, precision=32,
                                               layer_class="GCPInteractions2")
        model = trainer.model
        assert type(model.encoder.interaction_0).__name__ == "GCPInteractions2"
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        loss, _ = graph_regression_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            k1, k2, k3 = (a - b for a, b in zip(now, launches))
            assert k1 > 0 and (k2, k3) == (2, 2), (k1, k2, k3)
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


GLOO_LAUNCHES = 20


def test_gloo_launches_do_not_hang(cuda):
    """chip_smoke's gloo world of two on the card (``parallel.launch`` of
    its ``_gloo_worker``: each rank tests its shard of the full-width LBA
    batch, then takes DDP_GLOO_STEPS eager bf16 steps), GLOO_LAUNCHES times
    in a row in one process that holds a CUDA context and, before every
    other launch, makes and tears down a NCCL group of one, as the ddp
    phase does just before its gloo launch: every launch ends within the
    phase's DDP_TIMEOUT (a process still running at 0.9 of it prints its
    stacks) with the same evaluation and losses."""
    import os
    import signal
    import tempfile
    import time

    from chip_smoke import DDP_GLOO_STEPS, DDP_SHARDS, DDP_TIMEOUT, _gloo_worker
    from gcpnet_torch import parallel

    torch.ones(1, device=cuda)
    seconds, results, sigchld = [], [], {str(signal.getsignal(signal.SIGCHLD))}
    for i in range(GLOO_LAUNCHES):
        if i % 2:
            env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                   parallel.group.INIT_METHOD_ENV: "file://" + os.path.join(tempfile.mkdtemp(), "store")}
            os.environ.update(env)
            try:
                group = parallel.init_from_env("cuda")
                parallel.mean_(torch.ones(8, device=cuda), group)
                torch.cuda.synchronize()
            finally:
                torch.distributed.destroy_process_group()
                for key in env:
                    os.environ.pop(key)
            sigchld.add(str(signal.getsignal(signal.SIGCHLD)))  # what reaps this process's ended children
        t0 = time.perf_counter()
        out = parallel.launch(_gloo_worker, DDP_SHARDS, DDP_GLOO_STEPS, timeout=DDP_TIMEOUT)
        seconds.append(time.perf_counter() - t0)
        results.append((out["evaluation"]["test/loss"], *out["losses"]))
    print(f"gloo launches: {GLOO_LAUNCHES}, seconds each {[round(s, 1) for s in seconds]}, SIGCHLD {sigchld}")
    for r in results:
        assert np.isfinite(r).all()
        np.testing.assert_allclose(r, results[0], rtol=1e-3)  # bf16 steps: the same within their rounding


# --- remat and the dense layout -----------------------------------------------


@pytest.mark.parametrize("remat", [True, "dots"])
def test_captured_remat_steps_equal_eager_ones_and_steps_without_remat(cuda, monkeypatch, remat):
    """Three fp32 steps of the 2-layer full-width LBA with dropout 0.1 and
    ``remat``: replayed (the first runs eagerly and is captured) against
    eager, and eager against eager without remat (the recompute replays
    the forward's dropout masks: equal at 1e-6).  A replay's graph holds
    each layer's recompute: 2 K1 and 1 K2 a layer more."""
    monkeypatch.setattr(CapturedCall, "keep_graphs", True)
    batches = _lba_batches(3)
    runs = {}
    for mode, rm in (("plain", False), ("eager", remat), ("replay", remat)):
        model, state = train_cli.build_lba_training(
            0, cuda, torch.float32, lr=REPLAY_LR, dropout=0.1, adaptive_clip=True, num_encoder_layers=2, remat=rm)
        state.scheduler = build_schedule(state.optimizer, {"_target_": "StepLR", "step_size": 2, "gamma": 0.5})
        gen = torch.Generator(device=cuda).manual_seed(5)
        if mode == "replay":
            steps = TrainSteps(model, state, graph_regression_loss, gen)
            results = [steps([b.pinned()]) for b in batches]
            assert _replayed_launches(steps.call, [batches[-1].pinned()]) == (K1_POOLED_STEP + 2 * 2, 2 * 2, 2)
        else:
            results = [train_step(model, state, b.to(cuda), graph_regression_loss, gen) for b in batches]
        torch.cuda.synchronize()
        runs[mode] = dict(losses=[r.loss.item() for r in results], state=_train_state(model, state),
                          generator=gen.get_state())
    plain, eager, replay = runs["plain"], runs["eager"], runs["replay"]
    np.testing.assert_allclose(eager["losses"], plain["losses"], atol=1e-6)
    for key, value in plain["state"].items():
        np.testing.assert_allclose(eager["state"][key].cpu().numpy(), value.cpu().numpy(), atol=1e-6, err_msg=key)
    np.testing.assert_allclose(replay["losses"], eager["losses"], rtol=REPLAY_LOSS_RTOL)
    _assert_states_close(replay["state"], eager["state"], 3)
    assert torch.equal(replay["generator"], eager["generator"]) and torch.equal(eager["generator"],
                                                                               plain["generator"])


def test_dense_slot_sum_and_broadcast_use_no_scatter_or_k1(cuda):
    """In the dense layout a receiver-side sum, mean and count are slot
    sums and a receiver gather a broadcast, forward and backward: no
    scatter op, no K1 launch, and the values of the plain sums."""
    from gcpnet_torch.ops.segment import DenseIndex, segment_mean

    gen = torch.Generator().manual_seed(0)
    n, k, c = 500, 32, 20
    data = torch.randn(n * k, c, generator=gen)
    mask = torch.rand(n * k, generator=gen) < 0.8
    nodes = torch.randn(n, c, generator=gen)
    ids = torch.arange(n).repeat(k)
    for dtype in (torch.float32, torch.bfloat16):
        x = data.to(cuda, dtype).requires_grad_()
        v = nodes.to(cuda, dtype).requires_grad_()
        index = DenseIndex(ids.to(cuda), k)
        before = segment_sum_sorted.launches
        with _OpsOn(x) as on_x, _OpsOn(v) as on_v:
            total = segment_sum(x, index, n, mask=mask.to(cuda))
            mean = segment_mean(x, index, n, mask=mask.to(cuda))
            rows = gather_rows(v, index)
            (total.float().sum() + mean.float().sum() + rows.float().pow(2).sum()).backward()
        count = segment_count(index, n, mask=mask.to(cuda))
        assert segment_sum_sorted.launches == before
        ops = on_x.ops + on_v.ops
        assert not [op for op in ops if "index_add" in op or "scatter" in op or "index_put" in op], ops
        want = torch.zeros(n, c).index_add_(0, ids[mask], data[mask].to(dtype).float())
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(total.detach().float().cpu().numpy(), want.to(dtype).float().numpy(), atol=tol, rtol=tol)
        np.testing.assert_array_equal(count.cpu().numpy(), torch.bincount(ids[mask], minlength=n).float().numpy())
        np.testing.assert_allclose(v.grad.float().cpu().numpy(), (2 * k * nodes.to(dtype).float()).numpy(),
                                   atol=tol * k, rtol=tol)
        assert torch.equal(rows.reshape(k, n, c)[3], v.detach())
