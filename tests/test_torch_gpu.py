"""The port's CUDA kernels, its prediction and its gradients on the card
(marked ``gpu``).

This file imports no JAX, so it also runs on a machine that has none; there
it runs without the repository's ``conftest.py``, which sets JAX up:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Without a CUDA device every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gcpnet_torch import predict as port_predict
from gcpnet_torch.config.schema import LayerCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch.data.rs import RSDataModule
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops.build import library
from gcpnet_torch.ops.edge_map import (
    KINK_MARGIN,
    edge_map,
    edge_map_backward,
    edge_map_backward_plain,
    edge_map_plain,
    max_kink_rows,
    pack_stack,
    kink_margins,
)
from gcpnet_torch.ops.segment_sorted import DTYPE_CODES, segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.graphs import EvalSteps, TrainSteps
from gcpnet_torch.train.optim import build_schedule
from gcpnet_torch.train.step import train_step
from gcpnet_torch.train.trainer import Trainer

pytestmark = pytest.mark.gpu


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
    """A first layer of 1,200 input scalars: its row of the tile alone
    exceeds the block's shared memory."""
    with torch.no_grad():
        stack = _message_passing(ModuleCfg(), node_dims=(600, 4)).to(cuda, dtype).packed_stack()
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
@pytest.mark.parametrize("settings", ["production", "leaky_gate"])
def test_k2_bf16_is_the_state_k3_recomputes(rng, cuda, settings, residual, dtype):
    """K2 and K3's forward sweep run the same layer body, in bf16 and in
    float32 (split TF32): the state K3 keeps in its scratch before each
    layer l >= 1 equals, bit for bit, K2's output for the stack's first l
    layers.  K3 is launched with one block per tile, so that each block's
    scratch holds its own tile."""
    with torch.no_grad():
        stack = _message_passing(ACTIVATION_SETTINGS[settings], residual=residual).to(cuda, dtype).packed_stack()
    lib = library("edge_map_bwd_tc")
    code = DTYPE_CODES[dtype]
    tiles, tile = 5, lib.gcp_edge_map_bwd_tc_tile(code)
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
    plain version take different sides of a kink (relu, or leaky relu,
    whose derivative steps by 1 - slope) and the row's d message differs
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
@pytest.mark.parametrize("settings", ["production", "leaky_gate"])
def test_k2_k3_keep_nans(rng, cuda, settings, where, dtype):
    """A NaN of the card's own form (every mantissa bit set) in one message
    row or in one weight: K2's output is a NaN exactly where the plain
    version's is, and K3's results wherever the plain backward's are (K3
    takes relu's derivative at a NaN as 0, as JAX does, where torch passes
    the cotangent on, so its NaNs may spread further; leaky relu's is the
    slope in both)."""
    with torch.no_grad():
        stack = _message_passing(ACTIVATION_SETTINGS[settings]).to(cuda, dtype).packed_stack()
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
    """A first layer of 2,408 input scalars: its rows of the tile alone
    exceed the block's shared memory, for float32's 32-row tile as for
    bf16's 64 (1,208 fit float32's)."""
    with torch.no_grad():
        stack = _message_passing(ModuleCfg(), node_dims=(1200, 4)).to(cuda, dtype).packed_stack()
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
            *train_cli.nms_configs(num_encoder_layers=2, dropout=0.0),
            generator=torch.Generator().manual_seed(0), device=dev,
        )
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        loss, _ = nms_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (2, 2, 2)
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
            *train_cli.rs_configs(num_encoder_layers=2, dropout=0.0),
            generator=torch.Generator().manual_seed(0), device=dev,
        )
        launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
        b = batch.to(torch.device(dev))
        loss, _ = rs_loss(model(b), b)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            now = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
            assert tuple(a - b for a, b in zip(now, launches)) == (2, 2, 2)
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


def test_k2_cuda_rejects_unsupported_activation(cuda):
    stack = _message_passing(ModuleCfg(scalar_nonlinearity="silu")).to(cuda).packed_stack()
    msg = torch.zeros((8, stack.in_dim), device=cuda)
    with pytest.raises(NotImplementedError, match="silu"):
        edge_map(msg, torch.zeros((8, 9), device=cuda), stack)


def test_predict_on_card_matches_cpu(cuda):
    batch = port_predict.synthetic_batches(1, 2, 40, 28, seed=1)[0]
    k1, k2 = segment_sum_sorted.launches, edge_map.launches
    on_card = port_predict.predict(port_predict.build_model(0, cuda), batch)
    torch.cuda.synchronize()
    assert (segment_sum_sorted.launches - k1, edge_map.launches - k2) == (8, 8)
    on_cpu = port_predict.predict(port_predict.build_model(0, "cpu"), batch)
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(), atol=1e-4)


# Captured steps (gcpnet_torch.train.graphs) against the eager ones.  The
# glue's index_add_ adds with atomics in another order on every run, so a
# replay and an eager step agree to a tolerance, not bit for bit: float32
# gradients ~1e-7 apart relative.  Adam moves an entry by up to about lr a
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


def _traced_launches(fn) -> tuple:
    """K1, K2 and K3 kernels that ran on the card during ``fn()``, read from
    a torch.profiler trace (a replay runs no Python, so the wrappers do not
    count its launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return tuple(sum(key in n for n in names) for key in ("seg_sum", "edge_map_tc_kernel", "edge_map_bwd_tc_kernel"))


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


def test_replayed_steps_match_eager_steps(cuda):
    """Three steps replayed (the first runs eagerly and is captured) against
    three eager steps from the same weights and generator seed: losses,
    norms, parameters, counts and the generator's offset.  The wrappers
    count the first call's launches (the eager step's and the capture's)
    and none of a replay's; a replay's trace holds K1, K2 and K3."""
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
                if i == 2:
                    traced = _traced_launches(lambda: results.append(steps([pinned])))
                else:
                    results.append(steps([pinned]))
                counted.append(tuple(a - c for a, c in zip(_wrapper_launches(), before)))
            assert (steps.call.captures, steps.call.replays) == (1, 2)
            assert counted == [(4, 4, 4), (0, 0, 0), (0, 0, 0)] and traced == (2, 2, 2)
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
        model = GCPNetNMS(*train_cli.nms_configs(num_encoder_layers=2), generator=torch.Generator().manual_seed(0),
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
