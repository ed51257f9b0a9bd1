"""The port's CUDA kernels, its prediction and its gradients on the card
(marked ``gpu``).

This file imports no JAX, so it also runs on a machine that has none; there
it runs without the repository's ``conftest.py``, which sets JAX up:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from gcpnet_torch import predict as port_predict
from gcpnet_torch.config.schema import LayerCfg, ModuleCfg, MPCfg
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops.build import library
from gcpnet_torch.ops.edge_map import (
    PackedStack,
    edge_map,
    edge_map_backward,
    edge_map_backward_plain,
    edge_map_plain,
    pack_stack,
)
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted, segment_sum_sorted_plain

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


def _message_passing(
    cfg: ModuleCfg, num_message_layers: int = 4, residual: bool = True, node_dims=(16, 4)
) -> GCPMessagePassing:
    mp_cfg = MPCfg(num_message_layers=num_message_layers, use_residual_message_gcp=residual)
    return GCPMessagePassing(
        node_dims, (16, 4), (8, 4), cfg, LayerCfg(mp_cfg=mp_cfg),
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
@pytest.mark.parametrize("settings", sorted(STACK_SETTINGS))
def test_k2_cuda_matches_plain(rng, cuda, settings, dtype):
    stack = _message_passing(STACK_SETTINGS[settings]).to(cuda, dtype).packed_stack()
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


@pytest.mark.parametrize("residual", [True, False])
def test_k2_bf16_is_the_state_k3_recomputes(rng, cuda, residual):
    """bf16 K2 and the bf16 K3's forward sweep run the same layer body: the
    state K3 keeps in its scratch before each layer l >= 1 equals, bit for
    bit, K2's output for the stack's first l layers.  K3 is launched with
    one block per tile, so that each block's scratch holds its own tile."""
    dtype = torch.bfloat16
    with torch.no_grad():
        stack = _message_passing(ModuleCfg(), residual=residual).to(cuda, dtype).packed_stack()
    tiles, tile = 5, 64  # csrc/edge_stack_mma.cuh kTile
    e = tiles * tile
    msg, frames = _stack_inputs(rng, stack, e, dtype, cuda)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    lib = library("edge_map_bwd_tc")
    w_len = stack.weights.numel()
    widths = [s_in + 3 * v_in for s_in, v_in, *_ in (layer.dims for layer in stack.layers[1:])]
    stash_len = tile * sum(widths)
    images = torch.empty(
        lib.gcp_edge_map_bwd_tc_image_bytes(stack.meta.ctypes.data, stack.meta.size), dtype=torch.uint8, device=cuda
    )
    partials = torch.empty(tiles * w_len, device=cuda)
    scratch = torch.empty(tiles * stash_len, dtype=dtype, device=cuda)
    d_msg, d_w = torch.empty_like(msg), torch.empty_like(stack.weights)
    err = lib.gcp_edge_map_bwd_tc(
        msg.data_ptr(), frames.data_ptr(), grad_out.data_ptr(), stack.weights.data_ptr(), stack.meta.ctypes.data,
        stack.meta.size, d_msg.data_ptr(), d_w.data_ptr(), images.data_ptr(), partials.data_ptr(),
        scratch.data_ptr(), w_len, stash_len, e, tiles, torch.cuda.current_stream().cuda_stream,
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
# float32: float32 throughout, the summation order differs.
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
    e = 1000  # not a multiple of the kernels' tiles (48 rows in float32, 64 in bf16)
    msg = rng.normal(size=(e, stack.in_dim)).astype(np.float32)
    msg[: e // 4, stack.layers[0].dims[0] :] = 0.0  # zero vectors: the norm's eps decides
    msg = torch.from_numpy(msg).to(cuda, dtype)
    frames = torch.from_numpy(rng.normal(size=(e, 9)).astype(np.float32)).to(cuda, dtype)
    grad_out = torch.from_numpy(rng.normal(size=(e, stack.out_dim)).astype(np.float32)).to(cuda, dtype)
    before = edge_map_backward.launches, edge_map_backward.tc_launches
    d_msg, d_w = edge_map_backward(msg, frames, stack, grad_out)
    torch.cuda.synchronize()
    # bf16 runs on the tensor-core kernel
    assert (edge_map_backward.launches, edge_map_backward.tc_launches) == (
        before[0] + 1, before[1] + (dtype == torch.bfloat16)
    )
    assert d_msg.dtype == dtype and d_w.dtype == torch.float32
    want_msg, want_w = edge_map_backward_plain(msg, frames, stack, grad_out)
    if dtype == torch.float32:
        # float32 throughout; the summation order differs
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_is_deterministic(rng, cuda, dtype):
    with torch.no_grad():
        stack = _message_passing(ModuleCfg()).to(cuda, dtype).packed_stack()
    e = 5000
    args = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
        for shape in ((e, stack.in_dim), (e, 9), (e, stack.out_dim))
    ]
    first = edge_map_backward(args[0], args[1], stack, args[2])
    again = edge_map_backward(args[0], args[1], stack, args[2])
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_k3_bf16_makes_no_transposed_copy(rng, cuda, monkeypatch):
    """The tensor-core K3 reads the staged weights transposed through
    ldmatrix: no transposed copy of the weights is made."""
    with torch.no_grad():
        stack = _message_passing(ModuleCfg()).to(cuda, torch.bfloat16).packed_stack()

    def refuse(self):
        raise AssertionError("the bf16 backward made a transposed copy")

    monkeypatch.setattr(PackedStack, "transposed", refuse)
    e = 200
    args = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
        for shape in ((e, stack.in_dim), (e, 9), (e, stack.out_dim))
    ]
    d_msg, d_w = edge_map_backward(*args[:2], stack, args[2])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d_msg).all()) and bool(torch.isfinite(d_w).all())


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
