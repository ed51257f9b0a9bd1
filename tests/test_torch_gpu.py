"""The port's CUDA kernels and its prediction on the card (marked ``gpu``).

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
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops.edge_map import edge_map, edge_map_plain
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [148, 9])  # the vectorised and the any-width kernel
@pytest.mark.parametrize("tile", [128, 1])
def test_k1_cuda_matches_plain(rng, cuda, tile, dim, dtype):
    batch = port_predict.synthetic_batches(1, 2, 70, 6, seed=2, sort_tile=tile)[0]
    splits = torch.from_numpy(batch.edge_row_splits).to(cuda)
    data = torch.from_numpy(rng.normal(size=(batch.num_edges, dim)).astype(np.float32)).to(cuda, dtype)
    before = segment_sum_sorted.launches
    got = segment_sum_sorted(data, splits, batch.num_nodes)
    torch.cuda.synchronize()
    assert segment_sum_sorted.launches == before + 1
    want = segment_sum_sorted_plain(data, splits, batch.num_nodes)
    # bf16: both round a float32 sum once; the order can flip that rounding
    tol = dict(atol=1e-4) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


STACK_SETTINGS = {
    "production": ModuleCfg(),
    "norm_gate_vector_residual": ModuleCfg(
        vector_gate=False, vector_nonlinearity="relu", vector_residual=True
    ),
}


def _message_passing(cfg: ModuleCfg, num_message_layers: int = 4) -> GCPMessagePassing:
    return GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), cfg, LayerCfg(mp_cfg=MPCfg(num_message_layers=num_message_layers)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("settings", sorted(STACK_SETTINGS))
def test_k2_cuda_matches_plain(rng, cuda, settings, dtype):
    stack = _message_passing(STACK_SETTINGS[settings]).to(cuda, dtype).packed_stack()
    e = 1000  # not a multiple of the kernel's 64-row tile
    msg = rng.normal(size=(e, stack.in_dim)).astype(np.float32)
    msg[: e // 4, stack.layers[0].dims[0] :] = 0.0  # zero vectors: the norm's eps decides
    msg = torch.from_numpy(msg).to(cuda, dtype)
    frames = torch.from_numpy(rng.normal(size=(e, 9)).astype(np.float32)).to(cuda, dtype)
    before = edge_map.launches
    with torch.no_grad():
        got = edge_map(msg, frames, stack)
        torch.cuda.synchronize()
        want = edge_map_plain(msg, frames, stack)
    assert edge_map.launches == before + 1
    # bf16: the plain version rounds every matmul output to bf16, the kernel
    # keeps float32 intermediates
    tol = 1e-4 if dtype == torch.float32 else 5e-2 * max(1.0, want.float().abs().max().item())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol)


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
