"""The port's training slice against the JAX package, on the CPU.

- Gradients of the fused stack (K2 forward, K3 backward) and of the sorted
  segment sum (K1) against ``jax.grad`` through the Pallas kernels in
  interpret mode; the LBA loss and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX model in its ``"fused"`` configuration:
  fp32, atol 1e-4 (the same float32 math in another order); the plain fp32
  stack backward also at the main path's widths.

The training step itself (Adam against the JAX ``Trainer``, bf16, dropout,
the gradient-norm ring, the optimizers, the entry point) is
``test_torch_train_step.py``.
"""

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcpnet_tpu.nn.gcp as jgcp
import gcpnet_tpu.nn.message_passing as jmp
import gcpnet_tpu.ops.pallas_fused as jpallas_fused
import gcpnet_tpu.ops.segment as jseg
from _torch_parity import (
    LBA_BUCKET,
    LBA_MESSAGE_LAYERS,
    LBA_MODEL,
    lba_graphs,
    load_jax_params,
    np_,
    port_batch,
    port_lba,
    random_graphs,
    sorted_batch,
    t,
    to_jax,
)
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.batching import Bucket as JBucket
from gcpnet_tpu.data.batching import collate_shards as jcollate_shards
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
from gcpnet_tpu.models.lba import graph_regression_loss as jgraph_regression_loss
from gcpnet_tpu.nn.primitives import ScalarVector as JScalarVector
from gcpnet_tpu.ops.pallas_segment import segment_sum_sorted as jsegment_sum_sorted
from gcpnet_torch.config.schema import LayerCfg, ModuleCfg, MPCfg
from gcpnet_torch.models.lba import graph_regression_loss
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import ScalarVector as ScalarVectorT
from gcpnet_torch.ops.edge_map import edge_map, edge_map_backward, edge_map_backward_plain
from gcpnet_torch.ops.segment import gather_rows
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4


def _fused_jax(monkeypatch):
    """The JAX package's fused configuration: fast MM-form stack in the
    Pallas edge map, Pallas sorted segment sum."""
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
    monkeypatch.setattr(jseg, "USE_PALLAS_SEGMENT", True)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)


def _assert_grads_match(jax_grads, module, **tol):
    """Every parameter gradient of ``module`` against the flax gradient tree,
    brought into the port's names by the weight bridge."""
    want = from_jax_params(jax_grads)
    got = {name: p.grad for name, p in module.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(np_(g), want[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("tile", [128, 1])
def test_k1_gradient_matches_pallas(rng, tile):
    batch = sorted_batch(rng, tile)
    splits, n = batch.edge_row_splits, batch.num_nodes
    data = rng.normal(size=(batch.num_edges, 9)).astype(np.float32)
    cot = rng.normal(size=(n, 9)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda d: jsegment_sum_sorted(d, splits, n), jnp.asarray(data))
        (want,) = vjp(jnp.asarray(cot))
    x = t(data).requires_grad_()
    (segment_sum_sorted(x, torch.from_numpy(splits), n) * t(cot)).sum().backward()
    np.testing.assert_allclose(np_(x.grad), np.asarray(want), atol=ATOL)
    # rows outside [splits[0], splits[-1]) get no gradient
    assert not x.grad[int(splits[-1]) :].any()


def test_stack_gradients_match_pallas_kernel(rng, monkeypatch):
    """d inputs and every stack weight of one message passing layer in the
    fused configuration (K2 + K3 + K1): the port's autograd against jax.grad
    through the Pallas edge map and its recompute backward (interpret mode)."""
    batch = sorted_batch(rng, 128, nodes=30, edges=120, bucket_edges=400)
    n, e = batch.num_nodes, batch.num_edges
    inputs = [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((n, 16), (n, 12), (e, 8), (e, 12))
    ]
    inputs[1][: n // 2] = 0.0  # zero vectors: the norm's eps decides
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    cot_s, cot_v = rng.normal(size=(n, 16)).astype(np.float32), rng.normal(size=(n, 12)).astype(np.float32)
    mask = np.asarray(batch.edge_pad_mask)
    mp_cfg = dict(num_message_layers=LBA_MESSAGE_LAYERS)
    jmod = jmp.GCPMessagePassing(
        input_dims=(16, 4), output_dims=(16, 4), edge_dims=(8, 4), cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(**mp_cfg)),
    )
    jargs = (jnp.asarray(batch.senders), jnp.asarray(batch.receivers), jnp.asarray(frames))
    kw = dict(edge_mask=jnp.asarray(mask), count_mask=jnp.asarray(mask),
              row_splits=jnp.asarray(batch.edge_row_splits))

    def jloss(params, ns, nv, es, ev):
        out = jmod.apply(params, JScalarVector(ns, nv), JScalarVector(es, ev), *jargs, **kw)
        return jnp.sum(out.scalar * cot_s) + jnp.sum(out.vector * cot_v)

    variables = jmod.init(jax.random.key(0), JScalarVector(*inputs[:2]), JScalarVector(*inputs[2:]), *jargs, **kw)
    _fused_jax(monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(variables, *map(jnp.asarray, inputs))

    port = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(**mp_cfg)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    load_jax_params(port, variables)
    xs = [t(a).requires_grad_() for a in inputs]
    tb = batch.to("cpu")
    launches = edge_map_backward.launches
    out = port(
        ScalarVectorT(xs[0], xs[1]), ScalarVectorT(xs[2], xs[3]), tb.senders, tb.receiver_index(), t(frames),
        edge_mask=tb.edge_pad_mask, count_mask=tb.edge_pad_mask,
    )
    ((out.scalar * t(cot_s)).sum() + (out.vector * t(cot_v)).sum()).backward()
    assert edge_map_backward.launches == launches  # the CPU path runs the plain version
    _assert_grads_match(want[0], port, atol=ATOL)
    for x, w in zip(xs, want[1:]):
        np.testing.assert_allclose(np_(x.grad), np.asarray(w), atol=ATOL)


# bf16 keeps 8 significant bits: one rounding is within 2^-8 relative.  The
# two sides round at different places (the JAX MM form takes the norms and
# the frame contraction as bf16 products fed to matmuls, the port as bf16
# sums), and 3 layers of products, norms and relus carry those roundings on;
# a relu whose input lies within one rounding of 0 takes different sides,
# and its entry differs by O(1).  So the gradients are compared in norm, at
# 4 roundings: ||port - jax|| <= 4 * 2^-8 * ||jax|| (measured: ~1.5
# roundings for d message and for all weight gradients together).
STACK_BF16_NORM_TOL = 4 * 2.0**-8


def _norm_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_stack_gradients_match_pallas_kernel_bf16(rng, monkeypatch):
    """The numerics the bf16 K3 follows: the port's plain bf16 backward
    (``edge_map_backward_plain`` on bf16 inputs) against ``jax.grad``
    through the Pallas edge map in bf16 (interpret mode), on the very rows
    the Pallas kernel was given: d message and every stack weight's
    gradient.  The JAX kernel casts its float32 weights to bf16; the port's
    weights are given the same bf16 values."""
    batch = sorted_batch(rng, 128, nodes=30, edges=120, bucket_edges=400)
    n, e = batch.num_nodes, batch.num_edges
    inputs = [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((n, 16), (n, 12), (e, 8), (e, 12))
    ]
    inputs[1][: n // 2] = 0.0  # zero vectors: the norm's eps decides
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    mask = np.asarray(batch.edge_pad_mask)
    mp_cfg = dict(num_message_layers=LBA_MESSAGE_LAYERS)
    jmod = jmp.GCPMessagePassing(
        input_dims=(16, 4), output_dims=(16, 4), edge_dims=(8, 4), cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(**mp_cfg)),
    )
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in inputs]
    jargs = (jnp.asarray(batch.senders), jnp.asarray(batch.receivers), jnp.asarray(frames, jnp.bfloat16))
    kw = dict(edge_mask=jnp.asarray(mask), count_mask=jnp.asarray(mask),
              row_splits=jnp.asarray(batch.edge_row_splits))
    variables = jmod.init(
        jax.random.key(0), JScalarVector(*map(jnp.asarray, inputs[:2])),
        JScalarVector(*map(jnp.asarray, inputs[2:])), *jargs[:2], jnp.asarray(frames), **kw,
    )
    # the cotangent of the stack's output, bf16 values
    cot = jnp.asarray(rng.normal(size=(e, 16 + 3 * 4)), jnp.bfloat16)

    seen = {}
    real_edge_map = jpallas_fused.edge_map

    def recording_edge_map(fn, params, edge_data, out_dim):
        out = real_edge_map(fn, params, edge_data, out_dim)
        seen.update(fn=fn, params=params, edge_data=edge_data, out_dim=out_dim, out=out)
        return out

    def apply(v):
        jmod.apply(v, JScalarVector(*bf16[:2]), JScalarVector(*bf16[2:]), *jargs, **kw)
        return seen["out"]

    _fused_jax(monkeypatch)
    monkeypatch.setattr(jpallas_fused, "edge_map", recording_edge_map)
    with pltpu.force_tpu_interpret_mode():
        apply(variables)
        fn, params, edge_data, out_dim = (seen[k] for k in ("fn", "params", "edge_data", "out_dim"))
        assert edge_data.dtype == jnp.bfloat16
        # d edge data through the Pallas backward; d weights in the flax tree
        _, vjp = jax.vjp(lambda d: real_edge_map(fn, params, d, out_dim), edge_data)
        (want_data,) = vjp(cot)
        want_w = jax.grad(lambda v: jnp.sum(apply(v).astype(jnp.float32) * cot.astype(jnp.float32)))(variables)

    port = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(**mp_cfg)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    load_jax_params(port, variables)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(p.bfloat16().float())
    stack = port.packed_stack()
    base = stack.in_dim
    data = t(edge_data.astype(jnp.float32), torch.bfloat16)
    message, masked_frames = data[:, :base].contiguous(), data[:, base : base + 9].contiguous()
    d_msg, d_w = edge_map_backward_plain(message, masked_frames, stack, t(cot.astype(jnp.float32), torch.bfloat16))
    assert d_msg.dtype == torch.bfloat16 and d_w.dtype == torch.float32
    stack.weights.backward(d_w)  # the packed buffer's gradient to each weight

    assert _norm_rel(np_(d_msg), np_(want_data[:, :base])) <= STACK_BF16_NORM_TOL
    want = from_jax_params(want_w)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert got.keys() == want.keys()
    names = sorted(got)
    assert _norm_rel(
        np.concatenate([np_(got[k]).reshape(-1) for k in names]),
        np.concatenate([want[k].numpy().reshape(-1) for k in names]),
    ) <= STACK_BF16_NORM_TOL


def test_stack_gradients_match_pallas_kernel_main_widths(rng, monkeypatch):
    """The yardstick the card holds the fp32 K3 to at full width: the port's
    plain fp32 backward (``edge_map_backward_plain``) at the main path's
    widths (8 GCP2 layers, 232/36 -> 100/16 with hidden 9 then 4) against
    ``jax.vjp`` through the Pallas edge map and its recompute backward in
    float32 (interpret mode), on the very rows the Pallas kernel was given
    (64 edge rows): d message and every stack weight's gradient, at fp32
    atol 1e-4."""
    batch = sorted_batch(rng, 1, nodes=8, graphs=2, edges=30, bucket_edges=64)
    n, e = batch.num_nodes, batch.num_edges
    assert e == 64
    inputs = [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((n, 100), (n, 3 * 16), (e, 32), (e, 3 * 4))
    ]
    inputs[1][: n // 2] = 0.0  # zero vectors: the norm's eps decides
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    mask = np.asarray(batch.edge_pad_mask)
    mp_cfg = dict(num_message_layers=8)
    jmod = jmp.GCPMessagePassing(
        input_dims=(100, 16), output_dims=(100, 16), edge_dims=(32, 4), cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(**mp_cfg)),
    )
    xs = [jnp.asarray(a) for a in inputs]
    jargs = (jnp.asarray(batch.senders), jnp.asarray(batch.receivers), jnp.asarray(frames))
    kw = dict(edge_mask=jnp.asarray(mask), count_mask=jnp.asarray(mask),
              row_splits=jnp.asarray(batch.edge_row_splits))
    variables = jax.jit(jmod.init)(jax.random.key(0), JScalarVector(*xs[:2]), JScalarVector(*xs[2:]), *jargs, **kw)
    real_edge_map = jpallas_fused.edge_map
    seen = {}

    def probed_edge_map(fn, params, edge_data, out_dim):
        # a zero probe added to the edge data: its gradient is d edge data
        seen.update(edge_data=edge_data, out=real_edge_map(fn, params, edge_data + seen["probe"], out_dim))
        return seen["out"]

    def loss(v, probe):
        seen["probe"] = probe
        jmod.apply(v, JScalarVector(*xs[:2]), JScalarVector(*xs[2:]), *jargs, **kw)
        return jnp.sum(seen["out"] * cot), seen["edge_data"]

    _fused_jax(monkeypatch)
    monkeypatch.setattr(jpallas_fused, "edge_map", probed_edge_map)
    out_dim = 100 + 3 * 16
    cot = jnp.asarray(rng.normal(size=(e, out_dim)).astype(np.float32))
    width = jax.eval_shape(loss, variables, jnp.zeros((e, 1)))[1].shape[1]
    with pltpu.force_tpu_interpret_mode():
        # d weights in the flax tree and d edge data, through the Pallas
        # forward and its recompute backward
        (want_w, want_data), edge_data = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
            variables, jnp.zeros((e, width), jnp.float32)
        )
    assert edge_data.dtype == jnp.float32

    port = GCPMessagePassing(
        (100, 16), (100, 16), (32, 4), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(**mp_cfg)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    load_jax_params(port, variables)
    stack = port.packed_stack()
    assert [layer.dims for layer in stack.layers] == [(232, 36, 9, 100, 16)] + [(100, 16, 4, 100, 16)] * 7
    base = stack.in_dim
    data = t(edge_data)
    message, masked_frames = data[:, :base].contiguous(), data[:, base : base + 9].contiguous()
    d_msg, d_w = edge_map_backward_plain(message, masked_frames, stack, t(cot))
    stack.weights.backward(d_w)  # the packed buffer's gradient to each weight

    np.testing.assert_allclose(np_(d_msg), np.asarray(want_data[:, :base]), atol=ATOL)
    _assert_grads_match(want_w, port, atol=ATOL)


def test_gather_rows_gradient_accumulates_in_float32(rng):
    """The node gathers' gradient sums each node's rows in float32 and
    rounds once (448 bf16 rows of ~1 into one node, where a bf16 running
    sum would drift)."""
    data = t(rng.normal(size=(10, 4)), torch.bfloat16).requires_grad_()
    index = torch.from_numpy(np.concatenate([np.zeros(448), rng.integers(0, 10, 200)]).astype(np.int64))
    grad = t(1 + 0.1 * rng.normal(size=(648, 4)), torch.bfloat16)
    out = gather_rows(data, index)
    assert torch.equal(out, data.detach()[index])
    out.backward(grad)
    want = torch.zeros(10, 4).index_add_(0, index, grad.float()).bfloat16()
    assert data.grad.dtype == torch.bfloat16 and torch.equal(data.grad, want)


def test_edge_map_gradient_guards():
    port = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    stack = port.packed_stack()
    msg = torch.zeros(10, stack.in_dim)
    with pytest.raises(NotImplementedError, match="frames"):
        edge_map(msg, torch.zeros(10, 9, requires_grad=True), stack)
    with pytest.raises(ValueError, match="grad_out"):
        edge_map_backward(msg, torch.zeros(10, 9), stack, torch.zeros(10, stack.out_dim - 1))
    d_msg, d_w = edge_map_backward(msg, torch.zeros(10, 9), stack, torch.ones(10, stack.out_dim))
    assert d_msg.shape == msg.shape and d_w.shape == stack.weights.shape and d_w.dtype == torch.float32


@pytest.fixture(scope="module")
def jax_fused_gradients():
    """The JAX LBA model in the fused configuration (Pallas K1/K2/K3 in
    interpret mode): (params, loss, gradient tree) of the masked MSE."""
    batch = to_jax(jcollate_shards(
        [[JGraphData(**g) for g in lba_graphs()]], JBucket(*LBA_BUCKET),
        extra_graph_keys=("label",), sort_edges=True,
    ))
    model = JGCPNetLBA(
        model_cfg=JModelCfg(**LBA_MODEL), module_cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=LBA_MESSAGE_LAYERS)), num_atom_types=9,
    )
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        _fused_jax(mp)
        params = model.init(jax.random.key(0), batch, True)

        def loss_fn(p):
            return jgraph_regression_loss(model.apply(p, batch, True), batch)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
    return params, float(loss), grads


@pytest.mark.parametrize("tile", [128, 1])
def test_lba_gradients_match_jax_fused(jax_fused_gradients, tile):
    """The LBA loss and every parameter's gradient, on both sorted layouts."""
    params, want_loss, want_grads = jax_fused_gradients
    model = port_lba(params)
    batch = port_batch(lba_graphs(), tile).to("cpu")
    loss, _ = graph_regression_loss(model(batch), batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=ATOL)
    _assert_grads_match(want_grads, model, atol=ATOL, rtol=ATOL)
