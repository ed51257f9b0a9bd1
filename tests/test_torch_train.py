"""The port's training slice against the JAX package, on the CPU.

- Gradients of the fused stack (K2 forward, K3 backward) and of the sorted
  segment sum (K1) against ``jax.grad`` through the Pallas kernels in
  interpret mode; the LBA loss and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX model in its ``"fused"`` configuration:
  fp32, atol 1e-4 (the same float32 math in another order); the plain fp32
  stack backward also at the main path's widths.
- Three fp32 Adam steps with the adaptive clip against the JAX ``Trainer``'s
  own step (plain-XLA fast stack: the fused path's math): losses and
  parameters at atol 1e-4.
- The bf16 step against the port's own fp32 step; dropout; the gradient-norm
  ring against the JAX ring, and its NaN case; optimizers against optax;
  the ``python -m gcpnet_torch.train`` entry point.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
    load_jax_params,
    np_,
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
from gcpnet_tpu.parallel.mesh import make_mesh
from gcpnet_tpu.train.optim import PlateauController as JPlateauController
from gcpnet_tpu.train.optim import build_optimizer as jbuild_optimizer
from gcpnet_tpu.train.optim import build_schedule as jbuild_schedule
from gcpnet_tpu.train.state import GradNormRing as JGradNormRing
from gcpnet_tpu.train.trainer import Trainer
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.batching import Bucket, collate_shards
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import GCPDropout
from gcpnet_torch.nn.primitives import ScalarVector as ScalarVectorT
from gcpnet_torch.ops.edge_map import edge_map, edge_map_backward, edge_map_backward_plain
from gcpnet_torch.ops.segment import gather_rows
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.optim import PlateauController, build_optimizer, build_schedule
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import train_step
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


def _lba_graphs():
    return random_graphs(np.random.default_rng(3), num_graphs=2, nodes=20, edges=70)


def _port_lba(params=None, **model_kw):
    model = GCPNetLBA(
        ModelCfg(**{**LBA_MODEL, **model_kw}), ModuleCfg(),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=LBA_MESSAGE_LAYERS)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return model if params is None else load_jax_params(model, params)


def _port_batch(graphs, sort_tile=128):
    return collate_shards(
        [[GraphData(**g) for g in graphs]], Bucket(*LBA_BUCKET),
        extra_graph_keys=("label",), sort_edges=True, sort_tile=sort_tile,
    )


@pytest.fixture(scope="module")
def jax_fused_gradients():
    """The JAX LBA model in the fused configuration (Pallas K1/K2/K3 in
    interpret mode): (params, loss, gradient tree) of the masked MSE."""
    batch = to_jax(jcollate_shards(
        [[JGraphData(**g) for g in _lba_graphs()]], JBucket(*LBA_BUCKET),
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
    model = _port_lba(params)
    batch = _port_batch(_lba_graphs(), tile).to("cpu")
    loss, _ = graph_regression_loss(model(batch), batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=ATOL)
    _assert_grads_match(want_grads, model, atol=ATOL, rtol=ATOL)


def _train_graphs():
    """Three batches of graphs; the second with labels far off, so that its
    gradient norm exceeds the adaptive clip's threshold."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        graphs = random_graphs(rng, num_graphs=2, nodes=20, edges=70)
        if i == 1:
            for g in graphs:
                g["extras"]["label"] = np.float32(g["extras"]["label"] * 10 + 20)
        out.append(graphs)
    return out


def test_adam_steps_match_jax_trainer(monkeypatch):
    """Three fp32 Adam steps with the adaptive clip on, against the JAX
    Trainer's own train step (dropout off; plain-XLA fast stack)."""
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", False)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)
    optimizer_cfg = {"_target_": "Adam", "lr": 1e-4}
    no_dropout = dict(dropout=0.0, dense_dropout=0.0)
    graphs = _train_graphs()
    jmodel = JGCPNetLBA(
        model_cfg=JModelCfg(**LBA_MODEL, **no_dropout), module_cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=LBA_MESSAGE_LAYERS)), num_atom_types=9,
    )
    trainer = Trainer(
        jmodel, jgraph_regression_loss, optimizer_cfg=optimizer_cfg, mesh=make_mesh(jax.devices()[:1]),
        adaptive_clip=True, precision=32, early_stopping_patience=None,
    )
    jbatches = [
        trainer._put(jcollate_shards(
            [[JGraphData(**g) for g in gs]], JBucket(*LBA_BUCKET), extra_graph_keys=("label",), sort_edges=True,
        ))
        for gs in graphs
    ]
    state = trainer.init_state(jbatches[0])
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = trainer._build_train_step()
    want = []
    for b in jbatches:
        state, loss, gnorm = step(state, b, jax.random.key(0), jnp.float32(1.0))
        want.append((float(loss), float(gnorm), float(state.grad_norms.clip_threshold())))

    model = _port_lba(params0, **no_dropout)
    tstate = TrainState(build_optimizer(model.parameters(), optimizer_cfg), ring=GradNormRing())
    got = []
    for gs in graphs:
        res = train_step(model, tstate, _port_batch(gs).to("cpu"), graph_regression_loss)
        assert res.ok
        got.append((res.loss.item(), res.grad_norm.item(), tstate.ring.clip_threshold().item()))
    assert tstate.step == 3 and int(tstate.ring.count) == 3
    # the second batch's norm is clipped to the first's 1.5x
    assert got[1][1] > 1.5 * got[0][1]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    want_params = from_jax_params(state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(np_(p), want_params[name].numpy(), atol=ATOL, err_msg=name)


def test_bf16_step_tracks_fp32_step():
    """One bf16 step (bf16 copies of the fp32 masters) against the port's
    own fp32 step from the same weights: loss within 2% and gradient norm
    within 5% (bf16 keeps 8 bits), gradients with cosine similarity above
    0.99; the masters stay float32."""
    batch = _port_batch(_lba_graphs()).to("cpu")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _port_lba(dropout=0.0, dense_dropout=0.0)
        state = TrainState(build_optimizer(model.parameters(), {"lr": 1e-4}), compute_dtype=dtype)
        res = train_step(model, state, batch, graph_regression_loss)
        assert res.ok and res.loss.dtype == torch.float32
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
        out[dtype] = (res, torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    (r32, g32), (r16, g16) = out[torch.float32], out[torch.bfloat16]
    np.testing.assert_allclose(r16.loss.item(), r32.loss.item(), rtol=2e-2)
    np.testing.assert_allclose(r16.grad_norm.item(), r32.grad_norm.item(), rtol=5e-2)
    assert torch.nn.functional.cosine_similarity(g16, g32, dim=0) > 0.99


def test_dropout_training_mode():
    n, rate = 4000, 0.25
    x = ScalarVectorT(torch.ones(n, 16), torch.ones(n, 3 * 8))
    drop = GCPDropout(rate)
    out = drop(x, False, torch.Generator().manual_seed(0))
    # keep share ~ 1 - rate; kept values scaled by 1 / keep
    keep_s = (out.scalar != 0).float().mean().item()
    keep_v = (out.vector != 0).float().mean().item()
    assert abs(keep_s - (1 - rate)) < 0.01 and abs(keep_v - (1 - rate)) < 0.02
    np.testing.assert_allclose(np_(out.scalar[out.scalar != 0]), 1 / (1 - rate), rtol=1e-6)
    np.testing.assert_allclose(np_(out.vector[out.vector != 0]), 1 / (1 - rate), rtol=1e-6)
    # whole 3-vectors drop together: the x, y and z blocks share a mask
    kept = (out.vector != 0).reshape(n, 3, 8)
    assert torch.equal(kept[:, 0], kept[:, 1]) and torch.equal(kept[:, 0], kept[:, 2])
    # the same seed gives the same masks, another seed others
    again = drop(x, False, torch.Generator().manual_seed(0))
    other = drop(x, False, torch.Generator().manual_seed(1))
    assert torch.equal(again.scalar, out.scalar) and torch.equal(again.vector, out.vector)
    assert not torch.equal(other.scalar, out.scalar)
    # deterministic (or rate 0) is the identity; training needs a generator
    assert drop(x, True) is x and GCPDropout(0.0)(x, False) is x
    with pytest.raises(ValueError, match="Generator"):
        drop(x, False)
    plain = drop(torch.ones(n, 16), False, torch.Generator().manual_seed(0))
    assert abs((plain != 0).float().mean().item() - (1 - rate)) < 0.01


def test_model_dropout_draws_from_generator():
    batch = _port_batch(_lba_graphs()).to("cpu")
    model = _port_lba()
    with torch.no_grad():
        a = model(batch, False, torch.Generator().manual_seed(5))
        b = model(batch, False, torch.Generator().manual_seed(5))
        c = model(batch, False, torch.Generator().manual_seed(6))
        d = model(batch)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_grad_norm_ring_matches_jax():
    norms = [1.0, 2.0, 0.5, 3.0, 1.5, 0.25, 4.0]
    ring, jring = GradNormRing(capacity=4), JGradNormRing.create(capacity=4)
    assert ring.clip_threshold().item() == float("inf")
    for value in norms:
        ring.push(torch.tensor(value))
        jring = jring.push(jnp.float32(value))
        np.testing.assert_allclose(ring.clip_threshold().item(), float(jring.clip_threshold()), rtol=1e-6)
        np.testing.assert_allclose(
            ring.clip_threshold(3.0).item(), float(jring.clip_threshold(3.0)), rtol=1e-6
        )
    assert int(ring.count) == 4 and int(ring.head) == len(norms) % 4


def test_nan_step_keeps_state_and_ring_finite():
    """A NaN loss leaves the parameters and the Adam moments as they were
    and the ring finite, while the step counter advances.  (The JAX ring,
    which takes the norm before the finite check, turns NaN.)"""
    graphs = _lba_graphs()
    model = _port_lba(dropout=0.0, dense_dropout=0.0)
    state = TrainState(build_optimizer(model.parameters(), {"lr": 1e-3}), ring=GradNormRing())
    assert train_step(model, state, _port_batch(graphs).to("cpu"), graph_regression_loss).ok
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {k: v.clone() for s in state.optimizer.state.values() for k, v in s.items()}
    count = int(state.ring.count)
    for g in graphs:
        g["extras"]["label"] = np.float32("nan")
    res = train_step(model, state, _port_batch(graphs).to("cpu"), graph_regression_loss)
    assert not res.ok and not np.isfinite(res.loss.item())
    assert state.step == 2 and int(state.ring.count) == count
    assert np.isfinite(state.ring.clip_threshold().item())
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    after = {k: v for s in state.optimizer.state.values() for k, v in s.items()}
    assert all(torch.equal(after[k], v) for k, v in moments.items())
    assert np.isnan(float(JGradNormRing.create().push(jnp.float32(1.0)).push(jnp.nan).clip_threshold()))


@pytest.mark.parametrize(
    "cfg",
    [
        {"_target_": "torch.optim.Adam", "lr": 1e-2},
        {"_target_": "Adam", "lr": 1e-2, "weight_decay": 1e-1},
        {"_target_": "AdamW", "lr": 1e-2, "weight_decay": 1e-1},
        {"_target_": "SGD", "lr": 1e-1, "momentum": 0.9},
        {"_target_": "Adam", "lr": 1e-2, "accumulate_grad_batches": 2},
    ],
    ids=["adam", "adam_l2", "adamw", "sgd_momentum", "adam_accumulate"],
)
def test_optimizers_match_optax(rng, cfg):
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(6)]
    tx = jbuild_optimizer(cfg)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    w = torch.nn.Parameter(t(w0))
    opt = build_optimizer([w], cfg)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        w.grad = t(g)
        opt.step()
        np.testing.assert_allclose(np_(w), np.asarray(params["w"]), atol=1e-6)


def test_schedules_match_jax():
    w = torch.nn.Parameter(torch.zeros(1))
    opt = build_optimizer([w], {"lr": 1.0})
    sched = build_schedule(opt, {"_target_": "StepLR", "step_size": "6 // 2", "gamma": 0.5})
    jsched = jbuild_schedule({"_target_": "StepLR", "step_size": "6 // 2", "gamma": 0.5}, base_lr=1.0)
    for i in range(8):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(i)), rtol=1e-6)
        opt.step()
        sched.step()
    assert build_schedule(opt, {"_target_": "ReduceLROnPlateau"}) is None
    assert build_schedule(opt, None) is None
    with pytest.raises(ValueError):
        build_schedule(opt, {"_target_": "CosineAnnealingLR"})
    plateau, jplateau = PlateauController(patience=1), JPlateauController(patience=1)
    for value in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7):
        assert plateau.update(value) == jplateau.update(value)


class _Weights(torch.nn.Module):
    """A "model" whose prediction is its weight matrix: with the loss
    ``sum(w * g)`` a batch ``g`` is the gradient."""

    def __init__(self, w0):
        super().__init__()
        self.w = torch.nn.Parameter(t(w0))

    def forward(self, batch, deterministic=True, generator=None):
        return self.w


def test_steplr_counts_updates_under_accumulation(rng):
    """Adam with accumulation 2 and StepLR (step size 2, gamma 0.5) through
    ``train_step``, against the JAX chain (``optax.MultiSteps`` around the
    scheduled Adam) on the same 8 gradients: the learning rate of every
    applied update and the weights after every mini-step, fp32 atol 1e-4.
    The schedule counts updates, not mini-steps, and torch does not warn
    that it stepped before the optimizer."""
    import warnings

    cfg = {"_target_": "Adam", "lr": 1e-2, "accumulate_grad_batches": 2}
    sched_cfg = {"_target_": "StepLR", "step_size": 2, "gamma": 0.5}
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(8)]
    jsched = jbuild_schedule(sched_cfg, base_lr=cfg["lr"])
    tx = jbuild_optimizer({**cfg, "_schedule_": jsched})
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)

    model = _Weights(w0)
    optimizer = build_optimizer(model.parameters(), cfg)
    state = TrainState(optimizer, scheduler=build_schedule(optimizer, sched_cfg))
    loss_fn = lambda preds, g: ((preds * g).sum(), g)  # noqa: E731
    lrs = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch's warning on the order of the steps
        for i, g in enumerate(grads):
            updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
            params = optax.apply_updates(params, updates)
            lr = float(optimizer.param_groups[0]["lr"])  # a device tensor the schedule writes in place
            assert train_step(model, state, t(g), loss_fn, deterministic=True).ok
            if i % 2 == 1:  # the second mini-step applies the update
                lrs.append(lr)
            np.testing.assert_allclose(np_(model.w), np.asarray(params["w"]), atol=1e-4, err_msg=f"mini-step {i}")
    np.testing.assert_allclose(lrs, [float(jsched(k)) for k in range(4)], rtol=1e-6)
    assert lrs == [1e-2, 1e-2, 5e-3, 5e-3]
    assert state.step == 8 and optimizer.mini_step == 0


def test_accumulation_state_round_trip(rng):
    """A checkpoint taken between the mini-steps of an accumulated update
    (its pending sum and count) goes on exactly as the run it came from."""
    cfg = {"_target_": "Adam", "lr": 1e-2, "accumulate_grad_batches": 2}
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [t(rng.normal(size=(5, 3))) for _ in range(5)]
    runs = []
    for restore_at in (None, 3):
        w = torch.nn.Parameter(t(w0))
        opt = build_optimizer([w], cfg)
        for i, g in enumerate(grads):
            if i == restore_at:
                saved = {"w": w.detach().clone(), "opt": opt.state_dict()}
                w = torch.nn.Parameter(saved["w"])
                opt = build_optimizer([w], cfg)
                opt.load_state_dict(saved["opt"])
                assert opt.mini_step == 1
            w.grad = g
            opt.step()
        runs.append(w.detach())
    assert torch.equal(runs[0], runs[1])


def test_train_cpu_entry_point(capsys):
    args = ["--steps", "2", "--graphs", "2", "--nodes", "16", "--edges-per-node", "6", "--device", "cpu"]
    launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
    train_cli.main(args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert all(ln["updated"] and np.isfinite([ln["loss"], ln["grad_norm"], ln["ms"]]).all() for ln in lines)
    # the same seed gives the same run
    train_cli.main(args)
    again = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["loss"] for ln in again] == [ln["loss"] for ln in lines]
    # the CPU path launches no kernel
    assert (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches) == launches


def test_train_entry_point_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--steps", "1", "--graphs", "1", "--nodes", "8", "--edges-per-node", "4"])
    with pytest.raises(RuntimeError):
        train_cli.build_lba_training(0)
