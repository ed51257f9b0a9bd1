"""The two kernels of the port's forward path against the JAX package's
Pallas kernels, on the CPU (Pallas in interpret mode, the port's wrappers on
their plain versions).  The CUDA kernels are held against their plain
versions on the card in ``test_torch_gpu.py``.

K1 (segment_sum_sorted) at fp32: atol 1e-4, the float32 sums in another
order.  K2 (edge_map) at fp32: atol 5e-6 on the Pallas kernel's own rows,
the same float32 math in another order (a misplaced norm eps shows as
~3e-5 on rows with zero vectors); 1e-4 through the whole message passing.
"""

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcpnet_tpu.nn.message_passing as jmp
import gcpnet_tpu.ops.pallas_fused as jpallas_fused
from _torch_parity import load_jax_params, np_, sorted_batch, t
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.nn.primitives import ScalarVector as JScalarVector
from gcpnet_tpu.ops.pallas_segment import segment_sum_sorted as jsegment_sum_sorted
from gcpnet_torch.config.schema import LayerCfg, ModuleCfg, MPCfg
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import ScalarVector as ScalarVectorT
from gcpnet_torch.ops.build import SIGNATURES
from gcpnet_torch.ops.edge_map import edge_map, edge_map_backward, k3_library
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted, segment_sum_sorted_plain
from gcpnet_torch.weights import from_jax_params, to_jax_params


@pytest.mark.parametrize("dim", [148, 9, 1])
@pytest.mark.parametrize("tile", [128, 1])
def test_k1_plain_matches_pallas(rng, tile, dim):
    batch = sorted_batch(rng, tile)
    splits = batch.edge_row_splits
    n = batch.num_nodes
    data = rng.normal(size=(batch.num_edges, dim)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsegment_sum_sorted(data, splits, n))
    got = segment_sum_sorted(t(data), torch.from_numpy(splits), n)
    np.testing.assert_allclose(np_(got), want, atol=1e-4)
    # rows outside [splits[0], splits[-1]) belong to no node
    assert splits[-1] < batch.num_edges
    # the sorted layout's holes: summed into the last node of each tile
    if tile == 128:
        assert int(np.diff(splits).sum()) > int(np.asarray(batch.edge_pad_mask).sum())


def test_k1_plain_empty_and_bf16(rng):
    splits = torch.tensor([0, 0, 3, 3, 5], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    out = segment_sum_sorted(data, splits, 4)
    np.testing.assert_allclose(np_(out[0]), 0.0)
    np.testing.assert_allclose(np_(out[1]), np_(data[:3].sum(0)), atol=1e-6)
    np.testing.assert_allclose(np_(out[2]), 0.0)
    np.testing.assert_allclose(np_(out[3]), np_(data[3:5].sum(0)), atol=1e-6)
    # bf16: float32 accumulation, one rounding at the end
    out16 = segment_sum_sorted(data.bfloat16(), splits, 4)
    assert out16.dtype == torch.bfloat16
    ref = segment_sum_sorted_plain(data.bfloat16().float(), splits, 4).bfloat16()
    assert torch.equal(out16, ref)


def test_k1_wrapper_rejects_bad_inputs():
    data = torch.zeros(8, 4)
    splits = torch.tensor([0, 4, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_sum_sorted(data, splits.long(), 2)
    with pytest.raises(ValueError):
        segment_sum_sorted(data, splits, 3)
    with pytest.raises(TypeError):
        segment_sum_sorted(data.double(), splits, 2)
    with pytest.raises(ValueError):
        segment_sum_sorted(torch.zeros(4, 8).t(), splits, 2)


def _message_passing_pair(num_message_layers, acts=None):
    """The JAX message passing and its port at the small widths, with the
    stack's ``(scalar, vector)`` activations where given."""
    kw = dict(num_message_layers=num_message_layers)
    nonlinearities = {} if acts is None else dict(scalar_nonlinearity=acts[0], vector_nonlinearity=acts[1])
    jmod = jmp.GCPMessagePassing(
        input_dims=(16, 4), output_dims=(16, 4), edge_dims=(8, 4), cfg=JModuleCfg(**nonlinearities),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(**kw)),
    )
    port = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), ModuleCfg(**nonlinearities), LayerCfg(mp_cfg=MPCfg(**kw)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return jmod, port


def _k3_against_pallas(rng, record, message, masked_frames, stack):
    """The Pallas edge map's backward (``jax.vjp`` through the recorded
    call, interpret mode) for a random cotangent against the port's plain
    K3 on the same rows: ``(d message, the JAX kernel's d message)``."""
    import jax
    import jax.numpy as jnp

    cot = rng.normal(size=record["out"].shape).astype(np.float32)
    fn, params, data, out_dim = record["call"]
    def backward(d, c):
        return jax.vjp(lambda x: jpallas_fused.edge_map(fn, params, x, out_dim), d)[1](c)[0]

    with pltpu.force_tpu_interpret_mode():
        d_data = jax.jit(backward)(data, jnp.asarray(cot, data.dtype))
    d_message, _ = edge_map_backward(message, masked_frames, stack, t(cot, message.dtype))
    want = np.asarray(d_data[:, : stack.in_dim].astype(jnp.float32))
    return np_(d_message), want


# The JAX stacks beside the default relu one: each transcendental code of
# the kernels' layer table (csrc/edge_stack.cuh) as the scalar and as the
# vector (gate) activation
K2_CASES = [pytest.param(tile, n, None, id=f"{tile}-{n}") for n in (1, 2, 4) for tile in (128, 1)] + [
    pytest.param(128, 2, ("gelu", "sigmoid"), id="128-2-gelu-sigmoid"),
    pytest.param(1, 2, ("selu", "tanh"), id="1-2-selu-tanh"),
]


@pytest.mark.parametrize("tile,num_message_layers,acts", K2_CASES)
def test_k2_plain_matches_pallas_edge_map(rng, monkeypatch, tile, num_message_layers, acts):
    """The JAX fused configuration's message stack (fast MM-form stack inside
    the Pallas edge map, interpret mode) against the port's plain K2 on the
    very rows the Pallas kernel was given; then the whole message passing
    (K2 + K1 mean) against the JAX one, on both sorted layouts.  With
    ``acts``, also the backward: d message from ``jax.vjp`` through the
    Pallas edge map (its backward kernel) against the port's plain K3 on
    the same rows, and every parameter's gradient of the whole message
    passing against ``jax.vjp`` of the flax module, fp32 atol 1e-4."""
    import jax
    import jax.numpy as jnp

    batch = sorted_batch(rng, tile, nodes=30, edges=120, bucket_edges=400)
    n, e = batch.num_nodes, batch.num_edges
    node_s = rng.normal(size=(n, 16)).astype(np.float32)
    node_v = rng.normal(size=(n, 12)).astype(np.float32)
    edge_s = rng.normal(size=(e, 8)).astype(np.float32)
    edge_v = rng.normal(size=(e, 12)).astype(np.float32)
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    # all-zero vectors on some message rows, where the eps placement of the
    # vector norm, sqrt(x + 1e-8) + 1e-8, sets the value
    node_v[: n // 2] = 0.0
    edge_v[: e // 2] = 0.0
    mask = np.asarray(batch.edge_pad_mask)
    jmod, port = _message_passing_pair(num_message_layers, acts)
    args = (
        JScalarVector(jnp.asarray(node_s), jnp.asarray(node_v)),
        JScalarVector(jnp.asarray(edge_s), jnp.asarray(edge_v)),
        jnp.asarray(batch.senders), jnp.asarray(batch.receivers), jnp.asarray(frames),
    )
    kw = dict(edge_mask=jnp.asarray(mask), count_mask=jnp.asarray(mask),
              row_splits=jnp.asarray(batch.edge_row_splits))
    variables = jmod.init(jax.random.key(0), *args, **kw)
    load_jax_params(port, variables)

    seen = {}
    real_edge_map = jpallas_fused.edge_map

    def recording_edge_map(fn, params, edge_data, out_dim):
        out = real_edge_map(fn, params, edge_data, out_dim)
        if "call" not in seen:  # the forward's call (jax.vjp below calls it again)
            seen.update(call=(fn, params, edge_data, out_dim), **{"in": np.asarray(edge_data), "out": np.asarray(out)})
        return out

    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
    monkeypatch.setattr(jpallas_fused, "edge_map", recording_edge_map)
    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply(variables, *args, **kw)

    stack = port.packed_stack()
    base = stack.in_dim
    # the Pallas kernel's input is [message ‖ frp2]; frp2[:, :9] are the
    # masked frames
    message = torch.from_numpy(seen["in"][:, :base].copy())
    masked_frames = torch.from_numpy(seen["in"][:, base : base + 9].copy())
    got = edge_map(message, masked_frames, stack)
    np.testing.assert_allclose(np_(got), seen["out"], atol=5e-6)

    tb = batch.to("cpu")
    got = port(
        ScalarVectorT(t(node_s), t(node_v)), ScalarVectorT(t(edge_s), t(edge_v)),
        tb.senders, tb.receiver_index(), t(frames),
        edge_mask=tb.edge_pad_mask, count_mask=tb.edge_pad_mask,
    )
    np.testing.assert_allclose(np_(got.scalar), np.asarray(want.scalar), atol=1e-4)
    np.testing.assert_allclose(np_(got.vector), np.asarray(want.vector), atol=1e-4)
    if acts is None:
        return
    assert {(layer.act_s, layer.act_v) for layer in stack.layers} == {acts, (None, None)}
    got_d, want_d = _k3_against_pallas(rng, seen, message, masked_frames, stack)
    assert np.abs(want_d).max() > 1e-2
    np.testing.assert_allclose(got_d, want_d, atol=1e-4)
    cot_s, cot_v = (rng.normal(size=a.shape).astype(np.float32) for a in (want.scalar, want.vector))
    def grads(v, cs, cv):
        return jax.vjp(lambda w: jmod.apply(w, *args, **kw), v)[1](JScalarVector(cs, cv))[0]

    with pltpu.force_tpu_interpret_mode():
        want_grads = jax.jit(grads)(variables, jnp.asarray(cot_s), jnp.asarray(cot_v))
    ((got.scalar * t(cot_s)).sum() + (got.vector * t(cot_v)).sum()).backward()
    want_grads = from_jax_params(want_grads)
    named = dict(port.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        np.testing.assert_allclose(np_(p.grad), want_grads[name].numpy(), atol=1e-4, err_msg=name)


# bf16 K2 against the Pallas edge map in bf16, in norm: both take bf16
# operands with float32 accumulators and round each product's output to
# bf16, but the JAX kernel's MM form (block-diagonal and selector matrices)
# rounds its elementwise work at other places than the plain version, each
# rounding up to 2^-8 relative, and stacked layers add them up like a
# random walk: 0.0013 for one layer and 0.0027 for eight on these rows.
K2_BF16_NORM_TOL = 2 * 2.0**-8


@pytest.mark.parametrize("num_message_layers,acts", [
    pytest.param(1, None, id="1"), pytest.param(8, None, id="8"),
    pytest.param(2, ("gelu", "sigmoid"), id="2-gelu-sigmoid"), pytest.param(2, ("selu", "tanh"), id="2-selu-tanh"),
])
def test_k2_plain_bf16_matches_pallas_edge_map(rng, monkeypatch, num_message_layers, acts):
    """The numerics the bf16 K2 follows: the port's plain K2 on bf16 rows
    against the Pallas edge map's bf16 output (interpret mode), on the very
    rows the Pallas kernel was given.  The JAX kernel casts its float32
    weights to bf16; the port's weights are given the same bf16 values.
    With ``acts`` (the stack's scalar and vector activations), also d
    message from ``jax.vjp`` through the Pallas edge map (its backward
    kernel, in bf16) against the port's plain K3 on the same bf16 rows, in
    norm within the same bound."""
    import jax
    import jax.numpy as jnp

    batch = sorted_batch(rng, 128, nodes=30, edges=120, bucket_edges=400)
    n, e = batch.num_nodes, batch.num_edges
    inputs = [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((n, 16), (n, 12), (e, 8), (e, 12))
    ]
    inputs[1][: n // 2] = 0.0  # zero vectors: the norm's eps decides
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    mask = np.asarray(batch.edge_pad_mask)
    jmod, port = _message_passing_pair(num_message_layers, acts)
    kw = dict(edge_mask=jnp.asarray(mask), count_mask=jnp.asarray(mask),
              row_splits=jnp.asarray(batch.edge_row_splits))
    senders, receivers = jnp.asarray(batch.senders), jnp.asarray(batch.receivers)
    variables = jmod.init(
        jax.random.key(0), JScalarVector(*map(jnp.asarray, inputs[:2])),
        JScalarVector(*map(jnp.asarray, inputs[2:])), senders, receivers, jnp.asarray(frames), **kw,
    )
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in inputs]

    seen = {}
    real_edge_map = jpallas_fused.edge_map

    def recording_edge_map(fn, params, edge_data, out_dim):
        out = real_edge_map(fn, params, edge_data, out_dim)
        seen.update(edge_data=edge_data, out=out, call=(fn, params, edge_data, out_dim))
        return out

    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
    monkeypatch.setattr(jpallas_fused, "edge_map", recording_edge_map)
    with pltpu.force_tpu_interpret_mode():
        jmod.apply(variables, JScalarVector(*bf16[:2]), JScalarVector(*bf16[2:]), senders, receivers,
                   jnp.asarray(frames, jnp.bfloat16), **kw)
    assert seen["edge_data"].dtype == jnp.bfloat16 and seen["out"].dtype == jnp.bfloat16

    load_jax_params(port, variables)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(p.bfloat16().float())
    stack = port.packed_stack()
    base = stack.in_dim
    data = t(np.asarray(seen["edge_data"].astype(jnp.float32)), torch.bfloat16)
    message, masked_frames = data[:, :base].contiguous(), data[:, base : base + 9].contiguous()
    got = edge_map(message, masked_frames, stack)
    assert got.dtype == torch.bfloat16
    want = np.asarray(seen["out"].astype(jnp.float32))
    got = np_(got.float())
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= K2_BF16_NORM_TOL
    if acts is None:
        return
    got_d, want_d = _k3_against_pallas(rng, seen, message, masked_frames, stack)
    assert np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d) <= K2_BF16_NORM_TOL


def test_lba_with_gelu_sigmoid_stacks_matches_jax_fused(monkeypatch):
    """The small LBA model (2 interaction layers of 2-layer message stacks,
    hidden 16/4/8/4) with gelu on the scalars and sigmoid in the vector
    gate, in the JAX package's fused configuration (the MM-form stack in the
    Pallas edge map and the Pallas sorted segment sum, interpret mode)
    against the port on the CPU (plain K1-K3), the flax weights carried
    across from the port's by ``gcpnet_torch.weights``: the predictions and every
    parameter's gradient (``jax.grad`` of the predictions' sum weighted by
    a random cotangent), fp32 atol 1e-4."""
    import jax
    import jax.numpy as jnp

    import gcpnet_tpu.nn.gcp as jgcp
    import gcpnet_tpu.ops.segment as jseg
    from _torch_parity import LBA_BUCKET, LBA_MODEL, lba_graphs, port_batch, to_jax
    from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
    from gcpnet_tpu.data.batching import Bucket as JBucket
    from gcpnet_tpu.data.batching import collate_shards as jcollate_shards
    from gcpnet_tpu.graph import GraphData as JGraphData
    from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
    from gcpnet_torch.config.schema import ModelCfg
    from gcpnet_torch.models.lba import GCPNetLBA

    acts = dict(scalar_nonlinearity="gelu", vector_nonlinearity="sigmoid")
    graphs = lba_graphs()
    jbatch = to_jax(jcollate_shards([[JGraphData(**g) for g in graphs]], JBucket(*LBA_BUCKET),
                                    extra_graph_keys=("label",), sort_edges=True))
    jmodel = JGCPNetLBA(model_cfg=JModelCfg(**LBA_MODEL), module_cfg=JModuleCfg(**acts),
                        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2)), num_atom_types=9)
    cot = np.random.default_rng(5).normal(size=LBA_BUCKET[2]).astype(np.float32)
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
    monkeypatch.setattr(jseg, "USE_PALLAS_SEGMENT", True)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)

    def weighted(p):
        out = jmodel.apply(p, jbatch, True)
        return jnp.sum(out * cot), out

    model = GCPNetLBA(ModelCfg(**LBA_MODEL), ModuleCfg(**acts), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
                      generator=torch.Generator().manual_seed(0), device="cpu")
    with pltpu.force_tpu_interpret_mode():
        (_, want), want_grads = jax.jit(jax.value_and_grad(weighted, has_aux=True))(to_jax_params(model.state_dict()))
    got = model(port_batch(graphs).to("cpu"))
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-4)
    (got * t(cot)).sum().backward()
    want_grads = from_jax_params(want_grads)
    named = dict(model.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        np.testing.assert_allclose(np_(p.grad), want_grads[name].numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("acts,lib", [
    (("relu", None), "edge_map_bwd_tc"), (("silu", "silu"), "edge_map_bwd_tc"),
    (("gelu", "sigmoid"), "edge_map_bwd_tc_all"), (("relu", "tanh"), "edge_map_bwd_tc_all"),
    (("selu", None), "edge_map_bwd_tc_all"),
])
def test_k3_library_by_the_stacks_codes(acts, lib):
    """K3 runs a stack with selu, gelu, sigmoid or tanh in the library built
    for every code (csrc/edge_map_bwd_tc_all.cu), any other in the one built
    for codes 0-3, whose code is as before those four joined the table."""
    _, port = _message_passing_pair(2, acts)
    assert k3_library(port.packed_stack()) == lib
    assert lib in SIGNATURES and SIGNATURES[lib] == SIGNATURES["edge_map_bwd_tc"]


def test_k2_wrapper_rejects_bad_inputs():
    _, port = _message_passing_pair(2)
    stack = port.packed_stack()
    msg = torch.zeros(10, stack.in_dim)
    with pytest.raises(ValueError):
        edge_map(msg[:, 1:], torch.zeros(10, 9), stack)
    with pytest.raises(ValueError):
        edge_map(msg, torch.zeros(10, 8), stack)
    with pytest.raises(TypeError):
        edge_map(msg, torch.zeros(10, 9, dtype=torch.bfloat16), stack)


def test_k2_packed_stack_follows_weight_changes():
    """Under inference mode the pack is cached and follows weight changes;
    outside it, each call packs the live weights on the autograd graph."""
    _, port = _message_passing_pair(2)
    with torch.inference_mode():
        first = port.packed_stack()
        assert port.packed_stack() is first
    with torch.no_grad():
        port.message_fusion_0.scalar_out.bias.add_(1.0)
    with torch.inference_mode():
        second = port.packed_stack()
    assert second is not first
    assert not torch.equal(second.weights, first.weights)
    live = port.packed_stack()
    assert live is not port.packed_stack()
    assert live.weights.requires_grad and live.weights.grad_fn is not None
    assert torch.equal(live.weights.detach(), second.weights)


@pytest.mark.parametrize(
    "cfg",
    [
        ModuleCfg(vector_gate=False, vector_nonlinearity="relu", vector_residual=True),
        ModuleCfg(scalar_nonlinearity="leakyrelu", vector_nonlinearity="sigmoid"),
    ],
    ids=["norm_gate_vector_residual", "other_activations"],
)
def test_k2_plain_matches_module_stack(rng, cfg):
    """Stack settings besides the production ones: the sorted path (plain K2,
    K1 mean) against the port's module-by-module stack and index_add_ mean,
    at fp32 atol 1e-5 (the same float32 math in another order)."""
    batch = sorted_batch(rng, 128, nodes=30, edges=120, bucket_edges=400).to("cpu")
    n, e = batch.num_nodes, batch.num_edges
    port = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), cfg, LayerCfg(mp_cfg=MPCfg(num_message_layers=3)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    reps = (
        ScalarVectorT(t(rng.normal(size=(n, 16))), t(rng.normal(size=(n, 12)))),
        ScalarVectorT(t(rng.normal(size=(e, 8))), t(rng.normal(size=(e, 12)))),
    )
    frames = t(rng.normal(size=(e, 9)))
    mask = dict(edge_mask=batch.edge_pad_mask, count_mask=batch.edge_pad_mask)
    with torch.inference_mode():
        got = port(*reps, batch.senders, batch.receiver_index(), frames, **mask)
        want = port(*reps, batch.senders, batch.receivers, frames, **mask)
    np.testing.assert_allclose(np_(got.flatten()), np_(want.flatten()), atol=1e-5)
