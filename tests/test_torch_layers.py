"""gcpnet_torch layers against gcpnet_tpu on the CPU: primitives, segment
ops, frames, GCP2 (edge and node mode), GCPEmbedding and one
GCPInteractions, all at fp32 with atol 1e-5 (1e-4 through whole layers):
the same float32 math, summed in another order."""

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcpnet_tpu.nn.gcp as jgcp
from _torch_parity import load_jax_params, np_, random_graphs, t, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.graph import batch_graphs as jbatch_graphs
from gcpnet_tpu.nn import frames as jframes
from gcpnet_tpu.nn import primitives as jprim
from gcpnet_tpu.nn.embedding import GCPEmbedding as JGCPEmbedding
from gcpnet_tpu.nn.interactions import GCPInteractions as JGCPInteractions
from gcpnet_tpu.ops import segment as jseg
from gcpnet_torch.config.schema import LayerCfg, ModuleCfg, MPCfg
from gcpnet_torch.graph import GraphData, batch_graphs
from gcpnet_torch.nn import frames, primitives
from gcpnet_torch.nn.embedding import GCPEmbedding
from gcpnet_torch.nn.gcp import make_gcp
from gcpnet_torch.nn.interactions import GCPInteractions
from gcpnet_torch.nn.primitives import ScalarVector
from gcpnet_torch.ops import segment

ATOL = 1e-5
LAYER_ATOL = 1e-4


def gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture
def graph_pair(rng):
    """The same random graphs batched by both packages (with padding)."""
    graphs = random_graphs(rng, num_graphs=2, nodes=12, edges=40)
    jb = jbatch_graphs([JGraphData(**g) for g in graphs], 32, 96, 3, extra_graph_keys=("label",))
    tb = batch_graphs([GraphData(**g) for g in graphs], 32, 96, 3, extra_graph_keys=("label",))
    return to_jax(jb), tb.to("cpu")


def test_pack_and_scalar_vector(rng):
    v = rng.normal(size=(5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_(primitives.pack_vector(t(v))), np.asarray(jprim.pack_vector(v)))
    a = jprim.ScalarVector(jnp.asarray(rng.normal(size=(5, 3))), jnp.asarray(rng.normal(size=(5, 6))))
    b = jprim.ScalarVector(jnp.asarray(rng.normal(size=(5, 2))), jnp.asarray(rng.normal(size=(5, 9))))
    ta, tb = ScalarVector(t(a[0]), t(a[1])), ScalarVector(t(b[0]), t(b[1]))
    got = ta.concat((tb,))
    want = a.concat((b,))
    np.testing.assert_allclose(np_(got.flatten()), np.asarray(want.flatten()), atol=ATOL)
    back = ScalarVector.recover(got.flatten(), 5)
    np.testing.assert_array_equal(np_(back.vector), np_(got.vector))
    np.testing.assert_allclose(
        np_(primitives.safe_vec_norm(ta.vector)), np.asarray(jprim.safe_vec_norm(a.vector)), atol=ATOL
    )
    for sqrt in (True, False):
        np.testing.assert_allclose(
            np_(primitives.safe_norm(ta.scalar, sqrt=sqrt)),
            np.asarray(jprim.safe_norm(a.scalar, sqrt=sqrt)), atol=ATOL,
        )


@pytest.mark.parametrize("name", [None, "relu", "leakyrelu", "silu", "gelu", "sigmoid", "tanh", "selu"])
def test_nonlinearities(rng, name):
    x = rng.normal(size=(7, 5)).astype(np.float32)
    np.testing.assert_allclose(
        np_(primitives.get_nonlinearity(name)(t(x))), np.asarray(jprim.get_nonlinearity(name)(x)), atol=ATOL
    )


def test_gcp_layer_norm(rng):
    s = rng.normal(size=(6, 10)).astype(np.float32) * 3 + 1
    v = rng.normal(size=(6, 12)).astype(np.float32)
    jmod = jprim.GCPLayerNorm()
    rep = jprim.ScalarVector(jnp.asarray(s), jnp.asarray(v))
    variables = jmod.init(jax.random.key(0), rep)
    variables = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape), a.dtype) * 0.1, variables
    )
    want = jmod.apply(variables, rep)
    port = load_jax_params(primitives.GCPLayerNorm(10, device="cpu"), variables)
    got = port(ScalarVector(t(s), t(v)))
    np.testing.assert_allclose(np_(got.scalar), np.asarray(want.scalar), atol=ATOL)
    np.testing.assert_allclose(np_(got.vector), np.asarray(want.vector), atol=ATOL)


def test_segment_ops(rng):
    n, e = 7, 40
    ids = rng.integers(0, n, size=e).astype(np.int32)
    data = rng.normal(size=(e, 5)).astype(np.float32)
    mask = rng.random(e) > 0.3
    count_mask = mask | (rng.random(e) > 0.5)
    got = segment.segment_mean(t(data), t(ids).long(), n, mask=t(mask), count_mask=t(count_mask))
    want = jseg.segment_mean(data, ids, n, mask=mask, count_mask=count_mask)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL)
    got = segment.segment_sum(t(data), t(ids).long(), n, mask=t(mask))
    np.testing.assert_allclose(np_(got), np.asarray(jseg.segment_sum(data, ids, n, mask=mask)), atol=ATOL)
    got = segment.segment_count(t(ids).long(), n, mask=t(mask))
    np.testing.assert_allclose(np_(got), np.asarray(jseg.segment_count(ids, n, mask=mask)), atol=ATOL)
    got = segment.masked_mean(t(data), t(mask), dim=None)
    np.testing.assert_allclose(np_(got), np.asarray(jseg.masked_mean(data, mask, axis=None)), atol=ATOL)


def test_frames(graph_pair):
    jb, tb = graph_pair
    node_mask = jb.valid_node_mask()
    jc, jx = jframes.centralize(jb.x, jb.graph_id, jb.num_graphs, node_mask=node_mask)
    tc, tx = frames.centralize(tb.x, tb.graph_id, tb.num_graphs, node_mask=tb.valid_node_mask())
    np.testing.assert_allclose(np_(tc), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(np_(tx), np.asarray(jx), atol=ATOL)
    jf = jframes.localize(jx, jb.senders, jb.receivers, edge_mask=jb.edge_pad_mask)
    tf = frames.localize(tx, tb.senders, tb.receivers, edge_mask=tb.edge_pad_mask)
    np.testing.assert_allclose(np_(tf), np.asarray(jf), atol=ATOL)
    jnf = jframes.node_mean_frames(jf, jb.senders, jb.num_nodes, jb.edge_pad_mask, jb.edge_pad_mask)
    tnf = frames.node_mean_frames(tf, tb.senders, tb.num_nodes, tb.edge_pad_mask, tb.edge_pad_mask)
    np.testing.assert_allclose(np_(tnf), np.asarray(jnf), atol=ATOL)

    rng = np.random.default_rng(5)
    ve = rng.normal(size=(jb.num_edges, 9)).astype(np.float32)
    vn = rng.normal(size=(jb.num_nodes, 9)).astype(np.float32)
    kw = dict(enable_e3_equivariance=False, num_nodes=jb.num_nodes)
    # edge inputs: masked numerators
    want = jframes.scalarize(ve, jb.senders, jb.receivers, jf, node_inputs=False,
                             edge_mask=jb.edge_pad_mask, **kw)
    np.testing.assert_allclose(np_(frames.scalarize(t(ve), tf, tb.edge_pad_mask)), np.asarray(want), atol=ATOL)
    want = jframes.vectorize(ve, jb.senders, jb.receivers, jf, node_inputs=False,
                             num_nodes=jb.num_nodes, edge_mask=jb.edge_pad_mask)
    np.testing.assert_allclose(np_(frames.vectorize(t(ve), tf, tb.edge_pad_mask)), np.asarray(want), atol=ATOL)
    # node inputs: the per-edge gather + scatter mean of the JAX package
    # equals the row-wise product with the node mean frames
    want = jframes.scalarize(vn, jb.senders, jb.receivers, jf, node_inputs=True,
                             edge_mask=jb.edge_pad_mask, count_mask=jb.edge_pad_mask, **kw)
    np.testing.assert_allclose(np_(frames.scalarize(t(vn), tnf)), np.asarray(want), atol=ATOL)
    want = jframes.vectorize(vn, jb.senders, jb.receivers, jf, node_inputs=True, num_nodes=jb.num_nodes,
                             edge_mask=jb.edge_pad_mask, count_mask=jb.edge_pad_mask)
    np.testing.assert_allclose(np_(frames.vectorize(t(vn), tnf)), np.asarray(want), atol=ATOL)


GCP_CASES = {
    # (input dims, output dims, overrides)
    "message_first": ((24, 12), (16, 4), dict()),
    "message_mid": ((16, 4), (16, 4), dict()),
    "message_last_identity": ((16, 4), (16, 4), dict(nonlinearities=(None, None))),
    "vector_residual": ((16, 4), (16, 4), dict(vector_residual=True)),
    "norm_gate": ((16, 4), (16, 4), dict(vector_gate=False, nonlinearities=("relu", "relu"))),
    "scalar_output": ((16, 4), (16, 0), dict(bottleneck=1)),
}


@pytest.mark.parametrize("fused_gcp", [False, True])
@pytest.mark.parametrize("case", sorted(GCP_CASES))
def test_gcp2_edge_mode(rng, monkeypatch, case, fused_gcp):
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", fused_gcp)
    dims_in, dims_out, overrides = GCP_CASES[case]
    e = 30
    s = rng.normal(size=(e, dims_in[0])).astype(np.float32)
    v = rng.normal(size=(e, 3 * dims_in[1])).astype(np.float32)
    fr = rng.normal(size=(e, 9)).astype(np.float32)
    mask = rng.random(e) > 0.2
    idx = np.zeros(e, np.int32)
    jmod = jgcp.make_gcp(dims_in, dims_out, JModuleCfg(), **overrides)
    args = (jprim.ScalarVector(jnp.asarray(s), jnp.asarray(v)), idx, idx, jnp.asarray(fr))
    variables = jmod.init(jax.random.key(1), *args, edge_mask=mask)
    want = jmod.apply(variables, *args, edge_mask=mask)
    port = load_jax_params(make_gcp(dims_in, dims_out, ModuleCfg(), generator=gen(), device="cpu", **overrides), variables)
    got = port(ScalarVector(t(s), t(v)), t(fr), t(mask))
    if dims_out[1] == 0:
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL)
    else:
        np.testing.assert_allclose(np_(got.scalar), np.asarray(want.scalar), atol=ATOL)
        np.testing.assert_allclose(np_(got.vector), np.asarray(want.vector), atol=ATOL)


def test_gcp2_node_mode(graph_pair):
    """Node inputs with node mean frames, as the embedding, feed-forward and
    head GCPs run."""
    jb, tb = graph_pair
    rng = np.random.default_rng(2)
    s = rng.normal(size=(jb.num_nodes, 16)).astype(np.float32)
    v = rng.normal(size=(jb.num_nodes, 12)).astype(np.float32)
    jf = jframes.localize(jb.x, jb.senders, jb.receivers, edge_mask=jb.edge_pad_mask)
    nf = jframes.node_mean_frames(jf, jb.senders, jb.num_nodes, jb.edge_pad_mask, jb.edge_pad_mask)
    jmod = jgcp.make_gcp((16, 4), (64, 8), JModuleCfg(), vector_residual=False)
    rep = jprim.ScalarVector(jnp.asarray(s), jnp.asarray(v))
    kw = dict(node_inputs=True, edge_mask=jb.edge_pad_mask, count_mask=jb.edge_pad_mask, node_frames=nf)
    variables = jmod.init(jax.random.key(3), rep, jb.senders, jb.receivers, jf, **kw)
    want = jmod.apply(variables, rep, jb.senders, jb.receivers, jf, **kw)
    port = load_jax_params(
        make_gcp((16, 4), (64, 8), ModuleCfg(), generator=gen(), device="cpu", vector_residual=False), variables
    )
    got = port(ScalarVector(t(s), t(v)), t(nf))
    np.testing.assert_allclose(np_(got.scalar), np.asarray(want.scalar), atol=ATOL)
    np.testing.assert_allclose(np_(got.vector), np.asarray(want.vector), atol=ATOL)


def _embedded(jb, tb):
    jf = jframes.localize(jb.x, jb.senders, jb.receivers, edge_mask=jb.edge_pad_mask)
    tf = frames.localize(tb.x, tb.senders, tb.receivers, edge_mask=tb.edge_pad_mask)
    jmod = JGCPEmbedding(
        edge_input_dims=(16, 1), node_input_dims=(9, 2), edge_hidden_dims=(8, 4),
        node_hidden_dims=(16, 4), cfg=JModuleCfg(), num_atom_types=9,
    )
    variables = jmod.init(jax.random.key(4), jb, jf, jb.edge_pad_mask, jb.edge_pad_mask)
    want = jmod.apply(variables, jb, jf, jb.edge_pad_mask, jb.edge_pad_mask)
    port = load_jax_params(
        GCPEmbedding((16, 1), (9, 2), (8, 4), (16, 4), ModuleCfg(), num_atom_types=9,
                     generator=gen(), device="cpu"),
        variables,
    )
    got = port(tb, tf, tb.edge_pad_mask, tb.edge_pad_mask)
    return (jf, want), (tf, got)


def test_embedding(graph_pair):
    jb, tb = graph_pair
    (_, (jn, je)), (_, (tn, te)) = _embedded(jb, tb)
    for a, b in ((tn, jn), (te, je)):
        np.testing.assert_allclose(np_(a.scalar), np.asarray(b.scalar), atol=ATOL)
        np.testing.assert_allclose(np_(a.vector), np.asarray(b.vector), atol=ATOL)


def test_interactions(graph_pair):
    """One GCPInteractions (3 message layers, 2 feed-forward GCPs) over the
    edge-list layout: module-path message stack + index_add_ mean."""
    jb, tb = graph_pair
    (jf, (jn, je)), (tf, (tn, te)) = _embedded(jb, tb)
    layer_kw = dict(num_message_layers=3)
    jmod = JGCPInteractions(
        node_dims=(16, 4), edge_dims=(8, 4), cfg=JModuleCfg(), layer_cfg=JLayerCfg(mp_cfg=JMPCfg(**layer_kw)),
    )
    kw = dict(edge_mask=jb.edge_pad_mask, count_mask=jb.edge_pad_mask)
    variables = jmod.init(jax.random.key(5), jn, je, jb.senders, jb.receivers, jf, **kw)
    want = jmod.apply(variables, jn, je, jb.senders, jb.receivers, jf, **kw)
    port = load_jax_params(
        GCPInteractions((16, 4), (8, 4), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(**layer_kw)),
                        generator=gen(), device="cpu"),
        variables,
    )
    got = port(tn, te, tb.senders, tb.receivers, tf, edge_mask=tb.edge_pad_mask, count_mask=tb.edge_pad_mask)
    np.testing.assert_allclose(np_(got.scalar), np.asarray(want.scalar), atol=LAYER_ATOL)
    np.testing.assert_allclose(np_(got.vector), np.asarray(want.vector), atol=LAYER_ATOL)
