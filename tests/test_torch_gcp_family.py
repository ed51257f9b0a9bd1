"""The rest of the GCP layer family in the port, against the JAX package and
the reference's fixtures, on the CPU at fp32.

- The reference's fixtures (``tests/golden``, read as
  ``tests/test_torch_golden.py`` reads them): GCP v1 (default, frame gate
  with ``vector_frame_residual``, sigma frame gate, scalar output), GCP2's
  frame gate, E(3) mode and scalar-only input, and the geometry's E(3)
  scalarize on node and edge rows; atol and rtol 1e-4.
- Every setting against the flax module on random weights, on edge rows
  and on node rows (the node rows' per-edge projections over a padded,
  sender-sorted batch with separate numerator and count masks): output,
  and the gradients of every parameter and of the inputs; atol 1e-4.
- ``GCPEmbedding`` with inputs without vector channels (node, edge, both)
  against flax.
- Whole models: RS in E(3) mode against ``GCPNetRS`` (logits, loss and
  every gradient) and against the numpy reference
  (``tests/test_model_golden.py:380``); LBA with each ablation, GCP v1 with
  the sigma frame gate and GCP2 with the frame gate against ``GCPNetLBA``;
  NMS with the force term (``:126``) and CPD with a node mask (``:235``)
  against the numpy reference; atol 1e-4.
- E(3) RS gives a mirrored pair (``gcpnet_torch/data/rs.py``) the same
  logit, SE(3) RS does not.
- ``tasks.build_model`` builds every ``*_ablations`` experiment with each
  ablation flipped, and with GCP v1, the frame gates and E(3) mode.
- ``ops.edge_map._check_kernel_supported`` raises for a packed stack with
  any setting outside the kernels' layer table, naming it.
"""

import sys
from pathlib import Path

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcpnet_tpu.nn.gcp as jgcp
from _torch_parity import load_jax_params, np_, port_batch, random_graphs, t, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.graph import GraphBatch as JGraphBatch
from gcpnet_tpu.models import GCPNetCPD as JGCPNetCPD
from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
from gcpnet_tpu.models import GCPNetNMS as JGCPNetNMS
from gcpnet_tpu.models import GCPNetRS as JGCPNetRS
from gcpnet_tpu.models import rs_loss as jrs_loss
from gcpnet_tpu.models.lba import graph_regression_loss as jlba_loss
from gcpnet_tpu.nn import frames as jframes
from gcpnet_tpu.nn import primitives as jprim
from gcpnet_tpu.nn.embedding import GCPEmbedding as JGCPEmbedding
from gcpnet_torch import tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import rs
from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.cpd import GCPNetCPD
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch.nn import frames
from gcpnet_torch.nn.embedding import GCPEmbedding
from gcpnet_torch.nn.gcp import make_gcp
from gcpnet_torch.nn.message_passing import GCPMessagePassing, kernel_outside
from gcpnet_torch.nn.primitives import ScalarVector, pack_vector
from gcpnet_torch.ops.edge_map import _check_kernel_supported
from gcpnet_torch.utils.torch_compat import translate_state_dict
from gcpnet_torch.weights import from_jax_params
from test_torch_golden import KINDS, _load

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts" / "golden"))
import numpy_reference as npref  # noqa: E402

ATOL = 1e-4
FIXTURES = [
    "gcp1_default", "gcp1_frame_gate", "gcp1_sigma_frame_gate", "gcp1_scalar_out", "gcp2_frame_gate", "gcp2_e3",
    "gcp2_vector_from_zero",
]
GATED = dict(vector_gate=False, nonlinearities=("relu", "sigmoid"))
# name -> (GCP class, input dims, output dims, settings)
SETTINGS = {
    "gcp2_frame_gate": ("GCP2", (12, 4), (10, 3), dict(frame_gate=True, **GATED)),
    "gcp2_e3": ("GCP2", (12, 4), (10, 3), dict(enable_e3_equivariance=True)),
    "gcp2_e3_frame_gate": ("GCP2", (12, 4), (10, 3), dict(enable_e3_equivariance=True, frame_gate=True, **GATED)),
    "gcp2_ablate_scalars": ("GCP2", (12, 4), (10, 3), dict(ablate_scalars=True)),
    "gcp2_ablate_vectors": ("GCP2", (12, 4), (10, 3), dict(ablate_vectors=True)),
    "gcp2_ablate_scalars_scalar_out": ("GCP2", (12, 4), (10, 0), dict(ablate_scalars=True)),
    "gcp2_scalar_input": ("GCP2", (12, 0), (10, 3), dict()),
    "gcp1_default": ("GCP", (12, 4), (10, 3), dict()),
    "gcp1_sigma_frame_gate": ("GCP", (12, 4), (10, 3), dict(sigma_frame_gate=True, **GATED)),
    "gcp1_frame_gate_residual": ("GCP", (12, 4), (10, 3), dict(frame_gate=True, vector_frame_residual=True, **GATED)),
    "gcp1_norm_gate": ("GCP", (12, 4), (10, 3), dict(vector_gate=False, nonlinearities=("relu", "relu"))),
    "gcp1_scalar_out": ("GCP", (12, 4), (10, 0), dict()),
    "gcp1_e3": ("GCP", (12, 4), (10, 3), dict(enable_e3_equivariance=True)),
    "gcp1_ablate_frames": ("GCP", (12, 4), (10, 3), dict(ablate_frame_updates=True)),
    "gcp1_ablations": ("GCP", (12, 4), (10, 3), dict(ablate_scalars=True, ablate_vectors=True)),
    "gcp1_scalar_input": ("GCP", (12, 0), (10, 3), dict()),
}


def gen():
    return torch.Generator().manual_seed(0)


# --- the reference's fixtures --------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_gcp_family_fixture(name):
    meta, ins, sd, outs = _load(name)
    with torch.no_grad():
        KINDS[meta["kind"]](meta, ins, sd, outs)


def test_geometry_e3_fixture():
    meta, ins, _, outs = _load("geometry")
    n = meta["N"]
    ei = ins["edge_index"].astype(np.int64)
    senders, receivers = torch.from_numpy(ei[0]), torch.from_numpy(ei[1])
    fr = frames.localize(t(ins["x"]), senders, receivers, norm_x_diff=True)
    node = frames.scalarize(pack_vector(t(ins["v9"])), frames.NodeFrames(fr, senders, n), e3=True)
    edge = frames.scalarize(pack_vector(t(ins["e9"])), fr, e3=True)
    np.testing.assert_allclose(np_(node), outs["scalarize_node_e3"], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(np_(edge), outs["scalarize_edge_e3"], atol=ATOL, rtol=ATOL)


def test_torch_compat_copy_names_gcp1_weights():
    """The port's copy of the state-dict translation gives GCP v1's stage-2
    weights the port's attribute names (the fixture loads strictly)."""
    _, _, sd, _ = _load("gcp1_frame_gate")
    names = set(from_jax_params(translate_state_dict(sd)))
    assert {"scalar_out_frames.kernel", "vector_out_scale_frames.kernel", "vector_up_frames.kernel"} <= names
    _, _, sd, _ = _load("gcp1_sigma_frame_gate")
    assert "vector_out_scale_sigma_frames.bias" in from_jax_params(translate_state_dict(sd))


# --- every setting against flax on random weights -------------------------------


@pytest.fixture(scope="module")
def node_graph():
    """A padded, receiver-sorted port batch of two graphs (its senders in
    their sorted form), its edge frames, and numerator and count masks that
    differ (a node mask's numerators, every real edge counted)."""
    rng = np.random.default_rng(21)
    graphs = random_graphs(rng, num_graphs=2, nodes=12, edges=40)
    batch = next(batches_from_dataset([GraphData(**g) for g in graphs], Bucket(30, 96, 3),
                                      extra_graph_keys=("label",))).to("cpu")
    fr = frames.localize(batch.x, batch.senders, batch.receivers, edge_mask=batch.edge_pad_mask)
    node_mask = torch.from_numpy(rng.random(batch.num_nodes) > 0.2)
    edge_mask = batch.edge_pad_mask & node_mask[batch.senders] & node_mask[batch.receivers]
    return batch, fr, edge_mask, batch.edge_pad_mask


def _cfg(cls_name):
    return ModuleCfg(selected_gcp=cls_name), JModuleCfg(selected_gcp=cls_name)


def _rep(rng, rows, dims):
    s = rng.normal(size=(rows, dims[0])).astype(np.float32)
    v = rng.normal(size=(rows, 3 * dims[1])).astype(np.float32)
    return s, v


def _assert_out(got, want, label):
    if isinstance(want, jprim.ScalarVector):
        np.testing.assert_allclose(np_(got.scalar), np.asarray(want.scalar), atol=ATOL, err_msg=label + " scalar")
        np.testing.assert_allclose(np_(got.vector), np.asarray(want.vector), atol=ATOL, err_msg=label + " vector")
    else:
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL, err_msg=label)


def _objective(out, cot_s, cot_v):
    """A scalar of an output: its dot with fixed cotangents."""
    if isinstance(out, tuple):
        return (out[0] * cot_s).sum() + (out[1] * cot_v).sum()
    return (out * cot_s).sum()


@pytest.mark.parametrize("rows", ["edge", "node"])
@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_gcp_setting_matches_flax(case, rows, node_graph):
    cls_name, dims_in, dims_out, overrides = SETTINGS[case]
    cfg, jcfg = _cfg(cls_name)
    rng = np.random.default_rng(sorted(SETTINGS).index(case))
    if rows == "edge":
        n = 30
        fr_np = rng.normal(size=(n, 9)).astype(np.float32)
        mask_np = rng.random(n) > 0.2
        idx = np.zeros(n, np.int32)
        jkw = dict(node_inputs=False, edge_mask=jnp.asarray(mask_np))
        jargs = (idx, idx, jnp.asarray(fr_np))
        port_frames, port_mask = t(fr_np), t(mask_np)
    else:
        batch, fr, edge_mask, count_mask = node_graph
        n = batch.num_nodes
        snd, rcv = np.asarray(batch.senders, np.int32), np.asarray(batch.receivers, np.int32)
        jfr, jem, jcm = jnp.asarray(np_(fr)), jnp.asarray(edge_mask.numpy()), jnp.asarray(count_mask.numpy())
        nf = jframes.node_mean_frames(jfr, snd, n, jem, jcm)
        jkw = dict(node_inputs=True, edge_mask=jem, count_mask=jcm, node_frames=nf)
        jargs = (snd, rcv, jfr)
        port_frames = frames.NodeFrames(fr, batch.sender_index(), n, edge_mask, count_mask)
        port_mask = None
    s, v = _rep(rng, n, dims_in)
    out_rows = dims_out
    cot_s = rng.normal(size=(n, out_rows[0])).astype(np.float32)
    cot_v = rng.normal(size=(n, 3 * out_rows[1])).astype(np.float32)

    jmod = jgcp.make_gcp(dims_in, dims_out, jcfg, **overrides)

    def jrep(s_, v_):
        return jprim.ScalarVector(s_, v_) if dims_in[1] else s_

    variables = jmod.init(jax.random.key(1), jrep(jnp.asarray(s), jnp.asarray(v)), *jargs, **jkw)
    variables = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype), variables)

    def jloss(p, s_, v_):
        return _objective(jmod.apply(p, jrep(s_, v_), *jargs, **jkw), cot_s, cot_v)

    want = jmod.apply(variables, jrep(jnp.asarray(s), jnp.asarray(v)), *jargs, **jkw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(variables, jnp.asarray(s), jnp.asarray(v))

    port = load_jax_params(make_gcp(dims_in, dims_out, cfg, generator=gen(), device="cpu", **overrides), variables)
    ts, tv = t(s).requires_grad_(), t(v).requires_grad_()
    got = port(ScalarVector(ts, tv) if dims_in[1] else ts, port_frames, port_mask)
    _assert_out(got, want, case)
    objective = _objective(got, t(cot_s), t(cot_v))
    if objective.requires_grad:  # both channels ablated: a constant zero
        objective.backward()
    want_grads = from_jax_params(jgrads[0])
    got_grads = {name: p.grad for name, p in port.named_parameters()}
    assert got_grads.keys() == want_grads.keys()
    for name, g in got_grads.items():
        want_g = want_grads[name].numpy()
        np.testing.assert_allclose(np_(g) if g is not None else np.zeros_like(want_g), want_g, atol=ATOL,
                                   err_msg=name)
    for x, want_x, label in ((ts, jgrads[1], "d scalars"), (tv, jgrads[2], "d vectors")):
        got_x = np.zeros(x.shape, np.float32) if x.grad is None else np_(x.grad)
        np.testing.assert_allclose(got_x, np.asarray(want_x), atol=ATOL, err_msg=label)


@pytest.mark.parametrize("setting", ["ablate_scalars", "ablate_vectors"])
def test_ablation_zeroes_its_channel(setting, node_graph):
    """An ablated GCP's output channel is zero whatever its input."""
    batch, fr, edge_mask, count_mask = node_graph
    rng = np.random.default_rng(3)
    s, v = _rep(rng, batch.num_nodes, (12, 4))
    for cls_name in ("GCP", "GCP2"):
        module = make_gcp((12, 4), (10, 3), _cfg(cls_name)[0], generator=gen(), device="cpu", **{setting: True})
        out = module(ScalarVector(t(s), t(v)), frames.NodeFrames(fr, batch.sender_index(), batch.num_nodes,
                                                                 edge_mask, count_mask))
        zero, kept = (out.scalar, out.vector) if setting == "ablate_scalars" else (out.vector, out.scalar)
        assert torch.count_nonzero(zero) == 0 and torch.count_nonzero(kept) > 0, cls_name


# --- inputs without vector channels -----------------------------------------------


@pytest.mark.parametrize("without", ["node", "edge", "both"])
def test_embedding_without_vectors_matches_flax(without):
    rng = np.random.default_rng(8)
    node_v = 0 if without in ("node", "both") else 2
    edge_v = 0 if without in ("edge", "both") else 1
    graphs = random_graphs(rng, num_graphs=2, nodes=12, edges=40)
    for g in graphs:
        g["chi"], g["xi"] = g["chi"][:, :node_v], g["xi"][:, :edge_v]
    host = next(batches_from_dataset([GraphData(**g) for g in graphs], Bucket(30, 96, 3), extra_graph_keys=("label",)))
    jb, batch = jax_batch(host), host.to("cpu")
    fr = frames.localize(batch.x, batch.senders, batch.receivers, edge_mask=batch.edge_pad_mask)
    jfr = jnp.asarray(np_(fr))
    dims = dict(edge_input_dims=(16, edge_v), node_input_dims=(9, node_v), edge_hidden_dims=(8, 4),
                node_hidden_dims=(16, 4))
    jmod = JGCPEmbedding(**dims, cfg=JModuleCfg(), num_atom_types=9)
    masks = (jb.edge_pad_mask, jb.edge_pad_mask)
    variables = jmod.init(jax.random.key(4), jb, jfr, *masks)
    jn, je = jmod.apply(variables, jb, jfr, *masks)
    port = load_jax_params(GCPEmbedding(*dims.values(), ModuleCfg(), num_atom_types=9, generator=gen(),
                                        device="cpu"), variables)
    tn, te = port(batch, fr, batch.edge_pad_mask, batch.edge_pad_mask)
    for got, want, label in ((tn, jn, "node"), (te, je, "edge")):
        _assert_out(got, want, label)


# --- whole models ----------------------------------------------------------------


def jax_batch(batch) -> JGraphBatch:
    """The port's host batch as the JAX package's (the same arrays), without
    row splits (the JAX model's plain path)."""
    fields = {name: getattr(batch, name) for name in (
        "h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id", "node_pad_mask", "edge_pad_mask",
        "graph_pad_mask", "node_mask", "extras")}
    return to_jax(JGraphBatch(**fields, edge_row_splits=None))


def _grads_match(model, jgrads):
    want = from_jax_params(jgrads)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(np_(g) if g is not None else np.zeros_like(w), w, atol=ATOL, err_msg=name)


RS_MODEL = dict(
    h_input_dim=52, chi_input_dim=2, e_input_dim=30, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0, dense_dropout=0.0,
)
RS_DATA = dict(batch_size=4, synthetic_sizes={"train": 16, "valid": 16, "test": 16}, max_nodes_per_graph=16)


def _rs_models(e3: bool, seed: int = 0):
    """The small RS model (2 interaction layers of 3-layer stacks) in both
    packages, the port's with the flax weights: (jax model, params, port)."""
    rs_dm = rs.RSDataModule(**RS_DATA)
    rs_dm.setup()
    host = next(rs_dm.val_batches())
    jmodel = JGCPNetRS(
        model_cfg=JModelCfg(**RS_MODEL), module_cfg=JModuleCfg(scalar_nonlinearity="leakyrelu",
                                                                enable_e3_equivariance=e3),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=3)),
    )
    params = jmodel.init(jax.random.key(seed), jax_batch(host), True)
    port = load_jax_params(GCPNetRS(
        ModelCfg(**RS_MODEL), ModuleCfg(scalar_nonlinearity="leakyrelu", enable_e3_equivariance=e3),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=3)), generator=gen(), device="cpu",
    ), params)
    return rs_dm, host, jmodel, params, port


def test_rs_e3_matches_jax():
    _, host, jmodel, params, port = _rs_models(e3=True)
    jb, batch = jax_batch(host), host.to("cpu")

    def jloss(p):
        logits = jmodel.apply(p, jb, True)
        return jrs_loss(logits, jb)[0], logits

    (want_loss, want_logits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    logits = port(batch)
    np.testing.assert_allclose(np_(logits), np.asarray(want_logits), atol=ATOL)
    loss, _ = rs_loss(logits, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    loss.backward()
    _grads_match(port, jgrads)


# a pair's logits agree when |a - b| <= PAIR_ATOL * max(1, |a|, |b|)
PAIR_ATOL = 1e-4


def pair_gaps(logits: np.ndarray) -> np.ndarray:
    """Each pair's logit gap over the pair's magnitude (at least 1)."""
    pairs = logits.reshape(-1, 2)
    return np.abs(pairs[:, 0] - pairs[:, 1]) / np.maximum(np.abs(pairs).max(axis=1), 1.0)


def test_rs_mirrored_pairs():
    """With the same weights, E(3) mode gives both enantiomers of every pair
    the same logit within PAIR_ATOL; SE(3) mode tells them apart (the
    median pair's gap over the bound, the largest ten times over: with
    random weights a pair's chirality signal can be small)."""
    rs_dm = rs.RSDataModule(**RS_DATA)
    rs_dm.setup()
    batch = next(rs_dm.batches("test")).to("cpu")
    real = int(batch.graph_pad_mask.sum())
    assert real % 2 == 0 and real >= 4
    gaps = {}
    for e3 in (True, False):
        model = GCPNetRS(
            ModelCfg(**RS_MODEL), ModuleCfg(scalar_nonlinearity="leakyrelu", enable_e3_equivariance=e3),
            LayerCfg(mp_cfg=MPCfg(num_message_layers=3)), generator=gen(), device="cpu",
        )
        with torch.no_grad():
            gaps[e3] = pair_gaps(model(batch).numpy()[:real])
    assert gaps[True].max() <= PAIR_ATOL, gaps[True]
    assert np.median(gaps[False]) > PAIR_ATOL and gaps[False].max() > 10 * PAIR_ATOL, gaps[False]


def test_rs_e3_matches_numpy_reference():
    """``tests/test_model_golden.py``'s RS case on the port: two graphs,
    padded and receiver-sorted by the port's batching, against the
    unpadded float64 numpy reference."""
    rng = np.random.default_rng(11)
    graphs = [
        GraphData(
            h=rng.normal(size=(10, 7)).astype(np.float32), chi=rng.normal(size=(10, 2, 3)).astype(np.float32),
            e=rng.normal(size=(30, 8)).astype(np.float32), xi=rng.normal(size=(30, 1, 3)).astype(np.float32),
            x=(rng.normal(size=(10, 3)) * 4).astype(np.float32),
            senders=rng.integers(0, 10, size=30).astype(np.int32),
            receivers=rng.integers(0, 10, size=30).astype(np.int32), extras={"label": np.float32(0.0)},
        )
        for _ in range(2)
    ]
    host = next(batches_from_dataset(graphs, Bucket(27, 73, 3), extra_graph_keys=("label",)))
    cfg = dict(h_input_dim=7, chi_input_dim=2, e_input_dim=8, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
               e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0)
    jmodel = JGCPNetRS(model_cfg=JModelCfg(**cfg), module_cfg=JModuleCfg(enable_e3_equivariance=True),
                       layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=3)))
    params = jax.jit(lambda b: jmodel.init(jax.random.key(4), b, True))(jax_batch(host))
    port = load_jax_params(GCPNetRS(
        ModelCfg(**cfg), ModuleCfg(enable_e3_equivariance=True), LayerCfg(mp_cfg=MPCfg(num_message_layers=3)),
        generator=gen(), device="cpu",
    ), params)
    with torch.no_grad():
        out = port(host.to("cpu")).numpy()[:2]
    h, chi, e, xi, x, row, col, bidx = _concat_for_numpy(graphs)
    want = npref.lba_forward(
        jax.device_get(params)["params"], h, chi, e, xi, x, row, col, bidx, 2,
        num_atom_types=0, node_in_dims=(7, 2), edge_in_dims=(8, 1), node_dims=(16, 4), edge_dims=(8, 4),
        num_layers=2, num_message_layers=3, dense_activation="leakyrelu", gcp_kwargs={"e3": True},
    )
    np.testing.assert_allclose(out, want, atol=ATOL)


def _concat_for_numpy(graphs):
    """Unpadded concatenation in the reference's batch layout (float64)."""
    cat = lambda key: np.concatenate([getattr(g, key) for g in graphs]).astype(np.float64)  # noqa: E731
    off = np.cumsum([0] + [g.num_nodes for g in graphs])
    row = np.concatenate([g.senders + o for g, o in zip(graphs, off)])
    col = np.concatenate([g.receivers + o for g, o in zip(graphs, off)])
    bidx = np.concatenate([np.full(g.num_nodes, i) for i, g in enumerate(graphs)])
    return cat("h"), cat("chi"), cat("e"), cat("xi"), cat("x"), row, col, bidx


LBA_MODEL = dict(
    chi_input_dim=2, e_input_dim=16, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8,
    xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0, dense_dropout=0.0,
)
# chip_smoke's gcp-family runs, at a small width
LBA_SETTINGS = {
    "ablate_frame_updates": dict(ablate_frame_updates=True),
    "ablate_scalars": dict(ablate_scalars=True),
    "ablate_vectors": dict(ablate_vectors=True),
    "gcp1_sigma_frame_gate": dict(selected_gcp="GCP", sigma_frame_gate=True, vector_gate=False),
    "gcp2_frame_gate": dict(frame_gate=True, vector_gate=False),
}


@pytest.mark.parametrize("setting", sorted(LBA_SETTINGS))
def test_lba_setting_matches_jax(setting):
    """GCPNetLBA (2 interaction layers of 3-layer stacks) with the setting
    in every GCP, on a receiver-sorted batch: predictions, loss and every
    gradient against the JAX model."""
    kw = LBA_SETTINGS[setting]
    graphs = random_graphs(np.random.default_rng(3), num_graphs=2, nodes=20, edges=70)
    host = port_batch(graphs, sort_tile=1)
    jb, batch = jax_batch(host), host.to("cpu")
    jmodel = JGCPNetLBA(model_cfg=JModelCfg(**LBA_MODEL), module_cfg=JModuleCfg(**kw),
                        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=3)), num_atom_types=9)
    params = jax.jit(lambda b: jmodel.init(jax.random.key(0), b, True))(jb)

    def jloss(p):
        preds = jmodel.apply(p, jb, True)
        return jlba_loss(preds, jb)[0], preds

    (want_loss, want_preds), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    port = load_jax_params(GCPNetLBA(
        ModelCfg(**LBA_MODEL), ModuleCfg(**kw), LayerCfg(mp_cfg=MPCfg(num_message_layers=3)), num_atom_types=9,
        generator=gen(), device="cpu",
    ), params)
    assert not any(layer.interaction.fast_supported for layer in
                   (getattr(port.encoder, f"interaction_{i}") for i in range(2)))
    preds = port(batch)
    np.testing.assert_allclose(np_(preds), np.asarray(want_preds), atol=ATOL)
    loss, _ = graph_regression_loss(preds, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL, rtol=ATOL)
    loss.backward()
    _grads_match(port, jgrads)


NODE_DIMS, EDGE_DIMS = (16, 4), (8, 4)


def _golden_graphs(rng, ds, dv, de, dve, n=10, e=30, **extra):
    return [
        GraphData(
            h=rng.normal(size=(n, ds)).astype(np.float32), chi=rng.normal(size=(n, dv, 3)).astype(np.float32),
            e=rng.normal(size=(e, de)).astype(np.float32), xi=rng.normal(size=(e, dve, 3)).astype(np.float32),
            x=(rng.normal(size=(n, 3)) * 4).astype(np.float32),
            senders=rng.integers(0, n, size=e).astype(np.int32), receivers=rng.integers(0, n, size=e).astype(np.int32),
            **{k: f(rng) for k, f in extra.items()},
        )
        for _ in range(2)
    ]


def test_nms_force_term_matches_numpy_reference():
    """``tests/test_model_golden.py:126`` on the port: NMS with the force
    term (``ablate_x_force_update=False``)."""
    graphs = _golden_graphs(np.random.default_rng(12), 1, 3, 8, 1, extras=lambda r: {"label": np.float32(0.0)})
    host = next(batches_from_dataset(graphs, Bucket(27, 73, 3), extra_graph_keys=("label",)))
    batch = host.to("cpu")
    cfg = dict(h_input_dim=1, chi_input_dim=3, e_input_dim=8, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
               e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0)
    jmodel = JGCPNetNMS(model_cfg=JModelCfg(**cfg), module_cfg=JModuleCfg(ablate_x_force_update=False),
                        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2)))
    params = jax.jit(lambda b: jmodel.init(jax.random.key(3), b, True))(jax_batch(host))
    port = load_jax_params(GCPNetNMS(
        ModelCfg(**cfg), ModuleCfg(ablate_x_force_update=False), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
        generator=gen(), device="cpu",
    ), params)
    assert hasattr(port.encoder.interaction_0, "phi_force_ij_kernel")
    with torch.no_grad():
        out = port(batch).numpy()
    h, chi, e, xi, x, row, col, bidx = _concat_for_numpy(graphs)
    want = npref.nms_forward(
        jax.device_get(params)["params"], h, chi, e, xi, x, row, col, bidx, 2, node_in_dims=(1, 3),
        edge_in_dims=(8, 1), node_dims=NODE_DIMS, edge_dims=EDGE_DIMS, num_layers=2, num_message_layers=2,
        ablate_x_force_update=False,
    )
    np.testing.assert_allclose(out[batch.node_pad_mask.numpy()], want, atol=ATOL)


def test_cpd_node_mask_matches_numpy_reference():
    """``tests/test_model_golden.py:235`` on the port: the CPD encoder and
    autoregressive decoder with a real node mask."""
    n = 14
    rng = np.random.default_rng(13)
    graphs = _golden_graphs(
        rng, 6, 3, 32, 1, n=n, e=n * 4,
        node_mask=lambda r: r.random(n) > 0.15, extras=lambda r: {"seq": r.integers(0, 20, size=n).astype(np.int32)},
    )
    host = next(batches_from_dataset(graphs, Bucket(n * 2 + 6, n * 8 + 10, 3)))
    batch = host.to("cpu")
    cfg = dict(h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2,
               num_decoder_layers=2, output_dim=20, dropout=0.0)
    jmodel = JGCPNetCPD(model_cfg=JModelCfg(**cfg), module_cfg=JModuleCfg(),
                        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2)), node_input_dims=(6, 3),
                        edge_input_dims=(32, 1), autoregressive_decoder=True)
    params = jax.jit(lambda b: jmodel.init(jax.random.key(7), b, True))(jax_batch(host))
    port = load_jax_params(GCPNetCPD(
        ModelCfg(**cfg), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)), node_input_dims=(6, 3),
        edge_input_dims=(32, 1), autoregressive_decoder=True, generator=gen(), device="cpu",
    ), params)
    with torch.no_grad():
        logits = port(batch).numpy()
    h, chi, e, xi, x, row, col, bidx = _concat_for_numpy(graphs)
    seq = np.concatenate([g.extras["seq"] for g in graphs])
    node_mask = np.concatenate([g.node_mask for g in graphs]).astype(bool)
    want = npref.cpd_forward(
        jax.device_get(params)["params"], h, chi, e, xi, x, seq, row, col, bidx, 2, node_in_dims=(6, 3),
        edge_in_dims=(32, 1), node_dims=NODE_DIMS, edge_dims=EDGE_DIMS, vocab=20, num_encoder_layers=2,
        num_decoder_layers=2, num_message_layers=2, node_mask=node_mask,
    )
    real = batch.node_pad_mask.numpy()
    np.testing.assert_allclose(logits[real][node_mask], want[node_mask], atol=ATOL)


# --- the config-driven build -------------------------------------------------------

ABLATION_EXPERIMENTS = sorted(p.stem for p in Path(CONFIG_DIR, "experiment").glob("*_ablations.yaml"))
SMALL = [
    "model.model_cfg.h_hidden_dim=8", "model.model_cfg.chi_hidden_dim=4", "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=4", "model.model_cfg.num_encoder_layers=1", "model.model_cfg.num_decoder_layers=1",
    "model.layer_cfg.mp_cfg.num_message_layers=2",
]
FLIPS = [
    ["model.module_cfg.ablate_frame_updates=true"], ["model.module_cfg.ablate_scalars=true"],
    ["model.module_cfg.ablate_vectors=true"], ["model.module_cfg.enable_e3_equivariance=true"],
    ["model.module_cfg.frame_gate=true", "model.module_cfg.vector_gate=false"],
    ["model.module_cfg.selected_GCP._target_=gcpnet_tpu.nn.gcp.GCP", "model.module_cfg.sigma_frame_gate=true",
     "model.module_cfg.vector_gate=false"],
]


@pytest.mark.parametrize("experiment", ABLATION_EXPERIMENTS)
def test_build_model_builds_every_ablation_experiment(experiment):
    """Each ``*_ablations`` experiment composed by the port's loader, with
    each flag flipped, builds its model (small widths) through the port's
    own registry; the GCPs carry the flag, and a flag outside the kernels'
    layer table keeps every message stack off K2/K3."""
    assert len(ABLATION_EXPERIMENTS) == 10
    for flip in FLIPS:
        cfg = compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}", *SMALL, *flip])
        model, name = tasks.build_model(cfg["model"], device="cpu")
        assert name in tasks.TASK_OF_MODEL, name
        gcps = [m for m in model.modules() if hasattr(m, "settings")]
        assert gcps, experiment
        key, value = flip[-1].rsplit("=", 1)
        if key.endswith("vector_gate"):
            key, value = flip[0].rsplit("=", 1)
        field = key.rsplit(".", 1)[-1]
        if field == "_target_":
            assert all(type(m).__name__ == "GCP" for m in gcps), experiment
        else:
            assert all(getattr(m.settings, field) is True for m in gcps), (experiment, field)
        stacks = [m for m in model.modules() if isinstance(m, GCPMessagePassing)]
        assert stacks and not any(mp.fast_supported for mp in stacks), (experiment, flip)


# --- what the kernels' layer table lacks raises --------------------------------------


@pytest.mark.parametrize("flip", ["frame_gate", "sigma_frame_gate", "enable_e3_equivariance", "ablate_frame_updates",
                                  "ablate_scalars", "ablate_vectors", "GCP v1"])
def test_check_kernel_supported_names_each_setting(flip):
    cfg = ModuleCfg(selected_gcp="GCP") if flip == "GCP v1" else ModuleCfg(**{flip: True})
    mp = GCPMessagePassing((16, 4), (16, 4), (8, 4), cfg, LayerCfg(mp_cfg=MPCfg(num_message_layers=3)),
                           generator=gen(), device="cpu")
    assert not mp.fast_supported
    assert all(flip in kernel_outside(m) for m in mp.stack)
    with pytest.raises(NotImplementedError, match=flip):
        _check_kernel_supported(mp.packed_stack())
    plain = GCPMessagePassing((16, 4), (16, 4), (8, 4), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=3)),
                              generator=gen(), device="cpu")
    assert plain.fast_supported
    _check_kernel_supported(plain.packed_stack())
