"""The port's RS slice against the JAX package, on the CPU.

- Leaky relu follows ``jax.nn.leaky_relu`` at exactly 0 (gradient 1, not
  the slope) and keeps a NaN, in the activation table and in the plain
  version of the message stack (K2/K3's reference on the CPU).
- Data, exact: ``synthetic_chiral_molecule`` and ``record_to_graph`` array
  for array; the samplers' index order for one seed; the datamodule's
  batches hold the same graphs as the JAX module's (nodes and labels equal,
  edge rows equal after mapping each port row to the JAX row of the same
  (sender, receiver) pair: the port's batches are receiver-sorted).
- The stack with leaky relu (scalar slot, and vector-gate slot too) in one
  message passing layer: its output, and d inputs and every stack weight,
  against the Pallas edge map and its recompute backward (interpret mode),
  fp32 atol 1e-4.
- ``GCPNetRS`` at 2 interaction layers of 3-layer stacks, hidden 16/4/8/4,
  against the JAX model in its fused configuration (Pallas edge map and
  sorted segment sum, interpret mode): logits, ``rs_loss`` and every
  parameter's gradient at fp32 atol 1e-4, with
  ``layer_cfg.nonlinearity_slope = 0.2`` (the stack's slope is the GCP
  settings' 0.01 in both packages; that option reaches only the force term,
  which RS does not run, so the case is the default model's too).
- A 2-epoch fit against the JAX ``Trainer`` (no dropout): per-epoch
  ``train/loss``, ``val/loss``, ``val/Accuracy`` and ``val/F1`` at atol 1e-4;
  and the ``--task rs`` entry point on the CPU.
"""

import json

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
from _torch_parity import load_jax_params, np_, sorted_batch, t, to_jax
from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data import rs as jrs
from gcpnet_tpu.data.batching import sort_edges_by_receiver as jsort_edges
from gcpnet_tpu.models import GCPNetRS as JGCPNetRS
from gcpnet_tpu.models import rs_loss as jrs_loss
from gcpnet_tpu.nn import primitives as jprim
from gcpnet_tpu.nn.primitives import ScalarVector as JScalarVector
from gcpnet_tpu.parallel import make_mesh
from gcpnet_tpu.train import Trainer as JTrainer
from gcpnet_torch import tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import rs
from gcpnet_torch.models.rs import GCPNetRS, rs_loss
from gcpnet_torch.nn import primitives
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import ScalarVector
from gcpnet_torch.ops.edge_map import StackLayer, edge_map, edge_map_backward, pack_stack
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.trainer import Trainer
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4
# the small RS configuration: 2 interaction layers of 3-layer message
# stacks, hidden 16/4/8/4, the RS input widths (52 node scalars, 2
# orientation vectors, 30 edge scalars, 1 edge vector)
RS_MODEL = dict(
    h_input_dim=52, chi_input_dim=2, e_input_dim=30, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0, dense_dropout=0.0,
)
RS_MESSAGE_LAYERS = 3
# 4 anchors a batch: buckets of 8 graphs, 512 nodes, 1,024 edges (the
# JAX module's 64 nodes a graph); the model tests take 16 nodes a graph
# (a synthetic molecule has 11 atoms): 128 nodes, 256 edges
DATA = dict(batch_size=4, synthetic_sizes={"train": 32, "valid": 16, "test": 16})
SMALL_BUCKET = dict(DATA, max_nodes_per_graph=16)


# --- leaky relu at 0 ---------------------------------------------------------


def test_leaky_relu_at_zero_follows_jax():
    x = np.asarray([-1.0, 0.0, 1.0], np.float32)
    for slope in (0.01, 0.2):
        want = jax.vmap(jax.grad(lambda v: jprim.get_nonlinearity("leakyrelu", slope)(v)))(jnp.asarray(x))
        xt = t(x).requires_grad_()
        primitives.get_nonlinearity("leakyrelu", slope)(xt).sum().backward()
        np.testing.assert_array_equal(np_(xt.grad), np.asarray(want))
        assert xt.grad[1] == 1.0
        nan = primitives.get_nonlinearity("leakyrelu", slope)(torch.tensor([float("nan"), -2.0]))
        want_nan = np.asarray(jprim.get_nonlinearity("leakyrelu", slope)(jnp.asarray([np.nan, -2.0])))
        assert torch.isnan(nan[0]) and np.isnan(want_nan[0]) and nan[1].item() == pytest.approx(want_nan[1])
    # the plain stack (K3's reference): a pre-activation of exactly 0 (zero
    # weights and biases) passes its cotangent on whole, so the scalar bias's
    # gradient is the cotangent's column sum
    layer = StackLayer(
        w_down=torch.zeros(2, 4 + 3), w_so=torch.zeros(3 + 4 + 9, 3), b_so=torch.zeros(3), w_up=torch.zeros(4, 2),
        w_gate=None, b_gate=None, act_s="leakyrelu", act_v=None, slope=0.01, vector_residual=False,
    )
    stack = pack_stack([layer], residual=False)
    message = torch.randn(5, stack.in_dim, generator=torch.Generator().manual_seed(0))
    grad_out = torch.randn(5, stack.out_dim, generator=torch.Generator().manual_seed(1))
    _, d_w = edge_map_backward(message, torch.zeros(5, 9), stack, grad_out)
    b_so = stack.layer_weights(d_w)[0]["b_so"]
    torch.testing.assert_close(b_so, grad_out[:, :3].sum(0))


# --- data --------------------------------------------------------------------


def _assert_graphs_equal(got, want, msg=""):
    for name in ("h", "chi", "e", "xi", "x", "senders", "receivers", "node_mask"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=f"{msg} {name}")
    assert got.extras.keys() == want.extras.keys()
    for key in got.extras:
        np.testing.assert_array_equal(got.extras[key], want.extras[key], err_msg=f"{msg} {key}")


@pytest.mark.parametrize("stereo_mask", [True, False])
def test_synthetic_molecule_matches_jax(stereo_mask):
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        want = jrs.synthetic_chiral_molecule(rng_j, stereo_mask=stereo_mask)
        got = rs.synthetic_chiral_molecule(rng_t, stereo_mask=stereo_mask)
        for g, w in zip(got, want):
            _assert_graphs_equal(g, w)
        assert {float(g.extras["label"]) for g in got} == {0.0, 1.0}
        assert got[0].h.shape[1] == 52 and got[0].e.shape[1] == 30


def _record(rng: np.random.Generator) -> dict:
    """A hand-built record (tests/test_rs_samplers.py's schema) with every
    kind of atom and bond feature, chiral tags and bond stereo set."""
    n = 6
    symbols = ["C", "N", "O", "Cl", "Xe", "H"]
    hybrid = ["SP3", "SP2", "SP", "S", "OTHER", "UNSPECIFIED"]
    tags = ["R", "S", None, "?", None, "R"]
    atoms = [
        dict(symbol=symbols[i], degree=i, charge=i - 2, num_hs=i % 5, hybridization=hybrid[i], aromatic=i % 2 == 0,
             mass=float(rng.uniform(1, 40)), global_tag=tags[i], chiral_tag=i % 4)
        for i in range(n)
    ]
    bond_types = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC", "DATIVE"]
    pairs = [(1, 0), (2, 1), (3, 2), (3, 4), (5, 0)]
    bonds = [
        dict(i=i, j=j, type=bond_types[k], conjugated=k % 2 == 1, in_ring=k % 3 == 0, stereo=k)
        for k, (i, j) in enumerate(pairs)
    ]
    return {"coords": rng.normal(size=(n, 3)).astype(np.float32) * 1.5, "atoms": atoms, "bonds": bonds}


@pytest.mark.parametrize("stereo_mask", [True, False])
def test_record_to_graph_matches_jax(stereo_mask):
    record = _record(np.random.default_rng(2))
    want = jrs.record_to_graph(record, stereo_mask=stereo_mask, label=1.0)
    got = rs.record_to_graph(record, stereo_mask=stereo_mask, label=1.0)
    _assert_graphs_equal(got, want)
    assert got.h.shape == (6, 52) and got.e.shape == (10, 30)
    assert got.h[:, -9:].any() != stereo_mask


# 2 molecules x 2 stereoisomers x {1, 2, 3} conformers
IDS = ["m1-R", "m1-R", "m1-S", "m1-S", "m1-S", "m2-R", "m2-R", "m2-S", "m3-R", "m3-S", "m3-S"]
SMILES = ["m1"] * 5 + ["m2"] * 3 + ["m3"] * 3


@pytest.mark.parametrize("seed", [0, 5])
def test_samplers_match_jax(seed):
    anchors = [0, 2, 5, 7, 8, 9]
    for num_pos, num_neg in ((0, 1), (1, 2)):
        want = list(jrs.SingleConformerBatchSampler(anchors, IDS, SMILES, 2, num_pos=num_pos, num_neg=num_neg,
                                                    seed=seed))
        got = list(rs.SingleConformerBatchSampler(anchors, IDS, SMILES, 2, num_pos=num_pos, num_neg=num_neg,
                                                  seed=seed))
        assert got == want and len(got) == 3
    want = list(jrs.NegativeBatchSampler(IDS, SMILES, 3, num_neg=1, seed=seed))
    got = list(rs.NegativeBatchSampler(IDS, SMILES, 3, num_neg=1, seed=seed))
    assert got == want and len(got) == 3
    for stratified in (True, False):
        for replace in (True, False):
            rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
            jneg, neg = jrs.SampleMapToNegatives(IDS, SMILES), rs.SampleMapToNegatives(IDS, SMILES)
            for i in range(len(IDS)):
                assert neg.sample(i, rt, N=2, without_replacement=not replace, stratified=stratified) == \
                    jneg.sample(i, rj, N=2, without_replacement=not replace, stratified=stratified)


def _datamodules(**kw):
    kw = {**DATA, **kw}
    jdm, dm = jrs.RSDataModule(**kw), rs.RSDataModule(**kw)
    jdm.setup()
    dm.setup()
    return jdm, dm


def _jax_row_of_port_row(jbatch, batch) -> np.ndarray:
    jrows = {(int(s), int(r)): i for i, (s, r, m) in enumerate(
        zip(jbatch.senders, jbatch.receivers, jbatch.edge_pad_mask)) if m}
    real = np.asarray(batch.edge_pad_mask)
    return np.asarray([jrows[(int(s), int(r))] for s, r in zip(batch.senders[real], batch.receivers[real])])


def _assert_batches_hold_the_same_graphs(jbatches, batches, split):
    jbatches, batches = list(jbatches), list(batches)
    assert len(batches) == len(jbatches) > 0, split
    for jb, b in zip(jbatches, batches):
        assert (b.num_nodes, b.num_edges, b.num_graphs) == (jb.num_nodes, jb.num_edges, jb.num_graphs)
        for name in ("h", "chi", "x", "graph_id", "node_pad_mask", "graph_pad_mask", "node_mask"):
            np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(jb, name)), err_msg=f"{split} {name}")
        np.testing.assert_array_equal(b.extras["label"], np.asarray(jb.extras["label"]), err_msg=split)
        rows = _jax_row_of_port_row(jb, b)
        assert sorted(rows) == list(np.flatnonzero(np.asarray(jb.edge_pad_mask)))
        real = np.asarray(b.edge_pad_mask)
        np.testing.assert_array_equal(b.e[real], np.asarray(jb.e)[rows], err_msg=split)
        np.testing.assert_array_equal(b.xi[real], np.asarray(jb.xi)[rows], err_msg=split)
        # receiver-sorted with CSR splits over the real rows
        assert np.all(np.diff(b.receivers[real]) >= 0) and b.edge_row_splits[-1] == real.sum()


@pytest.mark.parametrize("iteration_mode", ["stereoisomers", "conformers"])
def test_datamodule_batches_match_jax(iteration_mode):
    jdm, dm = _datamodules(iteration_mode=iteration_mode)
    for split in ("train", "valid", "test"):
        for jg, g in zip(jdm.graphs[split], dm.graphs[split]):
            _assert_graphs_equal(g, jg, split)
        assert dm.meta[split]["ids"] == jdm.meta[split]["ids"]
        assert dm.meta[split]["single_idx"] == jdm.meta[split]["single_idx"]
    for seed in (0, 1):
        _assert_batches_hold_the_same_graphs(jdm.train_batches(seed), dm.train_batches(seed), f"train {seed}")
    _assert_batches_hold_the_same_graphs(jdm.val_batches(), dm.val_batches(), "valid")
    _assert_batches_hold_the_same_graphs(jdm.test_batches(), dm.test_batches(), "test")
    b = next(dm.train_batches(0))
    assert dm.bucket() == rs.Bucket(num_nodes=512, num_edges=1024, num_graphs=8)
    assert b.graph_pad_mask.all()  # a paired batch: 4 anchors and their enantiomers


def test_pickle_split_loads_and_unreadable_file_raises(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(0)
    rows = [
        dict(ID=f"m{p}-{tag}", SMILES_nostereo=f"m{p}", RS_label_binary=float(p % 2), record=_record(rng))
        for p in range(3) for tag in "RS"
    ]
    path = tmp_path / "train.pkl"
    pd.DataFrame(rows).to_pickle(path)
    kw = dict(train_data_filepath=str(path), val_data_filepath=str(tmp_path / "absent.pkl"))
    jdm, dm = jrs.RSDataModule(**DATA, **kw), rs.RSDataModule(**DATA, **kw)
    jdm.setup()
    dm.setup()
    assert len(dm.graphs["train"]) == 6 and len(dm.graphs["valid"]) == 16  # the absent file: synthetic
    for jg, g in zip(jdm.graphs["train"], dm.graphs["train"]):
        _assert_graphs_equal(g, jg)
    (tmp_path / "bad.pkl").write_bytes(b"not a pickle")
    with pytest.raises(Exception):
        rs.RSDataModule(train_data_filepath=str(tmp_path / "bad.pkl")).setup()


# --- the stack with leaky relu, K2 and K3's plain versions against Pallas ----


def _fused_jax(monkeypatch):
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
    monkeypatch.setattr(jseg, "USE_PALLAS_SEGMENT", True)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)


def test_leaky_stack_matches_pallas_edge_map(rng, monkeypatch):
    """A 3-layer stack with leaky relu on its scalars and in its vector
    gate (``act_v(s) @ Wg``), in one message passing layer (K2 + K3 + K1
    plain): its output, and d inputs and every stack weight, against the
    JAX fused configuration through the Pallas edge map and its recompute
    backward (interpret mode), fp32 atol 1e-4."""
    cfg = dict(scalar_nonlinearity="leakyrelu", vector_nonlinearity="leakyrelu")
    mp_cfg = dict(num_message_layers=RS_MESSAGE_LAYERS)
    batch = sorted_batch(rng, 1, nodes=20, edges=80, bucket_edges=200)
    n, e = batch.num_nodes, batch.num_edges
    inputs = [rng.normal(size=shape).astype(np.float32) for shape in ((n, 16), (n, 12), (e, 8), (e, 12))]
    frames = rng.normal(size=(e, 9)).astype(np.float32)
    cot_s, cot_v = rng.normal(size=(n, 16)).astype(np.float32), rng.normal(size=(n, 12)).astype(np.float32)
    mask = np.asarray(batch.edge_pad_mask)
    jmod = jmp.GCPMessagePassing(
        input_dims=(16, 4), output_dims=(16, 4), edge_dims=(8, 4), cfg=JModuleCfg(**cfg),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(**mp_cfg)),
    )
    jargs = (jnp.asarray(batch.senders), jnp.asarray(batch.receivers), jnp.asarray(frames))
    kw = dict(edge_mask=jnp.asarray(mask), count_mask=jnp.asarray(mask), row_splits=jnp.asarray(batch.edge_row_splits))

    def jloss(params, ns, nv, es, ev):
        out = jmod.apply(params, JScalarVector(ns, nv), JScalarVector(es, ev), *jargs, **kw)
        return jnp.sum(out.scalar * cot_s) + jnp.sum(out.vector * cot_v), out

    variables = jmod.init(jax.random.key(0), JScalarVector(*inputs[:2]), JScalarVector(*inputs[2:]), *jargs, **kw)
    calls = []
    real_edge_map = jpallas_fused.edge_map

    def counting_edge_map(*args):
        calls.append(1)
        return real_edge_map(*args)

    _fused_jax(monkeypatch)
    monkeypatch.setattr(jpallas_fused, "edge_map", counting_edge_map)
    with pltpu.force_tpu_interpret_mode():
        (_, want_out), want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            variables, *map(jnp.asarray, inputs)
        )
    assert calls  # the JAX side ran the Pallas edge map

    port = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), ModuleCfg(**cfg), LayerCfg(mp_cfg=MPCfg(**mp_cfg)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    load_jax_params(port, variables)
    with torch.no_grad():
        stack = port.packed_stack()
    assert "leakyrelu" in {layer.act_s for layer in stack.layers}
    assert "leakyrelu" in {layer.act_v for layer in stack.layers if layer.w_gate is not None}
    assert {layer.slope for layer in stack.layers} == {0.01}
    xs = [t(a).requires_grad_() for a in inputs]
    tb = batch.to("cpu")
    out = port(
        ScalarVector(xs[0], xs[1]), ScalarVector(xs[2], xs[3]), tb.senders, tb.receiver_index(), t(frames),
        edge_mask=tb.edge_pad_mask, count_mask=tb.edge_pad_mask,
    )
    np.testing.assert_allclose(np_(out.scalar), np.asarray(want_out.scalar), atol=ATOL)
    np.testing.assert_allclose(np_(out.vector), np.asarray(want_out.vector), atol=ATOL)
    ((out.scalar * t(cot_s)).sum() + (out.vector * t(cot_v)).sum()).backward()
    grads = from_jax_params(want[0])
    for name, p in port.named_parameters():
        np.testing.assert_allclose(np_(p.grad), grads[name].numpy(), atol=ATOL, err_msg=name)
    for x, w in zip(xs, want[1:]):
        np.testing.assert_allclose(np_(x.grad), np.asarray(w), atol=ATOL)


# --- the RS model ------------------------------------------------------------


# layer_cfg.nonlinearity_slope of the model tests: not the default 0.01, so
# that a port whose stack read it (and not the GCP settings' 0.01, as the
# JAX stack does) would part from the JAX model
LAYER_SLOPE = 0.2


@pytest.fixture(scope="module")
def jax_rs():
    """The JAX RS model in the fused configuration on the JAX datamodule's
    first validation batch, receiver-sorted (CSR), with
    ``layer_cfg.nonlinearity_slope = LAYER_SLOPE``: (params, logits, loss,
    gradient tree)."""
    layer_kw = {"nonlinearity_slope": LAYER_SLOPE}
    jdm = jrs.RSDataModule(**SMALL_BUCKET)
    jdm.setup()
    batch = to_jax(jsort_edges(next(jdm.val_batches()), tile=1))
    model = JGCPNetRS(
        model_cfg=JModelCfg(**RS_MODEL), module_cfg=JModuleCfg(scalar_nonlinearity="leakyrelu"),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=RS_MESSAGE_LAYERS), **layer_kw),
    )
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        _fused_jax(mp)
        params = model.init(jax.random.key(0), batch, True)

        def loss_fn(p):
            logits = model.apply(p, batch, True)
            return jrs_loss(logits, batch)[0], logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, np.asarray(logits), float(loss), grads


def _port_rs(params) -> GCPNetRS:
    layer_kw = {"nonlinearity_slope": LAYER_SLOPE}
    model = GCPNetRS(
        ModelCfg(**RS_MODEL), ModuleCfg(scalar_nonlinearity="leakyrelu"),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=RS_MESSAGE_LAYERS), **layer_kw),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return load_jax_params(model, params)


def test_rs_forward_loss_and_gradients_match_jax(jax_rs):
    params, want_logits, want_loss, want_grads = jax_rs
    dm = rs.RSDataModule(**SMALL_BUCKET)
    dm.setup()
    batch = next(dm.val_batches()).to("cpu")
    model = _port_rs(params)
    logits = model(batch)
    assert logits.shape == (8,)
    np.testing.assert_allclose(np_(logits), want_logits, atol=ATOL)
    loss, labels = rs_loss(logits, batch)
    assert labels.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=ATOL)
    loss.backward()
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(np_(g), want[name].numpy(), atol=ATOL, err_msg=name)


def test_rs_fit_matches_jax_trainer():
    """Two epochs, Adam at 1e-3, seed 3, no dropout: the JAX Trainer on the
    JAX datamodule (its default unsorted layout) against the port's on its
    own (receiver-sorted) from the same weights."""
    optimizer = {"_target_": "Adam", "lr": 1e-3}
    model_kw = dict(RS_MODEL, num_encoder_layers=1)
    jdm, dm = _datamodules(max_nodes_per_graph=16)
    jtrainer = JTrainer(
        JGCPNetRS(
            model_cfg=JModelCfg(**model_kw), module_cfg=JModuleCfg(scalar_nonlinearity="leakyrelu"),
            layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2)),
        ),
        jrs_loss, optimizer_cfg=optimizer, max_epochs=2, mesh=make_mesh(jax.devices()[:1]),
        early_stopping_patience=None, seed=3, collect_fn=jtasks.build_collect("GCPNetRS"),
        metric_fns=jtasks.build_metric_fns("GCPNetRS"),
    )
    jtrainer.init_state(jtrainer._put(next(iter(jdm.train_batches(seed=0)))))
    model = GCPNetRS(
        ModelCfg(**model_kw), ModuleCfg(scalar_nonlinearity="leakyrelu"), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    load_jax_params(model, jtrainer.state.params)
    port = Trainer(
        model, rs_loss, optimizer_cfg=optimizer, max_epochs=2, early_stopping_patience=None, seed=3,
        collect_fn=tasks.build_collect("GCPNetRS"), metric_fns=tasks.build_metric_fns("GCPNetRS"),
    )
    jtrainer.fit(jdm)
    port.fit(dm)
    assert port.state.step == int(jtrainer.state.step) == 16
    for name in ("train/loss", "val/loss", "val/Accuracy", "val/F1"):
        np.testing.assert_allclose(port.history[name], jtrainer.history[name], atol=ATOL, err_msg=name)


def test_train_rs_cpu_entry_point(capsys):
    train_cli.main([
        "--task", "rs", "--device", "cpu", "--num-train", "16", "--num-valid", "8", "--num-test", "8",
        "--batch-size", "4", "--num-encoder-layers", "1", "--max-epochs", "2", "--min-epochs", "0",
    ])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["epoch"] for ln in lines[:-1]] == [0, 1]
    for ln in lines[:-1]:
        assert all(np.isfinite(ln[k]) for k in ("train/loss", "val/loss", "val/Accuracy", "val/F1"))
    assert {"test/loss", "test/Accuracy", "test/F1"} <= lines[-1].keys()


def test_train_rs_entry_point_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--task", "rs", "--num-train", "8", "--num-valid", "4", "--num-test", "4"])
