"""The port's ATOM3D slice (PSR, and LBA on records) against the JAX
package, on the CPU.

- Data, exact: ``radius_graph`` against the JAX function's scipy path
  (random clouds, fewer than 33 atoms, an isolated atom, a dense cluster
  over the cap, one atom); ``featurize_atoms`` array for array; the
  datamodule on the npz records that ``tests/test_atom3d_datamodule.py``
  writes (with a malformed record added to each training split): split
  sizes, PSR target codes, the shuffled order for two seeds (and again
  from the port's lazily featurized split), and per batch the node arrays,
  labels, ``lig_flag`` and ``target_id`` equal and the real edge rows equal
  as a multiset (the JAX module set to its receiver-sorted layout).
- ``GCPNetPSR`` at 2 interaction layers of 3-layer stacks, hidden
  16/4/8/4, against the JAX model in its fused configuration (Pallas edge
  map and sorted segment sum, interpret mode) on a record batch:
  predictions, ``graph_regression_loss`` and every parameter's gradient
  at fp32 atol 1e-4.
- Golden: the ligand-flag embedding against
  ``tests/golden/embedding_lba_ligflag.npz`` and the flax module, and the
  LBA/PSR model against ``scripts/golden/numpy_reference.py``'s
  ``lba_forward``: fp32 atol 1e-4.
- A 2-epoch PSR fit against the JAX ``Trainer`` (no dropout): the losses
  and the RMSE at atol 1e-4, the ``local_*`` and ``global_*`` correlations
  at atol 1e-3 (a rank correlation over a handful of decoys moves in steps
  of at least 1/15, so 1e-3 still tells any reordering apart).
- The evaluation keeps no batch until its metrics, and each task's collect
  function adds from what it keeps what the JAX one adds from the batch;
  the ``--task psr`` and ``--task lba --data-dir`` entry points on the CPU
  (with a small bucket), and their refusal to fall back to the CPU without
  ``--device cpu``.
"""

import functools
import gc
import json
import logging
import os
import sys
import weakref
from pathlib import Path

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcpnet_tpu.data.batching as jbatching
import gcpnet_tpu.data.native as jnative
import gcpnet_tpu.nn.gcp as jgcp
import gcpnet_tpu.nn.message_passing as jmp
import gcpnet_tpu.ops.pallas_fused as jpallas_fused
import gcpnet_tpu.ops.segment as jseg
from _torch_parity import LBA_MESSAGE_LAYERS, LBA_MODEL, load_jax_params, np_, to_jax
from test_atom3d_datamodule import _write_records
from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data import atom3d as jatom3d
from gcpnet_tpu.data.batching import sort_edges_by_receiver as jsort_edges
from gcpnet_tpu.graph import GraphBatch as JGraphBatch
from gcpnet_tpu.models import GCPNetPSR as JGCPNetPSR
from gcpnet_tpu.models import graph_regression_loss as jgraph_regression_loss
from gcpnet_tpu.nn.embedding import GCPEmbedding as JGCPEmbedding
from gcpnet_tpu.parallel import make_mesh
from gcpnet_tpu.train import Trainer as JTrainer
from gcpnet_tpu.train.metrics import Collector as JCollector
from gcpnet_tpu.utils.torch_compat import translate_state_dict
from gcpnet_torch import tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import atom3d
from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.graph import GraphBatch, GraphData
from gcpnet_torch.models import GCPNetLBA, GCPNetPSR, graph_regression_loss
from gcpnet_torch.nn.embedding import GCPEmbedding
from gcpnet_torch.data import registry
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.metrics import Collector
from gcpnet_torch.train.trainer import Trainer
from gcpnet_torch.weights import from_jax_params

# the sorted forms of a port batch's indices (``data.batching.with_sorted_indices``)
SORTED_FORMS = ("sender_perm", "sender_inv_perm", "sender_splits", "graph_splits")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts" / "golden"))
import numpy_reference as npref  # noqa: E402

ATOL = 1e-4
# rank and linear correlations over the fit's few validation decoys
CORRELATION_ATOL = 1e-3
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "embedding_lba_ligflag.npz")
# the datamodule tests' bucket: 3 graphs, 256 nodes, 256 x 32 edge rows
DATA = dict(batch_size=3, max_nodes_per_batch=256)


@pytest.fixture(autouse=True)
def scipy_radius_graph(monkeypatch):
    """The JAX ``radius_graph`` on its scipy path, the port's reference
    (its compiled ``cpp/graph_kernels.cpp`` path is not ported)."""

    def unavailable(*args, **kwargs):
        raise RuntimeError("the native radius graph is off in these tests")

    monkeypatch.setattr(jnative, "radius_graph_native", unavailable)


def _jax_layout(monkeypatch, sort: bool) -> None:
    """The JAX ATOM3D module's layout: receiver-sorted (``sort``) or the
    plain edge list, in place of its dense default."""
    monkeypatch.setattr(jbatching, "SORT_EDGES_DEFAULT", sort)
    monkeypatch.setattr(jbatching, "DENSE_EDGES_DEFAULT", False)


@pytest.fixture(scope="module")
def records(tmp_path_factory) -> str:
    """LBA and PSR records (6 a split), and in each training split a 7th
    record without a label, which both modules skip."""
    root = tmp_path_factory.mktemp("atom3d")
    for task in ("LBA", "PSR"):
        _write_records(str(root), task)
        dm = atom3d.ATOM3DDataModule(task=task, data_dir=str(root))
        rng = np.random.default_rng(5)
        np.savez(
            dm._split_dir("train") + "_npz/zzz.npz", coords=rng.normal(size=(20, 3)).astype(np.float32),
            elements=np.asarray(["C"] * 20), lig_flag=np.zeros(20, np.int32), target="T9",
        )
    return str(root)


def _datamodules(records, task, **kw):
    kw = dict(DATA, **kw)
    jdm = jatom3d.ATOM3DDataModule(task=task, data_dir=records, **kw)
    dm = atom3d.ATOM3DDataModule(task=task, data_dir=records, **kw)
    jdm.setup()
    dm.setup()
    return jdm, dm


# --- radius graph and featurization ------------------------------------------


def _cloud(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "random":
        return (rng.normal(size=(200, 3)) * 4).astype(np.float32)
    if kind == "under_33":
        return (rng.normal(size=(20, 3)) * 2).astype(np.float32)
    if kind == "isolated":
        cloud = rng.normal(size=(60, 3)) * 3
        return np.concatenate([cloud, [[50.0, 50.0, 50.0]]]).astype(np.float32)
    if kind == "dense_over_cap":
        return (rng.normal(size=(150, 3)) * 0.8).astype(np.float32)
    return np.zeros((1, 3), np.float32)  # "single"


@pytest.mark.parametrize("kind", ["random", "under_33", "isolated", "dense_over_cap", "single"])
def test_radius_graph_matches_jax(kind):
    """Exactly the JAX function's arrays, dtypes included."""
    coords = _cloud(kind)
    want = jatom3d.radius_graph(coords, 4.5, 32)
    got = atom3d.radius_graph(coords, 4.5, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    receivers = got[1]
    if kind == "dense_over_cap":
        assert np.bincount(receivers).max() == 32  # the cap binds
    if kind == "isolated":
        assert len(coords) - 1 not in set(receivers) | set(got[0])
    if kind == "single":
        assert receivers.size == 0


def test_featurize_atoms_matches_jax():
    rng = np.random.default_rng(4)
    coords = (rng.normal(size=(40, 3)) * 3).astype(np.float32)
    elements = rng.choice(np.asarray(["C", "N", "O", "S", "Cl", "CL", "Se", "P", "F", "H"]), size=40)
    np.testing.assert_array_equal(atom3d.element_to_type(elements), jatom3d.element_to_type(elements))
    assert atom3d.element_to_type(["CL", "Cl", "Se"]).tolist() == [6, 6, 8]
    got, want = atom3d.featurize_atoms(coords, elements), jatom3d.featurize_atoms(coords, elements)
    for name in ("h", "chi", "e", "xi", "x", "senders", "receivers"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# --- the datamodule ----------------------------------------------------------


def _jax_row_of_port_row(jbatch, batch) -> np.ndarray:
    jrows = {(int(s), int(r)): i for i, (s, r, m) in enumerate(
        zip(jbatch.senders, jbatch.receivers, jbatch.edge_pad_mask)) if m}
    real = np.asarray(batch.edge_pad_mask)
    return np.asarray([jrows[(int(s), int(r))] for s, r in zip(batch.senders[real], batch.receivers[real])])


def _assert_same_batches(jbatches, batches, label):
    jbatches, batches = list(jbatches), list(batches)
    assert len(batches) == len(jbatches) > 0, label
    for jb, b in zip(jbatches, batches):
        assert (b.num_nodes, b.num_edges, b.num_graphs) == (jb.num_nodes, jb.num_edges, jb.num_graphs)
        for name in ("h", "chi", "x", "graph_id", "node_pad_mask", "graph_pad_mask"):
            np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(jb, name)), err_msg=f"{label} {name}")
        assert b.extras.keys() == jb.extras.keys(), label
        for key in b.extras:
            np.testing.assert_array_equal(b.extras[key], np.asarray(jb.extras[key]), err_msg=f"{label} {key}")
        # the real edge rows, one to one by (sender, receiver)
        rows = _jax_row_of_port_row(jb, b)
        assert sorted(rows) == list(np.flatnonzero(np.asarray(jb.edge_pad_mask))), label
        real = np.asarray(b.edge_pad_mask)
        np.testing.assert_array_equal(b.e[real], np.asarray(jb.e)[rows], err_msg=label)
        np.testing.assert_array_equal(b.xi[real], np.asarray(jb.xi)[rows], err_msg=label)
        # receiver-sorted with CSR splits over the real rows
        assert np.all(np.diff(b.receivers[real]) >= 0) and b.edge_row_splits[-1] == real.sum()


@pytest.mark.parametrize("task", ["LBA", "PSR"])
def test_datamodule_matches_jax(records, task, monkeypatch, caplog):
    _jax_layout(monkeypatch, sort=True)
    jdm, dm = _datamodules(records, task)
    assert {s: len(r) for s, r in dm.datasets.items()} == {s: len(r) for s, r in jdm.datasets.items()}
    assert len(dm.datasets["train"]) == 7
    with caplog.at_level(logging.WARNING, logger=atom3d.__name__):
        _assert_same_batches(jdm.train_batches(seed=0), dm.train_batches(seed=0), "train 0")
    assert "skipping malformed record" in caplog.text
    # a split's later passes featurize lazily, in the packed order
    for seed in (1, 0):
        _assert_same_batches(jdm.train_batches(seed=seed), dm.train_batches(seed=seed), f"train {seed}")
    _assert_same_batches(jdm.val_batches(), dm.val_batches(), "val")
    _assert_same_batches(jdm.test_batches(), dm.test_batches(), "test")
    assert dm._target_codes == jdm._target_codes
    if task == "PSR":
        assert dm._target_codes == {"T0": 0, "T1": 1}
    assert dm.bucket() == atom3d.Bucket(num_nodes=256, num_edges=256 * 32, num_graphs=3)


@pytest.mark.parametrize("task", ["LBA", "PSR"])
@pytest.mark.parametrize("unit,max_units", [("edge", 600), ("node", 60)])
def test_budget_datamodule_matches_jax(records, task, unit, max_units, monkeypatch):
    """``max_units > 0``: the JAX module's ``make_bucket`` of the budget
    (the radius graph's cap the mean degree) and its greedy fill, in the
    CSR layout (no alignment slack needed), shuffled epochs, their order
    and the evaluation splits equal to the JAX module's."""
    _jax_layout(monkeypatch, sort=True)
    jdm, dm = _datamodules(records, task, max_units=max_units, unit=unit)
    got, want = dm.bucket(), jdm._bucket()
    assert (got.num_nodes, got.num_edges, got.num_graphs) == (want.num_nodes, want.num_edges, want.num_graphs)
    assert got != atom3d.Bucket(num_nodes=256, num_edges=256 * 32, num_graphs=3)
    for seed in (0, 1):
        _assert_same_batches(jdm.train_batches(seed=seed), dm.train_batches(seed=seed), f"train {seed}")
    _assert_same_batches(jdm.val_batches(), dm.val_batches(), "val")
    _assert_same_batches(jdm.test_batches(), dm.test_batches(), "test")


def test_missing_records_raise_and_prepare_data_warns(tmp_path, caplog):
    dm = atom3d.ATOM3DDataModule(task="PSR", data_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING, logger=atom3d.__name__):
        dm.prepare_data()
    assert "convert_atom3d_to_npz.py" in caplog.text
    os.makedirs(dm._split_dir("train"))  # an LMDB split, not converted
    with pytest.raises(RuntimeError, match="LMDB split.*convert_atom3d_to_npz.py"):
        dm.setup()
    with pytest.raises(ValueError, match="not LBA or PSR"):
        atom3d.ATOM3DDataModule(task="RES")


# --- the PSR model -------------------------------------------------------------


def _fused_jax(monkeypatch):
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
    monkeypatch.setattr(jseg, "USE_PALLAS_SEGMENT", True)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)


def _configs(pkg_model, pkg_module, pkg_layer, pkg_mp, **model_kw):
    return dict(
        model_cfg=pkg_model(**{**LBA_MODEL, "dropout": 0.0, "dense_dropout": 0.0, **model_kw}),
        module_cfg=pkg_module(),
        layer_cfg=pkg_layer(mp_cfg=pkg_mp(num_message_layers=LBA_MESSAGE_LAYERS)),
    )


def test_psr_forward_loss_and_gradients_match_jax(records, monkeypatch):
    """The JAX model in its fused configuration on the JAX module's first
    validation batch, receiver-sorted to CSR (the port's layout: the two
    batches are equal array for array), against the port on its own."""
    _jax_layout(monkeypatch, sort=False)
    jdm, dm = _datamodules(records, "PSR", batch_size=4)
    jbatch = jsort_edges(next(jdm.val_batches()), tile=1)
    batch = next(dm.val_batches())
    for name, array in batch.tensors().items():
        if name in SORTED_FORMS:  # the port's sorted indices, which the JAX batch lacks
            continue
        want = jbatch.extras[name[7:]] if name.startswith("extras.") else getattr(jbatch, name)
        np.testing.assert_array_equal(array, np.asarray(want), err_msg=name)
    jbatch = to_jax(jbatch)
    model = JGCPNetPSR(**_configs(JModelCfg, JModuleCfg, JLayerCfg, JMPCfg), num_atom_types=9)
    with monkeypatch.context() as mp, pltpu.force_tpu_interpret_mode():
        _fused_jax(mp)
        params = model.init(jax.random.key(0), jbatch, True)

        def loss_fn(p):
            preds = model.apply(p, jbatch, True)
            return jgraph_regression_loss(preds, jbatch)[0], preds

        (want_loss, want_preds), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    port = load_jax_params(
        GCPNetPSR(**_configs(ModelCfg, ModuleCfg, LayerCfg, MPCfg), num_atom_types=9,
                  generator=torch.Generator().manual_seed(0), device="cpu"),
        params,
    )
    tb = batch.to("cpu")
    preds = port(tb)
    assert preds.shape == (4,)
    np.testing.assert_allclose(np_(preds), np.asarray(want_preds), atol=ATOL)
    loss, labels = graph_regression_loss(preds, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    loss.backward()
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(np_(g), want[name].numpy(), atol=ATOL, err_msg=name)


# --- golden checks -------------------------------------------------------------


def test_lig_flag_embedding_matches_golden_and_flax():
    """The reference's fixture of the LBA embedding with the ligand flag,
    weights translated as tests/test_parity_golden.py translates them; the
    flax module on the same weights beside it."""
    z = np.load(GOLDEN)
    meta = json.loads(str(z["meta"]))
    ins = {k[3:]: z[k] for k in z.files if k.startswith("in:")}
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd:")}
    outs = {k[4:]: z[k] for k in z.files if k.startswith("out:")}
    assert meta["concatenate_lig_flag"] and meta["pre_norm"]
    params = translate_state_dict(sd)
    dims = {k: tuple(meta[k]) for k in ("edge_input_dims", "node_input_dims", "edge_hidden_dims", "node_hidden_dims")}
    module = GCPEmbedding(
        **dims, cfg=ModuleCfg.from_dict(meta["cfg"]), num_atom_types=meta["num_atom_types"],
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    module.load_state_dict(from_jax_params(params))
    n, e = ins["h"].shape[0], ins["es"].shape[0]
    arrays = dict(
        h=ins["h"].astype(np.int32), chi=ins["chi"], e=ins["es"], xi=ins["ev"], x=np.zeros((n, 3), np.float32),
        senders=ins["edge_index"][0].astype(np.int32), receivers=ins["edge_index"][1].astype(np.int32),
        graph_id=np.zeros(n, np.int32), node_pad_mask=np.ones(n, bool), edge_pad_mask=np.ones(e, bool),
        graph_pad_mask=np.ones(1, bool), extras={"lig_flag": ins["lig_flag"].astype(np.int32)},
    )
    frames = ins["frames"].reshape(-1, 9)
    with torch.no_grad():
        node, edge = module(GraphBatch(**arrays).to("cpu"), torch.from_numpy(frames))
    jmodule = JGCPEmbedding(**dims, cfg=JModuleCfg.from_dict(meta["cfg"]), num_atom_types=meta["num_atom_types"])
    jnode, jedge = jmodule.apply({"params": params}, to_jax(JGraphBatch(**arrays)), jnp.asarray(frames))
    def unpacked(vector: torch.Tensor) -> np.ndarray:  # packed [n, 3c] -> [n, c, 3]
        return np_(vector.reshape(vector.shape[0], 3, -1).transpose(1, 2))

    for got, golden, label in (
        (np_(node.scalar), outs["node_scalar"], "node scalar"), (unpacked(node.vector), outs["node_vector"], "node vector"),
        (np_(edge.scalar), outs["edge_scalar"], "edge scalar"), (unpacked(edge.vector), outs["edge_vector"], "edge vector"),
    ):
        np.testing.assert_allclose(got, golden, atol=ATOL, err_msg=f"{label} vs golden")
    for got, flax in ((node.scalar, jnode.scalar), (node.vector, jnode.vector), (edge.scalar, jedge.scalar),
                      (edge.vector, jedge.vector)):
        np.testing.assert_allclose(np_(got), np.asarray(flax), atol=ATOL)


def test_whole_model_matches_numpy_reference():
    """The port's LBA and PSR model (one class) on a padded, receiver-sorted
    batch against the float64 numpy re-derivation of the reference on the
    unpadded graphs, as tests/test_model_golden.py holds the flax model;
    the reference reads the port's weights by their flax paths."""
    assert GCPNetPSR is GCPNetLBA
    rng = np.random.default_rng(11)
    graphs = []
    for _ in range(2):
        graphs.append(GraphData(
            h=rng.integers(0, 9, size=10).astype(np.int32), chi=rng.normal(size=(10, 2, 3)).astype(np.float32),
            e=rng.normal(size=(30, 8)).astype(np.float32), xi=rng.normal(size=(30, 1, 3)).astype(np.float32),
            x=(rng.normal(size=(10, 3)) * 4).astype(np.float32),
            senders=rng.integers(0, 10, size=30).astype(np.int32),
            receivers=rng.integers(0, 10, size=30).astype(np.int32), extras={"label": np.float32(0.0)},
        ))
    batch = next(batches_from_dataset(graphs, Bucket(27, 73, 3), extra_graph_keys=("label",)))
    port = GCPNetPSR(
        ModelCfg(chi_input_dim=2, e_input_dim=8, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
                 e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0),
        ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=3)), num_atom_types=9,
        generator=torch.Generator().manual_seed(2), device="cpu",
    )
    params = {}
    for name, value in port.state_dict().items():
        *path, leaf = name.split(".")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.double().numpy()
    with torch.no_grad():
        got = np_(port(batch.to("cpu")))[:2]
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs])
    want = npref.lba_forward(
        params,
        np.concatenate([g.h for g in graphs]).astype(np.int64),
        *(np.concatenate([getattr(g, k) for g in graphs]).astype(np.float64) for k in ("chi", "e", "xi", "x")),
        np.concatenate([g.senders + o for g, o in zip(graphs, offsets)]),
        np.concatenate([g.receivers + o for g, o in zip(graphs, offsets)]),
        np.repeat(np.arange(2), 10), 2,
        num_atom_types=9, node_in_dims=(9, 2), edge_in_dims=(8, 1), node_dims=(16, 4), edge_dims=(8, 4),
        num_layers=2, num_message_layers=3,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


# --- the fit, the evaluation, the entry points ---------------------------------


def test_psr_fit_matches_jax_trainer(records):
    """Two epochs, Adam at 1e-3, seed 3, no dropout: the JAX Trainer on the
    JAX module (its default dense layout) against the port's on its own
    (receiver-sorted CSR) from the same weights."""
    optimizer = {"_target_": "Adam", "lr": 1e-3}
    model_kw = dict(num_encoder_layers=1)
    jdm, dm = _datamodules(records, "PSR")
    jtrainer = JTrainer(
        JGCPNetPSR(**_configs(JModelCfg, JModuleCfg, JLayerCfg, JMPCfg, **model_kw), num_atom_types=9),
        jgraph_regression_loss, optimizer_cfg=optimizer, max_epochs=2, mesh=make_mesh(jax.devices()[:1]),
        early_stopping_patience=None, seed=3, collect_fn=jtasks.build_collect("GCPNetPSR"),
        metric_fns=jtasks.build_metric_fns("GCPNetPSR"),
    )
    jtrainer.init_state(jtrainer._put(next(iter(jdm.train_batches(seed=0)))))
    model = GCPNetPSR(**_configs(ModelCfg, ModuleCfg, LayerCfg, MPCfg, **model_kw), num_atom_types=9,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(model, jtrainer.state.params)
    port = Trainer(
        model, graph_regression_loss, optimizer_cfg=optimizer, max_epochs=2, early_stopping_patience=None, seed=3,
        collect_fn=tasks.build_collect("GCPNetPSR"), metric_fns=tasks.build_metric_fns("GCPNetPSR"),
    )
    jtrainer.fit(jdm)
    port.fit(dm)
    assert port.state.step == int(jtrainer.state.step) == 4
    for name in ("train/loss", "val/loss", "val/RMSE"):
        np.testing.assert_allclose(port.history[name], jtrainer.history[name], atol=ATOL, err_msg=name)
    grouped = [f"val/{scope}_{kind}" for scope in ("local", "global") for kind in ("pearson", "spearman", "kendall")]
    for name in grouped:
        assert np.all(np.isfinite(port.history[name])), name
        np.testing.assert_allclose(port.history[name], jtrainer.history[name], atol=CORRELATION_ATOL, err_msg=name)


def test_eval_keeps_no_batch(records):
    """Until the epoch's metrics the evaluation keeps each batch's
    predictions and what the task's collect function keeps of it
    (``Collect.keep``), not the batch: by the time the first ``add`` runs,
    every batch it evaluated is gone.  The metrics equal those of the
    batches kept whole."""
    dm = atom3d.ATOM3DDataModule(task="PSR", data_dir=records, batch_size=2, max_nodes_per_batch=128)
    dm.setup()
    model = GCPNetPSR(**_configs(ModelCfg, ModuleCfg, LayerCfg, MPCfg, num_encoder_layers=1), num_atom_types=9,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    collect = tasks.build_collect("GCPNetPSR")
    refs, seen = [], []

    def tracked():
        for batch in dm.val_batches():
            refs.append(weakref.ref(batch))
            yield batch

    def spy_add(collector, preds, kept):
        if not seen:
            gc.collect()
            seen.append([r() is not None for r in refs])
        assert all(isinstance(v, (np.ndarray, np.generic, type(None))) for v in kept.values()), kept
        collect.add(collector, preds, kept)

    trainer = Trainer(model, graph_regression_loss, collect_fn=tasks.Collect(collect.keep, spy_add),
                      metric_fns=tasks.build_metric_fns("GCPNetPSR"), scan_chunk_size=2)
    got = trainer.eval_epoch(tracked())
    assert len(refs) == 3 and seen == [[False] * 3]
    # the same metrics from the batches kept whole
    whole = []

    def add_whole(collector, preds, batch):
        whole.append(batch)
        collect(collector, preds, batch)

    trainer.collect_fn = tasks.Collect(lambda batch: batch, add_whole)
    want = trainer.eval_epoch(list(dm.val_batches()))
    assert len(whole) == 3 and all(isinstance(b, GraphBatch) for b in whole)
    assert got == want and {"val/local_pearson", "val/global_kendall"} <= got.keys()


@pytest.mark.parametrize("model_name", ["GCPNetLBA", "GCPNetPSR", "GCPNetNMS", "GCPNetRS"])
def test_collect_keeps_what_it_adds(records, model_name):
    """Each task's collect function adds, from what it keeps of a batch, the
    predictions, labels and groups that the JAX task's collect function
    adds from the whole batch; what it keeps is a few arrays of the
    batch's graphs or nodes, none of its edges."""
    dm = atom3d.ATOM3DDataModule(task="PSR", data_dir=records, **DATA)
    dm.setup()
    batch = next(iter(dm.val_batches()))
    rng = np.random.default_rng(1)
    if model_name == "GCPNetNMS":  # node positions
        batch.extras["label"] = rng.normal(size=(batch.num_nodes, 3)).astype(np.float32)
        out = rng.normal(size=(batch.num_nodes * 3,)).astype(np.float32)
    else:
        out = rng.normal(size=(batch.num_graphs,)).astype(np.float32)
    collect, jcollect = tasks.build_collect(model_name), jtasks.build_collect(model_name)
    kept = collect.keep(batch)
    assert sum(np.asarray(v).nbytes for v in kept.values() if v is not None) <= 16 * (batch.num_nodes + 1)
    got, want = Collector(), JCollector()
    collect.add(got, out, kept)
    jcollect(want, out, batch)
    for g, w in zip(got.cat(), want.cat()):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def _fit_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


SMALL_FIT = ["--device", "cpu", "--batch-size", "3", "--num-encoder-layers", "1", "--max-epochs", "2", "--min-epochs", "0"]


@pytest.fixture
def small_bucket(monkeypatch):
    """The entry point's datamodule with the datamodule tests' bucket of
    256 nodes in place of the JAX one (16,384), which would take minutes a
    step on the CPU."""
    monkeypatch.setitem(registry.DATAMODULES, "ATOM3DDataModule",
                        functools.partial(atom3d.ATOM3DDataModule, max_nodes_per_batch=DATA["max_nodes_per_batch"]))


def test_train_psr_cpu_entry_point(records, small_bucket, capsys):
    train_cli.main(["--task", "psr", "--data-dir", records, *SMALL_FIT])
    lines = _fit_lines(capsys)
    assert [ln["epoch"] for ln in lines[:-1]] == [0, 1]
    for ln in lines[:-1]:
        assert all(np.isfinite(ln[k]) for k in ("train/loss", "val/loss", "val/RMSE", "val/local_pearson"))
    assert {"test/loss", "test/global_pearson", "test/local_spearman", "test/global_kendall"} <= lines[-1].keys()
    assert np.isfinite(lines[-1]["test/loss"])


def test_train_lba_records_cpu_entry_point(records, small_bucket, capsys):
    train_cli.main(["--task", "lba", "--data-dir", records, *SMALL_FIT])
    lines = _fit_lines(capsys)
    assert [ln["epoch"] for ln in lines[:-1]] == [0, 1]
    assert {"test/loss", "test/RMSE", "test/PearsonCorrCoef", "test/SpearmanCorrCoef"} <= lines[-1].keys()
    assert "test/local_pearson" not in lines[-1]
    assert all(np.isfinite(ln["train/loss"]) for ln in lines[:-1])


@pytest.mark.parametrize("task", ["psr", "lba"])
def test_atom3d_entry_points_refuse_cpu_fallback(records, task):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--task", task, "--data-dir", records])
