"""The port's CPD slice against the JAX package, on the CPU: data, layers
and the model.

- Data, exact: ``knn_graph`` against both paths of the JAX function (the
  native library and its numpy fallback) with masked residues;
  ``featurize_protein`` array for array (node features within 1e-6);
  ``CATHDataModule`` on a ``chain_set.jsonl`` fixture with masked residues:
  splits, custom subsets, and per batch the node arrays, ``seq`` and the
  real edge rows (one to one by (sender, receiver), the JAX module set to
  its receiver-sorted layout), for two shuffle seeds and the evaluation
  splits; ``prepare_data`` raises naming the missing files.
- Layers against flax at fp32 atol 1e-4, the same parameters carried by
  ``weights.py``: GCP2 with ``ablate_frame_updates``, the autoregressive
  interaction (one stack over each edge's selected input, against the
  reference's two masked stacks; with the frames read and in the
  decoder's configuration) with a node mask, ``GCPMLPDecoder``; and the four
  golden fixtures of the reference (``gcp2_ablate_frames``,
  ``interactions_autoregressive``, ``decoder_residual``,
  ``decoder_sequential``), weights translated as
  ``tests/test_parity_golden.py`` translates them.
- ``GCPNetCPD`` (2 encoder layers, 2 decoder layers, 2-layer message
  stacks, hidden 16/4/8/4) in both decoder modes on a fixture batch with
  masked residues: logits, log-probs, ``cpd_loss`` and every parameter's
  gradient against ``jax.grad``, fp32 atol 1e-4.
"""

import json
import os
import shutil

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcpnet_tpu.data.batching as jbatching
import gcpnet_tpu.data.native as jnative
from _torch_parity import load_jax_params, np_, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data import cath as jcath
from gcpnet_tpu.data import protein_graph as jpg
from gcpnet_tpu.graph import GraphBatch as JGraphBatch
from gcpnet_tpu.models.cpd import GCPNetCPD as JGCPNetCPD
from gcpnet_tpu.models.cpd import _decoder_cfg as j_decoder_cfg
from gcpnet_tpu.models.cpd import cpd_loss as j_cpd_loss
from gcpnet_tpu.nn.decoder import GCPMLPDecoder as JGCPMLPDecoder
from gcpnet_tpu.nn.gcp import GCP2 as JGCP2
from gcpnet_tpu.nn.gcp import GCPSettings as JGCPSettings
from gcpnet_tpu.nn.interactions import GCPInteractions as JGCPInteractions
from gcpnet_tpu.nn.primitives import ScalarVector as JSV
from gcpnet_tpu.utils.torch_compat import translate_state_dict
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import cath
from gcpnet_torch.data import protein_graph as pg
from gcpnet_torch.models.cpd import GCPNetCPD, cpd_loss, decoder_cfg
from gcpnet_torch.nn.decoder import GCPMLPDecoder
from gcpnet_torch.nn.gcp import GCP2, GCPSettings
from gcpnet_torch.nn.interactions import GCPInteractions
from gcpnet_torch.nn.primitives import ScalarVector, pack_vector
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
AA = "ACDEFGHIKLMNPQRSTVWY"
# the small CPD model of these tests
CPD_MODEL = dict(
    h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2,
    num_decoder_layers=2, output_dim=20, dropout=0.0, decoder_residual_updates=True,
)
CPD_MESSAGE_LAYERS = 2
DATA = dict(batch_size=3, max_nodes_per_batch=64)


def cpd_chain(rng: np.random.Generator, n: int, masked: int = 0) -> dict:
    """A chain record: a random-walk CA trace with N, C and O near each CA,
    ``masked`` residues (not the first) with NaN coordinates."""
    ca = np.cumsum(rng.normal(scale=1.2, size=(n, 3)) + [3.0, 0, 0], axis=0)
    coords = np.stack(
        [ca + rng.normal(scale=0.4, size=(n, 3)), ca, ca + rng.normal(scale=0.4, size=(n, 3)),
         ca + rng.normal(scale=0.6, size=(n, 3))], axis=1,
    ).astype(np.float32)
    coords[rng.choice(np.arange(1, n), size=masked, replace=False)] = np.nan
    return {"seq": "".join(rng.choice(list(AA), size=n)), "coords": coords}


def write_cath(root: str, rng: np.random.Generator, n_chains: int = 10, n_test: int = 3) -> list:
    """A CATH fixture: ``chain_set.jsonl`` (coords keyed by atom name, NaN
    where masked), its splits (the last ``n_test`` chains for test, the two
    before them for validation) and the two test subsets (all test chains
    but the last, all but the first); returns the names."""
    os.makedirs(root, exist_ok=True)
    names = [f"chain_{i}" for i in range(n_chains)]
    with open(os.path.join(root, "chain_set.jsonl"), "w") as f:
        for i, name in enumerate(names):
            chain = cpd_chain(rng, int(rng.integers(12, 24)), masked=i % 3)
            coords = {a: chain["coords"][:, k].tolist() for k, a in enumerate(cath.BACKBONE_ATOMS)}
            f.write(json.dumps({"name": name, "seq": chain["seq"], "coords": coords}) + "\n")
        f.write("not json\n")
    test = names[-n_test:]
    splits = {"train": names[:-n_test - 2], "validation": names[-n_test - 2:-n_test], "test": test, "cath_nodes": {}}
    with open(os.path.join(root, "chain_set_splits.json"), "w") as f:
        json.dump(splits, f)
    with open(os.path.join(root, "test_split_L100.json"), "w") as f:
        json.dump({"test": test[:-1]}, f)
    with open(os.path.join(root, "test_split_sc.json"), "w") as f:
        json.dump({"test": test[1:]}, f)
    return names


@pytest.fixture(scope="module")
def cath_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("cath"))
    write_cath(root, np.random.default_rng(3))
    return root


def _datamodules(root, monkeypatch, **kw):
    """The JAX module in its receiver-sorted layout and the port's, set up."""
    monkeypatch.setattr(jbatching, "SORT_EDGES_DEFAULT", True)
    monkeypatch.setattr(jbatching, "DENSE_EDGES_DEFAULT", False)
    kw = dict(DATA, **kw)
    jdm, dm = jcath.CATHDataModule(data_dir=root, **kw), cath.CATHDataModule(data_dir=root, **kw)
    jdm.setup()
    dm.setup()
    return jdm, dm


# --- data ---------------------------------------------------------------------


def _cloud(rng, n, masked):
    x = (rng.normal(size=(n, 3)) * 6).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, size=masked, replace=False)] = False
    return np.where(valid[:, None], x, np.inf).astype(np.float32), valid


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("n,k,masked", [(40, 30, 3), (12, 30, 0), (25, 6, 5), (1, 30, 0)])
def test_knn_graph_matches_jax(monkeypatch, path, n, k, masked):
    if path == "numpy":
        def unavailable(*args, **kwargs):
            raise RuntimeError("the native kNN is off in this case")

        monkeypatch.setattr(jnative, "knn_graph_native", unavailable)
    else:
        jnative.knn_graph_native(np.zeros((2, 3), np.float32), 1)  # the library loads here
    x, valid = _cloud(np.random.default_rng(n + k), n, masked)
    want = jpg.knn_graph(x, k, valid=valid)
    got = pg.knn_graph(x, k, valid=valid)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_featurize_protein_matches_jax():
    rng = np.random.default_rng(7)
    for n, masked, cfg in ((40, 3, None), (15, 0, {"sidechain": False, "relative_position": False})):
        chain = cpd_chain(rng, n, masked)
        got, want = pg.featurize_protein(chain, cfg, top_k=30), jpg.featurize_protein(chain, cfg, top_k=30)
        for name in ("senders", "receivers", "node_mask"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(got.extras["seq"], want.extras["seq"])
        for name in ("e", "xi", "x"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        for name in ("h", "chi"):
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-6, err_msg=name)
    assert got.node_mask.all() and not pg.featurize_protein(cpd_chain(rng, 20, 2)).node_mask.all()


def _assert_same_batches(jbatches, batches, label):
    jbatches, batches = list(jbatches), list(batches)
    assert len(batches) == len(jbatches) > 0, label
    for jb, b in zip(jbatches, batches):
        assert (b.num_nodes, b.num_edges, b.num_graphs) == (jb.num_nodes, jb.num_edges, jb.num_graphs)
        for name in ("h", "chi", "x", "graph_id", "node_pad_mask", "graph_pad_mask", "node_mask"):
            np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(jb, name)), err_msg=f"{label} {name}")
        np.testing.assert_array_equal(b.extras["seq"], np.asarray(jb.extras["seq"]), err_msg=label)
        jrows = {(int(s), int(r)): i
                 for i, (s, r, m) in enumerate(zip(jb.senders, jb.receivers, jb.edge_pad_mask)) if m}
        real = np.asarray(b.edge_pad_mask)
        rows = np.asarray([jrows[(int(s), int(r))] for s, r in zip(b.senders[real], b.receivers[real])])
        assert sorted(rows) == list(np.flatnonzero(np.asarray(jb.edge_pad_mask))), label
        np.testing.assert_array_equal(b.e[real], np.asarray(jb.e)[rows], err_msg=label)
        np.testing.assert_array_equal(b.xi[real], np.asarray(jb.xi)[rows], err_msg=label)
        assert np.all(np.diff(b.receivers[real]) >= 0) and b.edge_row_splits[-1] == real.sum()


def test_datamodule_matches_jax(cath_root, monkeypatch, tmp_path):
    """On the fixture with one train record that fails to featurize (an
    "X" in its sequence): both modules shuffle the records that featurize."""
    shutil.copytree(cath_root, tmp_path, dirs_exist_ok=True)
    path = os.path.join(tmp_path, "chain_set.jsonl")
    with open(path) as f:
        lines = f.read().splitlines()
    bad = json.loads(lines[1])  # a train record
    bad["seq"] = "X" + bad["seq"][1:]
    lines[1] = json.dumps(bad)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    jdm, dm = _datamodules(str(tmp_path), monkeypatch)
    assert {k: [e["name"] for e in v] for k, v in dm.splits.items()} == {
        k: [e["name"] for e in v] for k, v in jdm.splits.items()
    }
    assert [len(v) for v in dm.splits.values()] == [5, 2, 3]
    assert dm.custom_splits == jdm.custom_splits and set(dm.custom_splits) == {"short", "single_chain"}
    assert len(list(dm.named_graphs("train"))) == 4
    for seed in (0, 1, 2):
        _assert_same_batches(jdm.train_batches(seed=seed), dm.train_batches(seed=seed), f"train {seed}")
    _assert_same_batches(jdm.val_batches(), dm.val_batches(), "val")
    _assert_same_batches(jdm.test_batches(), dm.test_batches(), "test")
    assert [n for n, _ in dm.named_graphs("test")] == [n for n, _ in jdm.named_graphs("test")]
    assert dm.bucket() == cath.Bucket(64, 64 * 30, 3) and dm.top_k == jdm.top_k == 30
    # top_k from features_cfg; max_neighbors is not read (as in the JAX module)
    assert cath.CATHDataModule(features_cfg={"top_k": 12}, max_neighbors=5).top_k == 12


@pytest.mark.parametrize("unit,max_units", [("edge", 600), ("node", 30)])
def test_budget_datamodule_matches_jax(cath_root, unit, max_units, monkeypatch):
    """``max_units > 0``: the JAX module's ``make_bucket`` of the budget
    (``top_k`` the mean degree), its shuffled epochs and their order, and
    the evaluation splits, equal to the JAX module's."""
    jdm, dm = _datamodules(cath_root, monkeypatch, max_units=max_units, unit=unit)
    got, want = dm.bucket(), jdm._bucket()
    assert (got.num_nodes, got.num_edges, got.num_graphs) == (want.num_nodes, want.num_edges, want.num_graphs)
    for seed in (0, 1):
        _assert_same_batches(jdm.train_batches(seed=seed), dm.train_batches(seed=seed), f"train {seed}")
    _assert_same_batches(jdm.val_batches(), dm.val_batches(), "val")
    _assert_same_batches(jdm.test_batches(), dm.test_batches(), "test")


def test_prepare_data_downloads_nothing(tmp_path):
    (tmp_path / "chain_set.jsonl").write_text("")
    dm = cath.CATHDataModule(data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="chain_set_splits.json.*test_split_L100.json.*test_split_sc.json"):
        dm.prepare_data()
    assert sorted(os.listdir(tmp_path)) == ["chain_set.jsonl"]


# --- layers -------------------------------------------------------------------


def _graph(rng, n=11, e=40, s=8, v=4, es=6, ev=2):
    senders = rng.integers(0, n, size=e)
    receivers = rng.integers(0, n, size=e)
    return dict(
        hs=rng.normal(size=(n, s)).astype(np.float32), hv=rng.normal(size=(n, v, 3)).astype(np.float32),
        es=rng.normal(size=(e, es)).astype(np.float32), ev=rng.normal(size=(e, ev, 3)).astype(np.float32),
        frames=rng.normal(size=(e, 9)).astype(np.float32), senders=senders, receivers=receivers,
        rs=rng.normal(size=(n, s)).astype(np.float32), rv=rng.normal(size=(n, v, 3)).astype(np.float32),
        node_mask=rng.random(n) > 0.3, edge_mask=rng.random(e) > 0.1,
    )


def _sv(s, v):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return ScalarVector(t(s), pack_vector(t(v)))


def _jsv(s, v):
    from gcpnet_tpu.nn.primitives import pack_vector as jpack

    return JSV(jnp.asarray(s), jpack(jnp.asarray(v)))


def _close(got, want, label):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL, rtol=ATOL, err_msg=label)


def test_gcp2_ablate_frame_updates_matches_flax():
    """Node inputs and edge inputs; no ``vector_down_frames`` parameter, and
    the frames unread (None)."""
    rng = np.random.default_rng(11)
    g = _graph(rng)
    for node_inputs in (True, False):
        rows = g["hs"].shape[0] if node_inputs else g["es"].shape[0]
        s = rng.normal(size=(rows, 8)).astype(np.float32)
        v = rng.normal(size=(rows, 4, 3)).astype(np.float32)
        jst = JGCPSettings(ablate_frame_updates=True, bottleneck=2, frame_gate=True)
        jmod = JGCP2(input_dims=(8, 4), output_dims=(6, 3), settings=jst)
        args = (_jsv(s, v), jnp.asarray(g["senders"]), jnp.asarray(g["receivers"]), jnp.asarray(g["frames"]))
        params = jax.jit(lambda *a: jmod.init(jax.random.key(1), *a, node_inputs=node_inputs))(*args)
        want = jax.jit(lambda p, *a: jmod.apply(p, *a, node_inputs=node_inputs))(params, *args)
        port = GCP2((8, 4), (6, 3), GCPSettings(ablate_frame_updates=True, bottleneck=2, frame_gate=True),
                    generator=torch.Generator().manual_seed(0), device="cpu")
        assert not hasattr(port, "vector_down_frames")
        load_jax_params(port, params)
        got = port(_sv(s, v), None)
        _close(got.scalar, want.scalar, "scalar")
        _close(got.vector, want.vector, "vector")


INTERACTION_LAYER = dict(mp_cfg=dict(num_message_layers=3))


@pytest.mark.parametrize("decoder", [False, True], ids=["frames-read", "decoder-cfg"])
def test_autoregressive_interaction_matches_flax(decoder):
    """The autoregressive layer with a node mask, padding edges and dropout
    off, against flax (which runs the stack on each edge set): the port runs
    the stack once, with frames read and in the decoder's configuration."""
    rng = np.random.default_rng(12)
    g = _graph(rng)
    jcfg = JModuleCfg(bottleneck=2, default_bottleneck=2)
    cfg = ModuleCfg(bottleneck=2, default_bottleneck=2)
    if decoder:
        jcfg, cfg = j_decoder_cfg(jcfg), decoder_cfg(cfg)
    jmod = JGCPInteractions(
        node_dims=(8, 4), edge_dims=(6, 2), cfg=jcfg, layer_cfg=JLayerCfg.from_dict(INTERACTION_LAYER),
        dropout=0.0, autoregressive=True,
    )
    node_mask, edge_mask = g["node_mask"], g["edge_mask"]
    count_mask = edge_mask | (rng.random(edge_mask.shape) > 0.5)
    jargs = (_jsv(g["hs"], g["hv"]), _jsv(g["es"], g["ev"]), jnp.asarray(g["senders"]), jnp.asarray(g["receivers"]),
             jnp.asarray(g["frames"]))
    jkw = dict(node_rep_regressive=_jsv(g["rs"], g["rv"]), node_mask=jnp.asarray(node_mask),
               edge_mask=jnp.asarray(edge_mask), count_mask=jnp.asarray(count_mask))
    params = jax.jit(lambda a, kw: jmod.init(jax.random.key(2), *a, **kw))(jargs, jkw)
    want = jax.jit(lambda p, a, kw: jmod.apply(p, *a, **kw))(params, jargs, jkw)
    port = GCPInteractions((8, 4), (6, 2), cfg, LayerCfg.from_dict(INTERACTION_LAYER), dropout=0.0,
                           autoregressive=True, generator=torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(port, params)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got = port(
        _sv(g["hs"], g["hv"]), _sv(g["es"], g["ev"]), t(g["senders"]), t(g["receivers"]), t(g["frames"]),
        node_mask=t(node_mask), edge_mask=t(edge_mask), count_mask=t(count_mask),
        node_rep_regressive=_sv(g["rs"], g["rv"]),
    )
    _close(got.scalar, want.scalar, "scalar")
    _close(got.vector, want.vector, "vector")


@pytest.mark.parametrize("residual", [False, True])
def test_mlp_decoder_matches_flax(residual):
    h = np.random.default_rng(13).normal(size=(9, 10)).astype(np.float32)
    jmod = JGCPMLPDecoder(hidden_dim=10, vocab_size=20, num_layers=3, residual_updates=residual)
    params = jmod.init(jax.random.key(3), jnp.asarray(h))
    want = jmod.apply(params, jnp.asarray(h))
    port = load_jax_params(
        GCPMLPDecoder(10, 20, 3, residual, generator=torch.Generator().manual_seed(0), device="cpu"), params
    )
    for got, w, label in zip(port(torch.from_numpy(h)), want, ("logits", "log_probs")):
        _close(got, w, label)


def _golden(name):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    meta = json.loads(str(z["meta"]))
    part = lambda p: {k[len(p):]: z[k] for k in z.files if k.startswith(p)}  # noqa: E731
    return meta, part("in:"), part("sd:"), part("out:")


def _unpacked(vector: torch.Tensor, c: int) -> np.ndarray:
    return vector.reshape(-1, 3, c).transpose(1, 2).detach().numpy()


@pytest.mark.parametrize("name", ["gcp2_ablate_frames", "interactions_autoregressive", "decoder_residual",
                                  "decoder_sequential"])
def test_golden_fixtures(name):
    """The reference's own fixtures: its modules' outputs on fixed inputs,
    its weights translated as tests/test_parity_golden.py translates them."""
    meta, ins, sd, outs = _golden(name)
    state = from_jax_params(translate_state_dict(sd))
    gen = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        if meta["kind"] == "decoder":
            module = GCPMLPDecoder(meta["hidden_dim"], meta["vocab_size"], meta["num_layers"],
                                   meta["residual_updates"], **gen)
            module.load_state_dict(state)
            for got, key in zip(module(torch.from_numpy(ins["h"])), ("logits", "log_probs")):
                np.testing.assert_allclose(got.numpy(), outs[key], atol=ATOL, rtol=ATOL, err_msg=key)
            return
        if meta["kind"] == "gcp":
            cfg = meta["cfg"]
            settings = GCPSettings(
                scalar_nonlinearity=meta["nonlinearities"][0], vector_nonlinearity=meta["nonlinearities"][1],
                vector_gate=cfg["vector_gate"], frame_gate=cfg["frame_gate"], bottleneck=cfg["bottleneck"],
                vector_residual=cfg["vector_residual"], ablate_frame_updates=cfg["ablate_frame_updates"],
            )
            assert meta["node_inputs"] and settings.ablate_frame_updates
            module = GCP2(tuple(meta["in_dims"]), tuple(meta["out_dims"]), settings, **gen)
            module.load_state_dict(state)
            out = module(_sv(ins["s"], ins["v"]), None)
        else:
            assert meta["autoregressive"] and not meta["has_node_mask"]
            module = GCPInteractions(
                tuple(meta["node_dims"]), tuple(meta["edge_dims"]), ModuleCfg.from_dict(meta["cfg"]),
                LayerCfg.from_dict(meta["layer_cfg"]), dropout=0.0, autoregressive=True, **gen,
            )
            module.load_state_dict(state)
            senders, receivers = (torch.from_numpy(ins["edge_index"][i].astype(np.int64)) for i in (0, 1))
            out = module(
                _sv(ins["hs"], ins["hv"]), _sv(ins["es"], ins["ev"]), senders, receivers,
                torch.from_numpy(ins["frames"].reshape(-1, 9)), node_rep_regressive=_sv(ins["rs"], ins["rv"]),
            )
    np.testing.assert_allclose(out.scalar.numpy(), outs["scalar"], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_unpacked(out.vector, outs["vector"].shape[1]), outs["vector"], atol=ATOL, rtol=ATOL)


# --- the model ----------------------------------------------------------------


def cpd_models(autoregressive: bool, jbatch):
    """The JAX model with parameters from its init, and the port's model
    holding the same parameters."""
    jmodel = JGCPNetCPD(
        model_cfg=JModelCfg(**CPD_MODEL), module_cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=CPD_MESSAGE_LAYERS)),
        autoregressive_decoder=autoregressive,
    )
    params = jax.jit(lambda b: jmodel.init(jax.random.key(4), b, True))(jbatch)
    port = GCPNetCPD(
        ModelCfg(**CPD_MODEL), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=CPD_MESSAGE_LAYERS)),
        autoregressive_decoder=autoregressive, generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return jmodel, params, load_jax_params(port, params)


def jax_batch(batch) -> JGraphBatch:
    """The port's host batch as the JAX package's (the same arrays)."""
    fields = {name: getattr(batch, name) for name in (
        "h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id", "node_pad_mask", "edge_pad_mask",
        "graph_pad_mask", "node_mask", "edge_row_splits", "extras")}
    return to_jax(JGraphBatch(**fields))


@pytest.mark.parametrize("autoregressive", [False, True], ids=["mlp", "autoregressive"])
def test_cpd_model_matches_jax(cath_root, monkeypatch, autoregressive):
    """A training batch of the fixture (masked residues in it): logits,
    log-probs, the loss and every parameter's gradient."""
    _, dm = _datamodules(cath_root, monkeypatch)
    batch = next(dm.train_batches(seed=0))
    assert not batch.node_mask[batch.node_pad_mask].all()
    jbatch = jax_batch(batch)
    jmodel, params, port = cpd_models(autoregressive, jbatch)

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, True)
        return j_cpd_loss(out, jbatch)[0], out

    (want_loss, (want_logits, want_log_probs)), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tb = batch.to("cpu")
    logits = port(tb)
    _close(logits, want_logits, "logits")
    _close(torch.log_softmax(logits, -1), want_log_probs, "log_probs")
    loss, seq = cpd_loss(logits, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_array_equal(seq.numpy(), batch.extras["seq"])
    loss.backward()
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert got.keys() == want.keys()
    prefixes = {"gcp_embedding", "encoder_0", "encoder_1", "invariant_node_projection"}
    prefixes |= {"seq_embedding", "decoder_0", "decoder_1"} if autoregressive else {"decoder"}
    assert {k.split(".")[0] for k in got} == prefixes
    for name, g in got.items():
        np.testing.assert_allclose(np_(g), want[name].numpy(), atol=ATOL, err_msg=name)
