"""The port's AR data path and structure scores against the JAX package, on
the CPU.

- ``hybrid_knn_edges`` (a ``cKDTree`` query) against the JAX function on its
  native path (``cpp/libgraphkernels.so``): the same edge list, exactly, on
  clouds with ties and repeated atoms.
- ``featurize_refinement_pair`` array for array (whole, a residue range,
  backbone only), the seeded 250-residue crop (patched to 20 residues in
  both packages), ``sliding_windows``.
- ``ARDataModule``'s batches against the JAX module's (receiver-sorted to
  the port's CSR layout) over shuffled epochs with a decoy that fails to
  parse, and the evaluation splits; ``globalize_ar_residues``; the graph
  cache.
- ``predict_batches`` and ``record_predictions`` with the window constants
  patched small in both packages, so that a decoy is cut into windows and
  stitched: the same batches, the same refined PDB byte for byte, the same
  score row; the window too large for the bucket raises.
- ``structure_metrics``' TM-score bundle at 1e-6; AR's collect and metric
  against the JAX task's.
"""

import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest

from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.data import ar as jar
from gcpnet_tpu.data.native import hybrid_knn_graph_native
from gcpnet_tpu.data.batching import sort_edges_by_receiver as jsort_edges
from gcpnet_tpu.train.metrics import Collector as JCollector
from gcpnet_tpu.utils import external_tools as jexternal
from gcpnet_tpu.utils import structure_metrics as jsm
from gcpnet_torch import tasks
from gcpnet_torch.data import ar
from gcpnet_torch.data.ar_synthetic import write_ar_pairs, write_pair
from gcpnet_torch.train.metrics import Collector
from gcpnet_torch.utils import structure_metrics as sm

PAIRS = {"train": 4, "valid": 2, "test": 2}
DATA = dict(k_max=16, batch_size=1, max_nodes_per_batch=700, max_residues_per_batch=80)
# the sorted forms a port batch adds to the JAX module's arrays
PORT_ONLY = ("sender_perm", "sender_inv_perm", "sender_splits", "graph_splits")


@pytest.fixture(scope="module")
def ar_root(tmp_path_factory) -> str:
    """Synthetic pairs of 30-60 residues, and a train decoy with no atoms
    (it fails to parse) listed second."""
    root = str(tmp_path_factory.mktemp("ar"))
    write_ar_pairs(root, seed=1, pairs=PAIRS, train_residues=(30, 60), eval_residues=(30, 60))
    with open(os.path.join(root, "AF2_model", "bad.pdb"), "w") as f:
        f.write("END\n")
    path = os.path.join(root, "splits", "train1.lst")
    with open(path) as f:
        names = f.read().split()
    with open(path, "w") as f:
        f.write("\n".join(names[:1] + ["bad"] + names[1:]) + "\n")
    return root


@pytest.fixture
def small_crop(monkeypatch):
    monkeypatch.setattr(jar, "TRAINING_SEQUENCE_CROP_LENGTH", 20)
    monkeypatch.setattr(ar, "TRAINING_SEQUENCE_CROP_LENGTH", 20)


# --- the hybrid kNN graph -------------------------------------------------------


@pytest.mark.parametrize("n,k_min,k_max,rounding", [
    (300, 12, 128, 1), (700, 12, 128, None), (2000, 12, 16, 1), (10, 12, 128, None), (120, 3, 8, 0),
])
def test_hybrid_knn_edges_match_native(n, k_min, k_max, rounding):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n, 3)) * 6).astype(np.float32)
    if rounding is not None:
        x = np.round(x, rounding)  # ties in distance, at the k-th neighbour too
    x[n // 2] = x[n // 3]  # a repeated atom
    got = ar.hybrid_knn_edges(x, k_min, k_max)
    # the library itself: the JAX function falls back to an N x N path when it cannot load
    want = hybrid_knn_graph_native(x, k_min, k_max)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# --- featurization --------------------------------------------------------------


def _assert_graphs_equal(got, want, label):
    for name in ("h", "chi", "e", "xi", "x", "senders", "receivers", "node_mask"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, f"{label} {name}"
            continue
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
    assert sorted(got.extras) == sorted(want.extras), label
    for key in got.extras:
        np.testing.assert_array_equal(got.extras[key], want.extras[key], err_msg=f"{label} {key}")


@pytest.mark.parametrize("variant", ["whole", "range", "backbone"])
def test_featurize_refinement_pair_matches_jax(ar_root, variant):
    cache = os.path.join(ar_root, "model_data_cache", "esm")
    kw = dict(esm_cache_dir=cache, k_max=16)
    if variant == "range":
        kw["residue_range"] = (5, 25)
    if variant == "backbone":
        kw["subset_to_backbone_atoms_only"] = True
    for name in ("tr000", "va001"):
        decoy = os.path.join(ar_root, "AF2_model", f"{name}.pdb")
        native = os.path.join(ar_root, "true_model", f"{name}.pdb")
        got = ar.featurize_refinement_pair(decoy, native, **kw)
        _assert_graphs_equal(got, jar.featurize_refinement_pair(decoy, native, **kw), name)
        assert got.h.shape[1] == 1338 and got.e.shape[1] == 29
        # the cache holds the whole chain's ESM rows: a residue range reads zeros
        assert got.h[:, 58:].any() == (variant != "range")
        assert not np.array_equal(got.extras["label"], got.x)  # the native's positions
    with pytest.raises(ValueError, match="no atoms"):
        ar.featurize_refinement_pair(os.path.join(ar_root, "AF2_model", "bad.pdb"), None)


def test_crop_matches_jax(ar_root, small_crop, tmp_path):
    jdm, dm = _datamodules(ar_root, tmp_path)
    for seed in (0, 3, 11):
        got = dm.featurize("tr002", crop=True, seed=seed)
        _assert_graphs_equal(got, jdm._featurize("tr002", crop=True, seed=seed), f"seed {seed}")
        assert int(got.extras["atom_residue_idx"].max()) + 1 == 20
    assert not os.listdir(tmp_path / "port")  # crops are not cached


def test_sliding_windows_match_jax():
    for n in (1, 899, 1499, 1500, 1750, 1751, 2600, 5000):
        got = ar.sliding_windows(n)
        assert got == jar.sliding_windows(n), n
        assert got[0][0] == 0 and got[-1][1] == n
        kept = np.concatenate([np.arange(lo, hi) for _, _, lo, hi in got])
        np.testing.assert_array_equal(kept, np.arange(n))  # every residue kept once


# --- the datamodule -------------------------------------------------------------


def _datamodules(ar_root, tmp_path, **extra):
    kw = dict(splits_dir=os.path.join(ar_root, "splits"), af2_dir=os.path.join(ar_root, "AF2_model"),
              true_dir=os.path.join(ar_root, "true_model"),
              esm_cache_dir=os.path.join(ar_root, "model_data_cache", "esm"), **DATA, **extra)
    jdm = jar.ARDataModule(model_data_cache_dir=str(tmp_path / "jax"), **kw)
    dm = ar.ARDataModule(model_data_cache_dir=str(tmp_path / "port"), **kw)
    os.makedirs(tmp_path / "port", exist_ok=True)
    jdm.setup()
    dm.setup()
    return jdm, dm


def _assert_same_batch(jb, b, label):
    jb = jsort_edges(jb, tile=1)
    for name, array in b.tensors().items():
        if name in PORT_ONLY:
            continue
        want = jb.extras[name[7:]] if name.startswith("extras.") else getattr(jb, name)
        np.testing.assert_array_equal(array, np.asarray(want), err_msg=f"{label} {name}")
    real_e = np.asarray(b.edge_pad_mask)
    n_real = int(real_e.sum())
    assert real_e[b.sender_perm[:n_real]].all() and np.all(np.diff(b.senders[b.sender_perm[:n_real]]) >= 0)
    np.testing.assert_array_equal(b.sender_perm[b.sender_inv_perm], np.arange(b.num_edges))


def _assert_same_batches(jbatches, batches, label):
    jbatches, batches = list(jbatches), list(batches)
    assert len(batches) == len(jbatches) > 0, label
    for i, (jb, b) in enumerate(zip(jbatches, batches)):
        _assert_same_batch(jb, b, f"{label} {i}")


def test_datamodule_matches_jax(ar_root, small_crop, tmp_path):
    jdm, dm = _datamodules(ar_root, tmp_path)
    assert dm.splits == jdm.splits and [len(dm.splits[k]) for k in ("train", "valid", "test")] == [5, 2, 2]
    for seed in (0, 1, 2):
        _assert_same_batches(jdm.train_batches(seed=seed), dm.train_batches(seed=seed), f"train {seed}")
    _assert_same_batches(jdm.val_batches(), dm.val_batches(), "val")
    _assert_same_batches(jdm.test_batches(), dm.test_batches(), "test")
    assert dm._featurized["train"] == [0, 2, 3, 4]  # the decoy without atoms left out
    cached = sorted(os.listdir(tmp_path / "port"))
    assert len(cached) == 4 and all(name.endswith(".graph.npz") for name in cached)
    again = ar.ARDataModule(
        splits_dir=dm.splits_dir, af2_dir=dm.af2_dir, true_dir=dm.true_dir,
        model_data_cache_dir=str(tmp_path / "port"), esm_cache_dir=os.devnull, **DATA,
    )
    again.setup()
    first, cached = list(dm.val_batches()), list(again.val_batches())
    assert len(first) == len(cached) == 2
    for b, c in zip(first, cached):
        assert b.node_mask is None and c.node_mask is None  # as the JAX module's graphs
        for (name, x), y in zip(b.tensors().items(), c.tensors().values()):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_globalize_ar_residues_matches_jax(ar_root, tmp_path):
    """Three decoys in one batch: residue indices offset graph by graph,
    their Ca rows back to back, the residue budget enforced."""
    jdm, dm = _datamodules(ar_root, tmp_path)
    graphs = [dm.featurize(name) for name in ("va000", "va001", "te000")]
    from gcpnet_torch.data.batching import Bucket, collate_shards

    batch = collate_shards([graphs], Bucket(2000, 2000 * 40, 4))
    got = ar.globalize_ar_residues(batch, 200)
    want = jar._globalize_ar_residues(batch, 200, num_shards=1)
    for key in ("atom_residue_idx", "ca_x"):
        np.testing.assert_array_equal(got.extras[key], want.extras[key], err_msg=key)
    assert "ca_x_local" not in got.extras
    n_res = sum(int(g.extras["atom_residue_idx"].max()) + 1 for g in graphs)
    assert int(got.extras["atom_residue_idx"].max()) + 1 == n_res and not got.extras["ca_x"][n_res:].any()
    with pytest.raises(ValueError, match="residues"):
        ar.globalize_ar_residues(batch, n_res - 1)


# --- prediction -----------------------------------------------------------------


@pytest.fixture
def small_windows(monkeypatch):
    for module in (jar, ar):
        monkeypatch.setattr(module, "INFERENCE_WINDOW", 24)
        monkeypatch.setattr(module, "INFERENCE_SHIFT", 18)
        monkeypatch.setattr(module, "INFERENCE_MIN_SPLIT_LEN", 40)


def test_record_predictions_matches_jax(ar_root, small_windows, tmp_path):
    """Two decoys of 50 and 30 residues: three windows and one; the
    predictions (random offsets from the decoy) written stitched, the same
    file and score row from both packages."""
    inputs, natives = tmp_path / "in", tmp_path / "native"
    rng = np.random.default_rng(4)
    for name, residues in (("long", 50), ("short", 30)):
        write_pair(str(tmp_path), name, rng, residues, esm=False)
    os.makedirs(inputs)
    os.makedirs(natives)
    for name in ("long", "short"):
        os.replace(tmp_path / "AF2_model" / f"{name}.pdb", inputs / f"{name}.pdb")
        os.replace(tmp_path / "true_model" / f"{name}.pdb", natives / f"{name}.pdb")
    kw = dict(predict_input_dir=str(inputs), predict_true_dir=str(natives))
    jdm, dm = _datamodules(ar_root, tmp_path, **kw)
    jbatches, batches = list(jdm.predict_batches()), list(dm.predict_batches())
    assert len(batches) == len(jbatches) == 4
    rows, jrows = [], []
    for out in ("port_out", "jax_out"):
        os.makedirs(tmp_path / out)
    for i, (jb, b) in enumerate(zip(jbatches, batches)):
        _assert_same_batch(jb, b, f"window {i}")
        preds = b.x + rng.normal(size=b.x.shape).astype(np.float32)
        rows += dm.record_predictions(b, preds, str(tmp_path / "port_out"))
        jrows += jdm.record_predictions(jb, preds, str(tmp_path / "jax_out"))
    assert [r["decoy"] for r in rows] == ["long.pdb", "short.pdb"]
    for row, jrow in zip(rows, jrows):
        with open(row["refined_pdb"]) as f, open(jrow["refined_pdb"]) as g:
            assert f.read() == g.read()
        assert sorted(row) == sorted(jrow) and "lDDT" in row and "TM-score" in row
        for key in row:
            if key not in ("decoy", "refined_pdb"):
                np.testing.assert_allclose(row[key], jrow[key], atol=1e-6, err_msg=key)
    # every atom of the long decoy written once, from the window that keeps it
    n_atoms = sum(int(b.extras["overlap_keep_mask"].sum()) for b in batches[:3])
    with open(rows[0]["refined_pdb"]) as f:
        assert sum(line.startswith("ATOM") for line in f) == n_atoms


def test_predict_window_too_large_raises(ar_root, small_windows, tmp_path):
    inputs = tmp_path / "in"
    write_pair(str(tmp_path), "long", np.random.default_rng(0), 50, esm=False)
    os.makedirs(inputs)
    os.replace(tmp_path / "AF2_model" / "long.pdb", inputs / "long.pdb")
    _, dm = _datamodules(ar_root, tmp_path, predict_input_dir=str(inputs))
    dm.max_nodes_per_batch = 100
    with pytest.raises(ValueError, match=r"long\.pdb: window 0 .* 100 nodes"):
        list(dm.predict_batches())


# --- structure scores and metrics -----------------------------------------------


@pytest.mark.parametrize("n", [2, 5, 40, 130])
def test_structure_scores_match_jax(n):
    rng = np.random.default_rng(n)
    native = rng.normal(size=(n, 3)) * 8
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pred = (native + rng.normal(size=(n, 3)) * 1.5) @ rot.T + 3.0
    got, want = sm.structure_scores(pred, native), jsm.structure_scores(pred, native)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    for a, b in zip(sm.kabsch(pred, native), jsm.kabsch(pred, native)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(sm.superimpose(pred, native), jsm.superimpose(pred, native), atol=1e-6)
    np.testing.assert_allclose(sm.rmsd(pred, native, False), jsm.rmsd(pred, native, False), atol=1e-6)


def test_matched_structure_scores_match_jax(ar_root):
    decoy = os.path.join(ar_root, "AF2_model", "va000.pdb")
    native = os.path.join(ar_root, "true_model", "va000.pdb")
    got = sm.matched_structure_scores(decoy, native)
    want = jexternal.calculate_tmscore_metrics(decoy, native)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    assert 0.0 < got["TM-score"] < 1.0 and got["RMSD"] > 0.0


def test_collect_matches_jax(ar_root, tmp_path):
    _, dm = _datamodules(ar_root, tmp_path)
    rng = np.random.default_rng(0)
    got, want = Collector(), JCollector()
    collect = tasks.build_collect("GCPNetAR")
    for batch in dm.val_batches():
        out = rng.random(batch.extras["label"].shape).astype(np.float32)
        collect.add(got, out, collect.keep(batch))
        jtasks.build_collect("GCPNetAR")(want, out, batch)
    fns, jfns = tasks.build_metric_fns("GCPNetAR"), jtasks.build_metric_fns("GCPNetAR")
    assert sorted(fns) == sorted(jfns) == ["RMSE"]
    (p, l, _), (jp, jl, _) = got.cat(), want.cat()
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(l, jl)
    assert {k: fn(p, l) for k, fn in fns.items()} == {k: fn(jp, jl) for k, fn in jfns.items()}
