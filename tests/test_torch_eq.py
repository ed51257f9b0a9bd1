"""The port's EQ data path against the JAX package, on the CPU.

- ``lddt`` (a ``cKDTree`` pair list) against the JAX function (four ``[N,
  N]`` arrays) at 1e-12: float32 and float64 clouds whose pairs straddle
  the 15 A radius, per residue and global; the matched-atom lDDT of a
  synthetic decoy against the JAX ``generate_lddt_score``'s native path.
- ``parse_pdb``, ``write_pdb`` and ``annotate_pdb_bfactor_column`` against
  the JAX module's: the same records, byte-equal files.
- ``embed_sequence``: the cached file, the zeros (with the JAX function's
  answer the same), ``GCPNET_REQUIRE_ESM``.
- ``featurize_decoy`` array for array, and ``EQDataModule``'s batches
  against the JAX module's (receiver-sorted to the port's CSR layout),
  with a train decoy that fails to featurize: three shuffle seeds, the
  evaluation splits, the residue bookkeeping; the sorted forms of the
  senders and of the residue index the port adds; the graph cache.
- EQ's collect and metrics against the JAX task's.

The JAX radius graph runs on its scipy path, the port's reference.
"""

import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest

import gcpnet_tpu.data.native as jnative
from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.data import eq as jeq
from gcpnet_tpu.data import esm as jesm
from gcpnet_tpu.data import pdb as jpdb
from gcpnet_tpu.data.batching import sort_edges_by_receiver as jsort_edges
from gcpnet_tpu.train.metrics import Collector as JCollector
from gcpnet_tpu.utils.external_tools import generate_lddt_score
from gcpnet_tpu.utils.structure_metrics import lddt as jlddt
from gcpnet_torch import tasks
from gcpnet_torch.data import eq, esm, pdb
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.train.metrics import Collector
from gcpnet_torch.utils.structure_metrics import lddt, matched_lddt

TARGETS = {"train": 3, "valid": 1, "test": 1}
DATA = dict(batch_size=2, max_nodes_per_batch=512, max_residues_per_batch=64)
# the sorted forms a port batch adds to the JAX module's arrays
PORT_ONLY = ("sender_perm", "sender_inv_perm", "sender_splits", "graph_splits",
             *(f"extras.{k}" for k in eq.RESIDUE_INDEX_KEYS))


@pytest.fixture(autouse=True)
def scipy_radius_graph(monkeypatch):
    def unavailable(*args, **kwargs):
        raise RuntimeError("the native radius graph is off in these tests")

    monkeypatch.setattr(jnative, "radius_graph_native", unavailable)


@pytest.fixture(scope="module")
def eq_root(tmp_path_factory) -> str:
    """Synthetic decoys of 10-30 residues, and a train decoy with no atoms
    (it fails to featurize) listed second."""
    root = str(tmp_path_factory.mktemp("eq"))
    write_eq_decoys(root, seed=1, targets=TARGETS, decoys=2, residues=(10, 30))
    with open(os.path.join(root, "decoy_model", "bad_d00.pdb"), "w") as f:
        f.write("END\n")
    path = os.path.join(root, "splits", "train.lst")
    with open(path) as f:
        names = f.read().split()
    with open(path, "w") as f:
        f.write("\n".join(names[:1] + ["bad_d00"] + names[1:]) + "\n")
    return root


# --- lDDT ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lddt_matches_jax(dtype):
    rng = np.random.default_rng(5)
    for n in (1, 7, 90):
        native = (rng.random((n, 3)) * 22.0).astype(dtype)
        pred = (native + rng.normal(scale=1.5, size=(n, 3))).astype(dtype)
        res = np.sort(rng.integers(0, max(1, n // 3), size=n))
        res = np.unique(res, return_inverse=True)[1]
        for per_residue in (True, False):
            want = jlddt(pred, native, residue_index=res, per_residue=per_residue)
            got = lddt(pred, native, residue_index=res, per_residue=per_residue)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(lddt(pred, native), jlddt(pred, native), rtol=0, atol=1e-12)


def test_matched_lddt_matches_jax(eq_root):
    decoy = os.path.join(eq_root, "decoy_model", "tr000_d01.pdb")
    native = os.path.join(eq_root, "true_model", "tr000.pdb")
    want = generate_lddt_score(decoy, native, None, per_residue=True)
    got = matched_lddt(decoy, native, per_residue=True)
    assert got.shape == want.shape and 0.0 < got.mean() < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --- PDB files and ESM embeddings ---------------------------------------------


def test_pdb_io_matches_jax(eq_root, tmp_path):
    path = os.path.join(eq_root, "decoy_model", "te000_d00.pdb")
    got, want = pdb.parse_pdb(path, heavy_only=True), jpdb.parse_pdb(path, heavy_only=True)
    assert [vars(a) for a in got.atoms] == [vars(a) for a in want.atoms]
    np.testing.assert_array_equal(got.residue_index(), want.residue_index())
    np.testing.assert_array_equal(got.coords, want.coords)
    pdb.write_structure(str(tmp_path / "port.pdb"), got)
    jpdb.write_structure(str(tmp_path / "jax.pdb"), want)
    assert (tmp_path / "port.pdb").read_bytes() == (tmp_path / "jax.pdb").read_bytes()
    values = {(a.chain, a.resseq, a.icode): 0.5 * a.resseq for a in got.atoms[::5]}
    pdb.annotate_pdb_bfactor_column(path, str(tmp_path / "port.pdb"), values)
    jpdb.annotate_pdb_bfactor_column(path, str(tmp_path / "jax.pdb"), values)
    assert (tmp_path / "port.pdb").read_bytes() == (tmp_path / "jax.pdb").read_bytes()


def test_embed_sequence_tiers(tmp_path, monkeypatch, caplog):
    monkeypatch.delenv("GCPNET_REQUIRE_ESM", raising=False)
    monkeypatch.delenv("GCPNET_ESM_CHECKPOINT", raising=False)
    cached = np.random.default_rng(0).normal(size=(5, esm.ESM_EMBEDDING_DIM)).astype(np.float32)
    np.save(tmp_path / f"{esm.seq_key('ACDEF')}.npy", cached)
    for fn in (esm.embed_sequence, jesm.embed_sequence):
        np.testing.assert_array_equal(fn("ACDEF", cache_dir=str(tmp_path)), cached)
    monkeypatch.setattr(esm, "_warned", False)
    zeros = esm.embed_sequence("GHIK", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(zeros, jesm.embed_sequence("GHIK", cache_dir=str(tmp_path)))
    assert zeros.shape == (4, 1280) and not zeros.any()
    assert "zero embeddings" in caplog.text
    monkeypatch.setenv("GCPNET_REQUIRE_ESM", "1")
    with pytest.raises(RuntimeError, match="GCPNET_REQUIRE_ESM"):
        esm.embed_sequence("GHIK", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(esm.embed_sequence("ACDEF", cache_dir=str(tmp_path)), cached)


# --- featurization and batches ------------------------------------------------


def _assert_graphs_equal(got, want, label):
    for name in ("h", "chi", "e", "xi", "x", "senders", "receivers", "node_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=f"{label} {name}")
    assert sorted(got.extras) == sorted(want.extras), label
    for key in got.extras:
        np.testing.assert_array_equal(got.extras[key], want.extras[key], err_msg=f"{label} {key}")


def test_featurize_decoy_matches_jax(eq_root):
    cache = os.path.join(eq_root, "model_data_cache", "esm")
    for name in ("tr001_d00", "va000_d01"):
        decoy = os.path.join(eq_root, "decoy_model", f"{name}.pdb")
        native = os.path.join(eq_root, "true_model", f"{name.split('_')[0]}.pdb")
        got = eq.featurize_decoy(decoy, native, esm_cache_dir=cache)
        want = jeq.featurize_decoy(decoy, native, esm_cache_dir=cache)
        _assert_graphs_equal(got, want, name)
        assert got.h[:, :-1].any() and 0.0 < got.extras["label"].mean() < 1.0  # cached ESM rows, real labels
    unlabelled = eq.featurize_decoy(decoy, None, esm_cache_dir=cache)
    assert not unlabelled.extras["label"].any()
    with pytest.raises(ValueError, match="no atoms"):
        eq.featurize_decoy(os.path.join(eq_root, "decoy_model", "bad_d00.pdb"), None)


def _datamodules(eq_root, tmp_path):
    kw = dict(splits_dir=os.path.join(eq_root, "splits"), decoy_dir=os.path.join(eq_root, "decoy_model"),
              true_dir=os.path.join(eq_root, "true_model"), esm_cache_dir=os.path.join(eq_root, "model_data_cache",
                                                                                       "esm"), **DATA)
    jdm = jeq.EQDataModule(model_data_cache_dir=str(tmp_path / "jax"), **kw)
    dm = eq.EQDataModule(model_data_cache_dir=str(tmp_path / "port"), **kw)
    jdm.setup()
    dm.setup()
    return jdm, dm


def _assert_same_batches(jbatches, batches, label):
    jbatches, batches = list(jbatches), list(batches)
    assert len(batches) == len(jbatches) > 0, label
    for jb, b in zip(jbatches, batches):
        jb = jsort_edges(jb, tile=1)
        for name, array in b.tensors().items():
            if name in PORT_ONLY:
                continue
            want = jb.extras[name[7:]] if name.startswith("extras.") else getattr(jb, name)
            np.testing.assert_array_equal(array, np.asarray(want), err_msg=f"{label} {name}")
        real_e, real_n = np.asarray(b.edge_pad_mask), np.asarray(b.node_pad_mask)
        # the sorted forms: the real rows in index order, the padding after
        for index, valid, perm, splits in (
            (b.senders, real_e, b.sender_perm, b.sender_splits),
            (b.extras["atom_residue_idx"], real_n, b.extras["residue_perm"], b.extras["residue_splits"]),
        ):
            n_real = int(valid.sum())
            assert valid[perm[:n_real]].all() and np.all(np.diff(index[perm[:n_real]]) >= 0), label
            np.testing.assert_array_equal(np.diff(splits), np.bincount(index[valid], minlength=splits.shape[0] - 1))
        np.testing.assert_array_equal(b.sender_perm[b.sender_inv_perm], np.arange(b.num_edges))


def test_datamodule_matches_jax(eq_root, tmp_path):
    jdm, dm = _datamodules(eq_root, tmp_path)
    assert dm.splits == jdm.splits and [len(v) for v in dm.splits.values()] == [7, 2, 2]
    for seed in (0, 1, 2):
        _assert_same_batches(jdm.train_batches(seed=seed), dm.train_batches(seed=seed), f"train {seed}")
    _assert_same_batches(jdm.val_batches(), dm.val_batches(), "val")
    _assert_same_batches(jdm.test_batches(), dm.test_batches(), "test")
    assert dm._featurized["train"] == [0, 2, 3, 4, 5, 6]  # the decoy without atoms left out
    cached = sorted(os.listdir(tmp_path / "port"))
    assert len(cached) == 10 and all(name.endswith(".graph.npz") for name in cached)
    # a second module reads the graphs from the cache: the same batches
    again = eq.EQDataModule(
        splits_dir=dm.splits_dir, decoy_dir=dm.decoy_dir, true_dir=dm.true_dir,
        model_data_cache_dir=str(tmp_path / "port"), esm_cache_dir=os.devnull, **DATA,
    )
    again.setup()
    for b, c in zip(dm.val_batches(), again.val_batches()):
        for (name, x), y in zip(b.tensors().items(), c.tensors().values()):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_collect_matches_jax(eq_root, tmp_path):
    _, dm = _datamodules(eq_root, tmp_path)
    rng = np.random.default_rng(0)
    got, want = Collector(), JCollector()
    collect = tasks.build_collect("GCPNetEQ")
    for batch in dm.val_batches():
        out = rng.random(batch.extras["label"].shape).astype(np.float32)
        collect.add(got, out, collect.keep(batch))
        jtasks.build_collect("GCPNetEQ")(want, out, batch)
    fns, jfns = tasks.build_metric_fns("GCPNetEQ"), jtasks.build_metric_fns("GCPNetEQ")
    assert sorted(fns) == sorted(jfns) == ["PearsonCorrCoef", "RMSE"]
    (p, l, _), (jp, jl, _) = got.cat(), want.cat()
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(l, jl)
    assert p.shape[0] == sum(int(b.extras["res_mask"].sum()) for b in dm.val_batches())
    assert {k: fn(p, l) for k, fn in fns.items()} == {k: fn(jp, jl) for k, fn in jfns.items()}
