"""The same model from the same config: for each non-ablation experiment
(LBA, PSR, NMS small_20body, RS, CPD, EQ, AR), composed from ``configs/``
at a small width by overrides, the JAX ``tasks.build_model`` and the
port's ``tasks.build_model`` build the same model: with the JAX parameters
carried by ``gcpnet_torch/weights.py``, one seeded batch (made by the
port's datamodule of the composed block, on tiny synthetic data) gives the
same output and loss at fp32 atol 1e-4.  The JAX model runs its plain
path (the batch without row splits), the port's model on the CPU its
kernels' plain versions.  And LBA's affinity is invariant under a rotation
and translation of the complex (``tests/test_model_equivariance.py:73`` on
the port)."""

import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

import gcpnet_tpu.data.native as jnative
from _torch_parity import load_jax_params, np_, to_jax
from chip_smoke import write_lba_records, write_psr_records
from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.config.loader import compose as jcompose
from gcpnet_tpu.graph import GraphBatch as JGraphBatch
from gcpnet_torch import tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.data.ar_synthetic import write_ar_pairs
from gcpnet_torch.data.cath_synthetic import write_cath_chains
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.data.registry import build_datamodule

ATOL = 1e-4
SMALL = [
    "model.model_cfg.h_hidden_dim=16", "model.model_cfg.chi_hidden_dim=4", "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=4", "model.model_cfg.num_encoder_layers=2", "model.model_cfg.num_decoder_layers=1",
    "model.layer_cfg.mp_cfg.num_message_layers=2", "datamodule.batch_size=2",
]


def _data(task: str, root: str) -> list:
    """Tiny synthetic data for ``task`` under ``root``, and the overrides
    that point its experiment's datamodule there (with a small bucket)."""
    if task == "lba":
        write_lba_records(os.path.join(root, "ATOM3D"), complexes={"train": 1, "val": 2, "test": 1},
                          pocket_atoms=(40, 60), ligand_atoms=(8, 12))
        return [f"paths.data_dir={root}/", "+datamodule.max_nodes_per_batch=256"]
    if task == "psr":
        write_psr_records(root, targets={"train": 1, "val": 1, "test": 1}, decoys=2, atoms=(30, 50))
        return [f"datamodule.data_dir={root}", "+datamodule.max_nodes_per_batch=256"]
    if task == "nms":
        return [f"datamodule.data_dir={root}", "datamodule.data_mode=small", "+datamodule.num_train=2",
                "+datamodule.num_valid=2", "+datamodule.num_test=2"]
    if task == "rs":
        return ["+datamodule.synthetic_sizes={train: 8, valid: 4, test: 4}"]
    if task == "cpd":
        write_cath_chains(root, chains={"train": 2, "validation": 2, "test": 2}, lengths=(20, 30))
        return [f"datamodule.data_dir={root}", "+datamodule.max_nodes_per_batch=128"]
    dirs = {"splits_dir": "splits", "true_dir": "true_model", "model_data_cache_dir": "model_data_cache"}
    if task == "eq":
        write_eq_decoys(root, targets={"train": 1, "valid": 1, "test": 1}, decoys=2, residues=(10, 20))
        dirs["decoy_dir"] = "decoy_model"
        small = ["+datamodule.max_nodes_per_batch=400", "+datamodule.max_residues_per_batch=48"]
    else:
        write_ar_pairs(root, pairs={"train": 1, "valid": 2, "test": 1}, train_residues=(10, 20),
                       eval_residues=(10, 20))
        dirs["af2_dir"] = "AF2_model"
        small = ["datamodule.k_max=16", "+datamodule.max_nodes_per_batch=400", "+datamodule.max_residues_per_batch=48"]
    return [f"datamodule.{k}={os.path.join(root, d)}" for k, d in dirs.items()] + small


def jax_batch(batch) -> JGraphBatch:
    """The port's host batch as the JAX package's, without row splits (the
    JAX model's plain path)."""
    fields = {name: getattr(batch, name) for name in (
        "h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id", "node_pad_mask", "edge_pad_mask",
        "graph_pad_mask", "node_mask", "extras")}
    return to_jax(JGraphBatch(**fields, edge_row_splits=None))


def _real(name: str, batch) -> np.ndarray:
    if name in ("GCPNetLBA", "GCPNetPSR", "GCPNetRS"):
        return np.asarray(batch.graph_pad_mask)
    if name == "GCPNetEQ":
        return np.asarray(batch.extras["res_mask"]) > 0
    return np.asarray(batch.node_pad_mask)


@pytest.fixture
def scipy_radius_graph(monkeypatch):
    def unavailable(*args, **kwargs):
        raise RuntimeError("the native radius graph is off in these tests")

    monkeypatch.setattr(jnative, "radius_graph_native", unavailable)


@pytest.mark.parametrize("task,experiment", [
    ("lba", "gcpnet_lba"), ("psr", "gcpnet_psr"), ("nms", "gcpnet_nms_small_20body"), ("rs", "gcpnet_rs"),
    ("cpd", "gcpnet_cpd"), ("eq", "gcpnet_eq"), ("ar", "gcpnet_ar"),
])
def test_the_same_model_from_the_same_config(tmp_path, scipy_radius_graph, task, experiment):
    overrides = [f"experiment={experiment}", *SMALL, *_data(task, str(tmp_path)), "trainer.accelerator=cpu"]
    cfg = compose(CONFIG_DIR, "train.yaml", overrides)
    assert cfg == jcompose(CONFIG_DIR, "train.yaml", overrides)
    dm = build_datamodule(cfg["datamodule"], device="cpu")
    dm.prepare_data()
    dm.setup()
    batch = next(iter(dm.val_batches()))
    jmodel, jname = jtasks.build_model(cfg["model"])
    jb = jax_batch(batch)
    params = jax.jit(lambda b: jmodel.init(jax.random.key(0), b, True))(jb)
    jout = jax.jit(lambda p, b: jmodel.apply(p, b, True))(params, jb)
    jloss = float(jtasks.build_loss(jname)(jout, jb)[0])
    model, name = tasks.build_model(cfg["model"], device="cpu")
    assert name == jname and type(model).__name__ == type(jmodel).__name__
    load_jax_params(model, params)
    with torch.no_grad():
        tb = batch.to("cpu")
        out = model(tb)
        loss = tasks.build_loss(name)(out, tb)[0].item()
    want = np.asarray(jout[0] if isinstance(jout, tuple) else jout)
    real = _real(name, batch)
    assert np.abs(want[real]).max() > 1e-3
    np.testing.assert_allclose(np_(out)[real], want[real], atol=ATOL)
    np.testing.assert_allclose(loss, jloss, atol=ATOL)


def test_lba_affinity_is_invariant(tmp_path):
    """A rotated and translated complex (x, chi and xi turned) gives the
    same affinity at fp32 atol 1e-4, the ligand flag riding along."""
    overrides = ["experiment=gcpnet_lba", *SMALL, *_data("lba", str(tmp_path)), "trainer.accelerator=cpu"]
    cfg = compose(CONFIG_DIR, "train.yaml", overrides)
    dm = build_datamodule(cfg["datamodule"])
    dm.setup()
    batch = next(iter(dm.val_batches()))
    assert batch.extras["lig_flag"].any()
    rng = np.random.default_rng(5)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:  # a rotation, not a reflection: the frames are SE(3)-equivariant
        q[:, 0] = -q[:, 0]
    q = q.astype(np.float32)
    turned = batch.replace(x=batch.x @ q.T + rng.normal(scale=10.0, size=3).astype(np.float32),
                           chi=batch.chi @ q.T, xi=batch.xi @ q.T)
    model, _ = tasks.build_model(cfg["model"], device="cpu")
    real = np.asarray(batch.graph_pad_mask)
    with torch.no_grad():
        out = model(batch.to("cpu")).numpy()[real]
        again = model(turned.to("cpu")).numpy()[real]
    assert np.abs(out).max() > 1e-3
    np.testing.assert_allclose(again, out, atol=ATOL)
