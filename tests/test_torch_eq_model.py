"""The port's EQ model against the JAX package and the numpy reference, on
the CPU.

- ``GCPNetEQ`` (2 ``GCPInteractions2`` layers of 2-layer GCP3 message
  stacks with scalar message attention and sums over senders, hidden
  16/4/8/4, the 1,281 + 38 node scalars of the data) on a batch of the
  port's datamodule (two synthetic decoys): the per-residue output,
  ``eq_loss`` and every parameter's gradient against ``jax.grad`` of the
  flax model with the same parameters, fp32 atol 1e-4.  The port's batch
  carries the sorted forms of its indices, so its sums and gathers' backward
  run the sorted path that K1 runs on the card.
- The whole model against ``scripts/golden/numpy_reference.eq_forward``
  (the port of ``tests/test_model_golden.py``'s EQ case), fp32 atol 1e-4.
- Invariance: the per-residue output under a random rotation and
  translation of ``x``, ``chi`` and ``xi``.
- The entry point ``--task eq`` on the CPU (a small bucket) and its
  refusal to fall back to the CPU unasked.
"""

import functools
import json
import os
import sys
from pathlib import Path

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

from _torch_parity import load_jax_params, np_, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.graph import GraphBatch as JGraphBatch
from gcpnet_tpu.models.eq import GCPNetEQ as JGCPNetEQ
from gcpnet_tpu.models.eq import eq_loss as j_eq_loss
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import eq
from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.data import registry
from gcpnet_torch.train import cli
from gcpnet_torch.weights import from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts" / "golden"))
import numpy_reference as npref  # noqa: E402

ATOL = 1e-4
EQ_MODEL = dict(
    h_input_dim=1281, chi_input_dim=2, e_input_dim=18, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0, dense_dropout=0.0,
)
EQ_LAYER = dict(use_scalar_message_attention=True, aggregate_with_row=True, num_feedforward_layers=1)
EQ_MESSAGE_LAYERS = 2
DATA = dict(batch_size=2, max_nodes_per_batch=640, max_residues_per_batch=80)


@pytest.fixture(scope="module")
def eq_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("eq"))
    write_eq_decoys(root, seed=2, targets={"train": 2, "valid": 1, "test": 1}, decoys=2, residues=(10, 30))
    return root


def _batch(eq_root):
    dm = eq.EQDataModule.from_data_dir(eq_root, **DATA)
    dm.setup()
    batch = next(dm.val_batches())
    assert batch.graph_pad_mask.all() and batch.sender_splits is not None
    return batch


def _configs(model_cls, module_cls, layer_cls, mp_cls):
    return dict(
        model_cfg=model_cls(**EQ_MODEL), module_cfg=module_cls(selected_gcp="GCP3"),
        layer_cfg=layer_cls(**EQ_LAYER, mp_cfg=mp_cls(num_message_layers=EQ_MESSAGE_LAYERS)),
    )


def _port_model(seed=0):
    return GCPNetEQ(**_configs(ModelCfg, ModuleCfg, LayerCfg, MPCfg), generator=torch.Generator().manual_seed(seed),
                    device="cpu")


def jax_batch(batch) -> JGraphBatch:
    """The port's host batch as the JAX package's (the same arrays)."""
    fields = {name: getattr(batch, name) for name in (
        "h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id", "node_pad_mask", "edge_pad_mask",
        "graph_pad_mask", "node_mask", "edge_row_splits", "extras")}
    return to_jax(JGraphBatch(**fields))


def test_eq_model_matches_jax(eq_root):
    batch = _batch(eq_root)
    jbatch = jax_batch(batch)
    jmodel = JGCPNetEQ(**_configs(JModelCfg, JModuleCfg, JLayerCfg, JMPCfg))
    params = jax.jit(lambda b: jmodel.init(jax.random.key(3), b, True))(jbatch)

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, True)
        return j_eq_loss(out, jbatch)[0], out

    (want_loss, want_out), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = load_jax_params(_port_model(), params)
    tb = batch.to("cpu")
    out = port(tb)
    real = batch.extras["res_mask"] > 0
    np.testing.assert_allclose(np_(out)[real], np.asarray(want_out)[real], atol=ATOL)
    loss, labels = eq_loss(out, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), batch.extras["label"])
    loss.backward()
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert got.keys() == want.keys()
    assert {k.split(".")[0] for k in got} == {"atom_embedding", "encoder", "projection_norm",
                                              "invariant_node_projection", "dense_0", "dense_1"}
    assert any(".scalar_message_attention." in k for k in got) and any(".scalar_out_1." in k for k in got)
    for name, g in got.items():
        np.testing.assert_allclose(np_(g), want[name].numpy(), atol=ATOL, err_msg=name)


def test_eq_matches_numpy_reference():
    """``tests/test_model_golden.py``'s EQ case with the port: two graphs of
    5 residues of 2 atoms, padded and receiver-sorted by the port's
    batching, against the unpadded numpy reference."""
    rng = np.random.default_rng(11)
    num_res, n, e, g_count = 5, 10, 30, 2
    graphs = [
        GraphData(
            h=rng.normal(size=(n, 9)).astype(np.float32), chi=rng.normal(size=(n, 2, 3)).astype(np.float32),
            e=rng.normal(size=(e, 18)).astype(np.float32), xi=rng.normal(size=(e, 1, 3)).astype(np.float32),
            x=(rng.normal(size=(n, 3)) * 4).astype(np.float32),
            senders=rng.integers(0, n, size=e).astype(np.int32), receivers=rng.integers(0, n, size=e).astype(np.int32),
            extras={"atom_types": rng.integers(0, 38, size=n).astype(np.int32),
                    "atom_residue_idx": np.repeat(np.arange(num_res), 2).astype(np.int32),
                    "label": rng.random(num_res).astype(np.float32), "res_mask": np.ones(num_res, np.float32)},
        )
        for _ in range(g_count)
    ]
    bucket = Bucket(num_nodes=n * g_count + 6, num_edges=e * g_count + 13, num_graphs=g_count + 1)
    batch = eq.globalize_residues(next(batches_from_dataset(graphs, bucket)), num_res * g_count + 3)
    cfg = dict(h_input_dim=9, chi_input_dim=2, e_input_dim=18, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
               e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0)
    jmodel = JGCPNetEQ(
        model_cfg=JModelCfg(**cfg), module_cfg=JModuleCfg(selected_gcp="GCP3"),
        layer_cfg=JLayerCfg(**EQ_LAYER, mp_cfg=JMPCfg(num_message_layers=3)),
    )
    params = jmodel.init(jax.random.key(5), jax_batch(batch), True)
    port = load_jax_params(GCPNetEQ(
        ModelCfg(**cfg), ModuleCfg(selected_gcp="GCP3"), LayerCfg(**EQ_LAYER, mp_cfg=MPCfg(num_message_layers=3)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    ), params)
    with torch.no_grad():
        out = port(batch.to("cpu")).numpy()
    off = np.repeat(np.arange(g_count) * n, n)
    want = npref.eq_forward(
        jax.device_get(params)["params"],
        np.concatenate([g.h for g in graphs]).astype(np.float64),
        np.concatenate([g.chi for g in graphs]).astype(np.float64),
        np.concatenate([g.e for g in graphs]).astype(np.float64),
        np.concatenate([g.xi for g in graphs]).astype(np.float64),
        np.concatenate([g.x for g in graphs]).astype(np.float64),
        np.concatenate([g.extras["atom_types"] for g in graphs]),
        np.concatenate([g.extras["atom_residue_idx"] + i * num_res for i, g in enumerate(graphs)]),
        num_res * g_count,
        np.concatenate([g.senders + i * n for i, g in enumerate(graphs)]),
        np.concatenate([g.receivers + i * n for i, g in enumerate(graphs)]),
        off // n, g_count,
        num_atom_types=38, node_in_dims=(9, 2), edge_in_dims=(18, 1), node_dims=(16, 4), edge_dims=(8, 4),
        num_layers=2, num_message_layers=3,
    )
    np.testing.assert_allclose(out[: num_res * g_count], want, atol=ATOL)


def _rotated(batch, seed=0):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    q = q.astype(np.float32)
    shift = rng.normal(scale=10.0, size=3).astype(np.float32)
    return batch.replace(x=batch.x @ q.T + shift, chi=batch.chi @ q.T, xi=batch.xi @ q.T)


def test_eq_output_is_invariant(eq_root):
    batch = _batch(eq_root)
    model = _port_model(seed=1)
    with torch.no_grad():
        out = model(batch.to("cpu")).numpy()
        turned = model(_rotated(batch).to("cpu")).numpy()
    real = batch.extras["res_mask"] > 0
    assert np.abs(out[real]).max() > 1e-3
    np.testing.assert_allclose(turned[real], out[real], atol=ATOL)


def test_eq_entry_point(eq_root, tmp_path, monkeypatch, capsys):
    """``--task eq`` on the CPU: a 1-layer model, a small bucket (the JAX
    module's 8,192 nodes take minutes a step on the CPU), one epoch and the
    test of its checkpoint; without ``--device cpu`` and without a card it
    raises."""
    monkeypatch.setitem(registry.DATAMODULES, "EQDataModule",
                        functools.partial(eq.EQDataModule, max_nodes_per_batch=320, max_residues_per_batch=40))
    cli.main(["--task", "eq", "--device", "cpu", "--data-dir", eq_root, "--num-encoder-layers", "1",
              "--max-epochs", "1", "--min-epochs", "0", "--checkpoint-dir", str(tmp_path / "ckpt")])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines[0]["epoch"] == 0 and np.isfinite(lines[0]["val/PearsonCorrCoef"])
    assert set(lines[-1]) == {"test/loss", "test/RMSE", "test/PearsonCorrCoef", "step"}
    assert os.listdir(tmp_path / "ckpt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--task", "eq", "--data-dir", eq_root])
