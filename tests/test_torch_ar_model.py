"""The port's AR model against the JAX package and the numpy reference, on
the CPU.

- ``GCPInteractions2`` with the position update (GCP3, silu on scalars and
  vectors, scalar message attention, sums over senders), with and without
  a node mask: the new node rep and positions against the flax layer with
  the same parameters, fp32 atol 1e-4.
- ``GCPNetAR`` (2 layers of 2-layer message stacks, hidden 16/8/8/4, the
  1,338 node and 29 edge scalars of the data) on a batch of the port's
  datamodule (two synthetic pairs): the positions, ``ar_loss`` and every
  parameter's gradient against ``jax.grad`` of the flax model, fp32 atol
  1e-4.  The port's batch carries the sorted forms of its indices, so its
  sums, the gathers' backward and the stacks (the plain version of K2 and
  K3) run the path that K1-K3 run on the card.
- The whole model against ``scripts/golden/numpy_reference.ar_forward``
  (``tests/test_model_golden.py``'s AR case), fp32 atol 1e-4.
- Equivariance: AR's positions and NMS's positions (the port of
  ``tests/test_model_equivariance.py``'s NMS case) under a random rotation
  and translation of the inputs.
- The entry point ``--task ar`` on the CPU (a small bucket), and
  ``python -m gcpnet_torch.predict_ar`` on its checkpoint; both refuse to
  fall back to the CPU unasked.
"""

import csv
import json
import os
import sys
from pathlib import Path

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_jax_params, np_, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.graph import GraphBatch as JGraphBatch
from gcpnet_tpu.models.ar import GCPNetAR as JGCPNetAR
from gcpnet_tpu.models.ar import ar_loss as j_ar_loss
from gcpnet_tpu.nn.interactions import GCPInteractions2 as JGCPInteractions2
from gcpnet_tpu.nn.primitives import ScalarVector as JScalarVector
from gcpnet_torch import predict_ar
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import ar
from gcpnet_torch.data.ar_synthetic import write_ar_pairs
from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.ar import GCPNetAR, ar_loss
from gcpnet_torch.models.nms import GCPNetNMS
from gcpnet_torch.nn.interactions import GCPInteractions2
from gcpnet_torch.nn.primitives import ScalarVector
from gcpnet_torch.data import registry
from gcpnet_torch.train import cli
from gcpnet_torch.weights import from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts" / "golden"))
import numpy_reference as npref  # noqa: E402

ATOL = 1e-4
AR_MODEL = dict(
    h_input_dim=1338, chi_input_dim=2, e_input_dim=29, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=8,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0,
)
AR_MODULE = dict(selected_gcp="GCP3", scalar_nonlinearity="silu", vector_nonlinearity="silu")
AR_LAYER = dict(use_scalar_message_attention=True, aggregate_with_row=True, num_feedforward_layers=1, dropout=0.0)
AR_MESSAGE_LAYERS = 2
DATA = dict(k_max=16, batch_size=2, max_nodes_per_batch=1200, max_residues_per_batch=140)


@pytest.fixture(scope="module")
def ar_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("ar"))
    write_ar_pairs(root, seed=2, pairs={"train": 2, "valid": 2, "test": 1}, train_residues=(30, 60),
                   eval_residues=(30, 60))
    return root


def _batch(ar_root):
    dm = ar.ARDataModule.from_data_dir(ar_root, **DATA)
    dm.setup()
    batch = next(dm.val_batches())
    assert batch.graph_pad_mask.all() and batch.sender_splits is not None and batch.edge_row_splits is not None
    return batch


def _configs(model_cls, module_cls, layer_cls, mp_cls, **model):
    return dict(
        model_cfg=model_cls(**{**AR_MODEL, **model}), module_cfg=module_cls(**AR_MODULE),
        layer_cfg=layer_cls(**AR_LAYER, mp_cfg=mp_cls(num_message_layers=AR_MESSAGE_LAYERS)),
    )


def _port_model(seed=0, **model):
    return GCPNetAR(**_configs(ModelCfg, ModuleCfg, LayerCfg, MPCfg, **model),
                    generator=torch.Generator().manual_seed(seed), device="cpu")


def jax_batch(batch) -> JGraphBatch:
    """The port's host batch as the JAX package's (the same arrays)."""
    fields = {name: getattr(batch, name) for name in (
        "h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id", "node_pad_mask", "edge_pad_mask",
        "graph_pad_mask", "node_mask", "edge_row_splits", "extras")}
    return to_jax(JGraphBatch(**fields))


@pytest.mark.parametrize("node_mask", [False, True])
def test_interactions2_position_update_matches_flax(node_mask):
    rng = np.random.default_rng(7)
    n, e, nd, ed = 30, 140, (12, 8), (8, 4)
    ns, nv = rng.normal(size=(n, nd[0])), rng.normal(size=(n, 3 * nd[1]))
    es, ev = rng.normal(size=(e, ed[0])), rng.normal(size=(e, 3 * ed[1]))
    senders, receivers = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
    frames = rng.normal(size=(e, 9))
    pos = rng.normal(size=(n, 3)) * 5
    f32 = [np.asarray(a, np.float32) for a in (ns, nv, es, ev, frames, pos)]
    ns, nv, es, ev, frames, pos = f32
    mask = rng.random(n) > 0.2 if node_mask else None
    cfg = dict(AR_MODULE, node_positions_weight=0.7)
    layer = dict(AR_LAYER, mp_cfg=dict(num_message_layers=3))
    jmod = JGCPInteractions2(
        node_dims=nd, edge_dims=ed, cfg=JModuleCfg(**cfg),
        layer_cfg=JLayerCfg(**{**layer, "mp_cfg": JMPCfg(**layer["mp_cfg"])}), dropout=0.0,
        updating_node_positions=True,
    )
    jargs = (JScalarVector(jnp.asarray(ns), jnp.asarray(nv)), JScalarVector(jnp.asarray(es), jnp.asarray(ev)),
             jnp.asarray(senders), jnp.asarray(receivers), jnp.asarray(frames))
    jkw = dict(node_pos=jnp.asarray(pos), node_mask=None if mask is None else jnp.asarray(mask))
    variables = jmod.init(jax.random.key(0), *jargs, **jkw)
    want_rep, want_pos = jmod.apply(variables, *jargs, **jkw)
    port = load_jax_params(GCPInteractions2(
        nd, ed, ModuleCfg(**cfg), LayerCfg(**{**layer, "mp_cfg": MPCfg(**layer["mp_cfg"])}), dropout=0.0,
        updating_node_positions=True, generator=torch.Generator().manual_seed(0), device="cpu",
    ), variables)
    t = torch.from_numpy
    with torch.no_grad():
        rep, got_pos = port(ScalarVector(t(ns), t(nv)), ScalarVector(t(es), t(ev)), t(senders), t(receivers),
                            t(frames), node_mask=None if mask is None else t(mask), node_pos=t(pos))
    np.testing.assert_allclose(rep.scalar.numpy(), np.asarray(want_rep.scalar), atol=ATOL)
    np.testing.assert_allclose(rep.vector.numpy(), np.asarray(want_rep.vector).reshape(n, -1), atol=ATOL)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), atol=ATOL)
    assert np.abs(got_pos.numpy() - pos).max() > 1e-2  # the positions moved
    if mask is not None:
        assert not got_pos.numpy()[~mask].any()


def test_ar_model_matches_jax(ar_root):
    batch = _batch(ar_root)
    jbatch = jax_batch(batch)
    jmodel = JGCPNetAR(**_configs(JModelCfg, JModuleCfg, JLayerCfg, JMPCfg))
    params = jax.jit(lambda b: jmodel.init(jax.random.key(3), b, True))(jbatch)

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, True)
        return j_ar_loss(out, jbatch)[0], out

    (want_loss, want_out), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = load_jax_params(_port_model(), params)
    tb = batch.to("cpu")
    out = port(tb)
    real = np.asarray(batch.node_pad_mask)
    np.testing.assert_allclose(np_(out)[real], np.asarray(want_out)[real], atol=ATOL)
    loss, labels = ar_loss(out, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), batch.extras["label"])
    loss.backward()
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert got.keys() == want.keys()
    assert any(".node_position_update_gcp." in k for k in got) and any(".scalar_message_attention." in k for k in got)
    for name, g in got.items():
        np.testing.assert_allclose(np_(g), want[name].numpy(), atol=ATOL, err_msg=name)


def test_ar_matches_numpy_reference():
    """``tests/test_model_golden.py``'s AR case with the port: two graphs of
    5 residues of 3 atoms, padded and receiver-sorted by the port's
    batching, against the unpadded numpy reference."""
    rng = np.random.default_rng(13)
    num_res, n, e, g_count = 5, 15, 40, 2
    graphs = [
        GraphData(
            h=rng.normal(size=(n, 10)).astype(np.float32), chi=rng.normal(size=(n, 2, 3)).astype(np.float32),
            e=rng.normal(size=(e, 12)).astype(np.float32), xi=rng.normal(size=(e, 1, 3)).astype(np.float32),
            x=(rng.normal(size=(n, 3)) * 4).astype(np.float32),
            senders=rng.integers(0, n, size=e).astype(np.int32), receivers=rng.integers(0, n, size=e).astype(np.int32),
            extras={"atom_residue_idx": np.repeat(np.arange(num_res), 3).astype(np.int32),
                    "ca_x_local": (rng.normal(size=(num_res, 3)) * 4).astype(np.float32),
                    "label": (rng.normal(size=(n, 3)) * 4).astype(np.float32)},
        )
        for _ in range(g_count)
    ]
    bucket = Bucket(num_nodes=n * g_count + 6, num_edges=e * g_count + 13, num_graphs=g_count + 1)
    batch = ar.globalize_ar_residues(next(batches_from_dataset(graphs, bucket)), num_res * g_count + 3)
    cfg = dict(h_input_dim=10, chi_input_dim=2, e_input_dim=12, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
               e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0)
    layer = dict(use_scalar_message_attention=True, aggregate_with_row=True, num_feedforward_layers=1)
    jmodel = JGCPNetAR(model_cfg=JModelCfg(**cfg), module_cfg=JModuleCfg(**AR_MODULE),
                       layer_cfg=JLayerCfg(**layer, mp_cfg=JMPCfg(num_message_layers=3)))
    params = jmodel.init(jax.random.key(9), jax_batch(batch), True)
    port = load_jax_params(GCPNetAR(
        ModelCfg(**cfg), ModuleCfg(**AR_MODULE), LayerCfg(**layer, mp_cfg=MPCfg(num_message_layers=3)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    ), params)
    with torch.no_grad():
        out = port(batch.to("cpu")).numpy()
    cat = lambda key: np.concatenate([getattr(g, key) for g in graphs]).astype(np.float64)  # noqa: E731
    want = npref.ar_forward(
        jax.device_get(params)["params"], cat("h"), cat("chi"), cat("e"), cat("xi"), cat("x"),
        np.concatenate([g.extras["atom_residue_idx"] + i * num_res for i, g in enumerate(graphs)]),
        np.concatenate([g.extras["ca_x_local"] for g in graphs]).astype(np.float64),
        np.concatenate([g.senders + i * n for i, g in enumerate(graphs)]),
        np.concatenate([g.receivers + i * n for i, g in enumerate(graphs)]),
        np.repeat(np.arange(g_count), n), g_count,
        node_in_dims=(10, 2), edge_in_dims=(12, 1), node_dims=(16, 4), edge_dims=(8, 4),
        num_layers=2, num_message_layers=3, num_feedforward_layers=1, nonlinearities=("silu", "silu"),
    )
    np.testing.assert_allclose(out[: n * g_count], want, atol=ATOL)


def _rotation(seed):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32), rng.normal(scale=10.0, size=3).astype(np.float32)


def test_ar_positions_are_equivariant(ar_root):
    """Rotating and moving the atoms, their orientations, the edge vectors
    and the Ca table rotates and moves every predicted position."""
    batch = _batch(ar_root)
    q, shift = _rotation(1)
    real = np.asarray(batch.node_pad_mask)
    n_res = int(batch.extras["atom_residue_idx"][real].max()) + 1
    ca = batch.extras["ca_x"].copy()
    ca[:n_res] = ca[:n_res] @ q.T + shift
    turned = batch.replace(x=np.where(real[:, None], batch.x @ q.T + shift, 0.0).astype(np.float32),
                           chi=batch.chi @ q.T, xi=batch.xi @ q.T, extras={**batch.extras, "ca_x": ca})
    model = _port_model(seed=1)
    with torch.no_grad():
        out = model(batch.to("cpu")).numpy()
        got = model(turned.to("cpu")).numpy()
    assert np.abs(out[real] - batch.extras["ca_x"][batch.extras["atom_residue_idx"]][real]).max() > 1e-2
    np.testing.assert_allclose(got[real], out[real] @ q.T + shift, atol=2e-4)


def test_nms_positions_are_equivariant():
    """``tests/test_model_equivariance.py``'s NMS case with the port: two
    complete graphs of 5 bodies."""
    rng = np.random.default_rng(5)
    n = 5
    s, r = np.nonzero(~np.eye(n, dtype=bool))
    graphs = [
        GraphData(
            h=rng.normal(size=(n, 1)).astype(np.float32), chi=rng.normal(size=(n, 3, 3)).astype(np.float32),
            e=rng.normal(size=(n * (n - 1), 17)).astype(np.float32),
            xi=rng.normal(size=(n * (n - 1), 1, 3)).astype(np.float32), x=rng.normal(size=(n, 3)).astype(np.float32),
            senders=s.astype(np.int32), receivers=r.astype(np.int32),
            extras={"label": rng.normal(size=(n, 3)).astype(np.float32)},
        )
        for _ in range(2)
    ]
    batch = next(batches_from_dataset(graphs, Bucket(n * 2, n * (n - 1) * 2 + 1, 2)))
    model = GCPNetNMS(
        ModelCfg(h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
                 e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0),
        ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)), generator=torch.Generator().manual_seed(0),
        device="cpu",
    )
    q, shift = _rotation(2)
    turned = batch.replace(x=batch.x @ q.T + shift, chi=batch.chi @ q.T, xi=batch.xi @ q.T)
    with torch.no_grad():
        out = model(batch.to("cpu")).numpy()
        got = model(turned.to("cpu")).numpy()
    assert np.abs(out - batch.x).max() > 1e-3
    np.testing.assert_allclose(got, out @ q.T + shift, atol=2e-4)


def _small_ar_module(monkeypatch):
    """``--task ar``'s datamodule at a bucket the CPU takes in seconds (the
    JAX module's 4,096 nodes of 152 rows take minutes a step)."""
    small = dict(k_max=16, max_nodes_per_batch=700, max_residues_per_batch=80)
    monkeypatch.setitem(registry.DATAMODULES, "ARDataModule", lambda **kw: ar.ARDataModule(**{**kw, **small}))
    return small


def test_ar_entry_points(ar_root, tmp_path, monkeypatch, capsys):
    """``--task ar`` on the CPU: a 1-layer model, one epoch and the test of
    its checkpoint; then ``predict_ar`` refines the test decoys with that
    checkpoint and writes their PDBs and score rows.  Without ``--device
    cpu`` and without a card both raise."""
    small = _small_ar_module(monkeypatch)
    ckpt = tmp_path / "ckpt"
    cli.main(["--task", "ar", "--device", "cpu", "--data-dir", ar_root, "--num-encoder-layers", "1",
              "--max-epochs", "1", "--min-epochs", "0", "--checkpoint-dir", str(ckpt)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines[0]["epoch"] == 0 and np.isfinite(lines[0]["val/RMSE"])
    assert set(lines[-1]) == {"test/loss", "test/RMSE", "step"}
    out_dir = tmp_path / "refined"
    predict_ar.main([
        "--input-dir", os.path.join(ar_root, "AF2_model"), "--true-dir", os.path.join(ar_root, "true_model"),
        "--output-dir", str(out_dir), "--checkpoint-dir", str(ckpt), "--num-encoder-layers", "1", "--device", "cpu",
        "--k-max", str(small["k_max"]), "--max-nodes-per-batch", "700", "--max-residues-per-batch", "80",
    ])
    decoys = sorted(f for f in os.listdir(os.path.join(ar_root, "AF2_model")) if f.endswith(".pdb"))
    with open(out_dir / "scores.csv") as f:
        rows = list(csv.DictReader(f))
    assert [row["decoy"] for row in rows] == decoys
    assert all(os.path.exists(row["refined_pdb"]) and 0.0 < float(row["TM-score"]) <= 1.0 for row in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--task", "ar", "--data-dir", ar_root])
        with pytest.raises(RuntimeError, match="CUDA"):
            predict_ar.main(["--input-dir", os.path.join(ar_root, "AF2_model"), "--output-dir", str(out_dir),
                             "--checkpoint-dir", str(ckpt)])
