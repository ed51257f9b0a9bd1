"""Data parallelism in the port against the JAX package's ``dp`` mesh, on
the CPU: one gloo process a shard, started by the port's own launcher
(``gcpnet_torch.parallel.launch``, a ``file://`` rendezvous in a temporary
directory, so that concurrent test workers share no TCP port), against the
JAX trainer over the conftest's virtual CPU devices.

- ``collate_shards``/``batches_from_dataset`` over N shards: rank r's
  batch is shard r of the JAX concatenated batch (N 2 and 4, and the
  ``drop_last=False`` tail padded with empty shards); EQ's and AR's
  per-shard residue tables are the JAX shard slices;
- NMS (``tests/test_parallel.py``'s small config): port world 2 and 4
  against the JAX 2- and 4-device mesh, two steps' losses at rtol 2e-5 and
  the validation after them at the fit tests' 1e-4;
- the EQ trunk of ``tests/test_parallel_eq_ar.py``: world 1 and 4 against
  the JAX mesh and each other at rtol 2e-5; AR's dp loss is the mean of
  the per-shard losses (not the global batch's), as in the JAX package;
- evaluation on 2 ranks gives the metrics of one rank over the same
  global batches; ``python -m gcpnet_torch.eval trainer.devices=2`` gives
  the JAX trainer's test metrics on a 2-device mesh with the same weights;
  a captured step on a gloo group raises; the config
  entry point with ``trainer.devices=2`` trains two processes to the
  one-process result, and devices beyond the machine's raise; a rank
  that raises ends the launch with its traceback.
"""

import dataclasses
import os
import signal
import time

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import _torch_dp as dp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_parallel_eq_ar as jtrunk
import torch

from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.batching import Bucket as JBucket
from gcpnet_tpu.data.batching import batches_from_dataset as jbatches_from_dataset
from gcpnet_tpu.data.nms import NMSDataModule as JNMSDataModule
from gcpnet_tpu.data.registry import build_datamodule as jbuild_datamodule
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models import GCPNetNMS as JGCPNetNMS
from gcpnet_tpu.models import ar_loss as jar_loss
from gcpnet_tpu.models import eq_loss as jeq_loss
from gcpnet_tpu.models import nms_loss as jnms_loss
from gcpnet_tpu.parallel import make_mesh
from gcpnet_tpu.train import Trainer as JTrainer
from gcpnet_torch import eval as eval_entry
from gcpnet_torch import parallel, tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.data.batching import Bucket, Shards, batches_from_dataset, collate_shards, sort_edges_by_receiver
from gcpnet_torch.graph import GraphBatch, GraphData
from gcpnet_torch.models.ar import ar_loss
from gcpnet_torch.train import entry
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.weights import from_jax_params

RTOL = 2e-5
FIT_ATOL = 1e-4  # tests/test_torch_trainer.py's port-vs-JAX bound on a fit's metrics
TIMEOUT = 600
NMS_METRICS = ("val/loss", "val/RMSE", "val/CosineSimilarity")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual JAX devices")


def _as_dict(g: JGraphData) -> dict:
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def _port_slice(jbatch, shard: int, count: int) -> GraphBatch:
    """Shard ``shard`` of a JAX concatenated batch as a port batch, its
    edges sorted by receiver as the port's batches are (``tile=1``)."""
    def cut(a):
        a = np.asarray(a)
        per = a.shape[0] // count
        return a[shard * per : (shard + 1) * per]

    fields = {f.name: getattr(jbatch, f.name) for f in dataclasses.fields(GraphBatch)
              if hasattr(jbatch, f.name) and f.name != "extras"}
    fields = {k: None if v is None or np.ndim(v) == 0 else cut(v) for k, v in fields.items()}
    return sort_edges_by_receiver(GraphBatch(**fields, extras={k: cut(v) for k, v in jbatch.extras.items()}), tile=1)


def _assert_batches_equal(got: GraphBatch, want: GraphBatch):
    for (name, a), b in zip(got.tensors().items(), want.tensors().values()):
        if a is None or b is None:
            assert a is None and b is None, name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def _random_graphs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        nodes = int(rng.integers(6, 20))
        edges = int(rng.integers(nodes, 4 * nodes))
        graphs.append(dict(
            h=rng.normal(size=(nodes, 3)).astype(np.float32), chi=rng.normal(size=(nodes, 2, 3)).astype(np.float32),
            e=rng.normal(size=(edges, 4)).astype(np.float32), xi=rng.normal(size=(edges, 1, 3)).astype(np.float32),
            x=rng.normal(size=(nodes, 3)).astype(np.float32),
            senders=rng.integers(0, nodes, size=edges).astype(np.int32),
            receivers=rng.integers(0, nodes, size=edges).astype(np.int32),
            extras={"label": np.float32(rng.normal())},
        ))
    return graphs


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_sharded_batches_match_jax(count, drop_last):
    graphs = _random_graphs(count, 58)  # 17 and 15 shards: an incomplete last group for both counts
    bucket = (64, 160, 4)
    want = list(jbatches_from_dataset([JGraphData(**g) for g in graphs], JBucket(*bucket), num_shards=count,
                                      drop_last=drop_last, extra_graph_keys=("label",)))
    shards = len(list(batches_from_dataset([GraphData(**g) for g in graphs], Bucket(*bucket), ("label",))))
    assert shards % count and len(want) == (shards // count if drop_last else -(-shards // count))
    for rank in range(count):
        got = list(batches_from_dataset([GraphData(**g) for g in graphs], Bucket(*bucket), ("label",),
                                        Shards(count, rank), drop_last=drop_last))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_batches_equal(g, _port_slice(w, rank, count))
    # the tail: padded with empty shards without drop_last, else dropped
    assert drop_last == _port_slice(want[-1], count - 1, count).node_pad_mask.any()


def test_collate_shards_takes_its_shard():
    graphs = [GraphData(**g) for g in _random_graphs(5, 5)]
    shards = [graphs[:2], graphs[2:3], [], graphs[3:]]
    for index, shard in enumerate(shards):
        got = collate_shards(shards, Bucket(64, 160, 4), ("label",), index=index)
        assert int(got.node_pad_mask.sum()) == sum(g.num_nodes for g in shard)
        assert got.h.shape == (64, 3)  # an empty shard takes its shapes from the others


@pytest.mark.parametrize("task", ["eq", "ar"])
def test_residue_tables_are_the_jax_shard_slices(task):
    rng = np.random.default_rng(3)
    graphs = [jtrunk._synthetic_graph(rng, task) for _ in range(8)]
    count = 4
    jbatch = jtrunk._collate(graphs, count, task)
    keys = ("atom_residue_idx", "label", "res_mask") if task == "eq" else ("atom_residue_idx", "ca_x", "label")
    for rank in range(count):
        got = dp.trunk_batch(task, [_as_dict(g) for g in graphs], Shards(count, rank))
        for key in keys:
            want = np.asarray(jbatch.extras[key])
            per = want.shape[0] // count
            np.testing.assert_array_equal(got.extras[key], want[rank * per : (rank + 1) * per], err_msg=key)


# --- NMS: port world 2 and 4 against the JAX mesh ------------------------------


@pytest.fixture(scope="module")
def nms_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nms"))
    JNMSDataModule(data_root=root, batch_size=16, **dp.NMS_SPLITS).prepare_data()
    return root


def _jax_nms(root, count):
    """The JAX trainer on a ``count``-device mesh: its initial weights, two
    training steps' losses and the validation after them."""
    dm = JNMSDataModule(data_root=root, batch_size=16, num_shards=count, **dp.NMS_SPLITS)
    dm.setup()
    tr = JTrainer(
        JGCPNetNMS(model_cfg=JModelCfg(**dp.NMS_MODEL), module_cfg=JModuleCfg(),
                   layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2))),
        jnms_loss, optimizer_cfg=dp.OPTIMIZER, mesh=make_mesh(jax.devices()[:count]), early_stopping_patience=None,
        seed=3, collect_fn=jtasks.build_collect("GCPNetNMS"), metric_fns=jtasks.build_metric_fns("GCPNetNMS"),
    )
    batches = list(dm.train_batches(seed=0))
    tr.init_state(tr._put(batches[0]))
    params = jax.device_get(tr.state.params)
    step, losses = tr._build_train_step(), []
    for b in batches:
        tr.state, loss, _ = step(tr.state, tr._put(b), jax.random.key(0), jnp.float32(1.0))
        losses.append(float(loss))
    return params, losses, tr.eval_epoch(dm.val_batches())


@pytest.fixture(scope="module", params=[2, 4])
def nms_runs(request, nms_root):
    count = request.param
    params, losses, val = _jax_nms(nms_root, count)
    port = parallel.launch(dp.nms_worker, count, nms_root, params, 16, timeout=TIMEOUT)
    return count, params, {"losses": losses, "val_after": val}, port


def test_nms_dp_matches_jax_mesh(nms_runs):
    count, _, want, got = nms_runs
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    for name in NMS_METRICS:
        np.testing.assert_allclose(got["val_after"][name], want["val_after"][name], atol=FIT_ATOL, err_msg=name)


def test_eval_on_two_ranks_equals_one_rank(nms_runs, nms_root):
    """Each 16-graph global batch of 2 ranks is two 8-graph batches of one
    rank: every process's metrics are those over all of them."""
    count, params, _, got = nms_runs
    dm = dp.NMSDataModule(data_root=nms_root, batch_size=16 // count, **dp.NMS_SPLITS)
    dm.setup()
    want = dp.nms_trainer(dp.nms_model(params)).eval_epoch(dm.val_batches())
    assert set(got["val_before"]) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got["val_before"][name], value, rtol=1e-6, err_msg=name)


def test_eval_entry_point_on_two_ranks_matches_jax_mesh(nms_root, tmp_path):
    """``gcpnet_torch.eval`` with ``trainer.devices=2``: two gloo processes,
    each testing its shard of every global batch of a checkpoint, report
    the JAX trainer's test metrics on a 2-device mesh with the same weights
    (the fit tests' bound), and one process's over the whole batches."""
    overrides = [
        "experiment=gcpnet_nms_small", "trainer.accelerator=cpu", f"datamodule.data_dir={nms_root}",
        "datamodule.num_train=32", "datamodule.num_valid=16", "datamodule.num_test=16", "datamodule.batch_size=16",
        "model.model_cfg.h_hidden_dim=16", "model.model_cfg.chi_hidden_dim=4", "model.model_cfg.e_hidden_dim=8",
        "model.model_cfg.num_encoder_layers=1", "model.layer_cfg.mp_cfg.num_message_layers=2",
        "extras.print_config=false", f"paths.output_dir={tmp_path}",
    ]
    cfg = compose(CONFIG_DIR, "eval.yaml", overrides)
    jmodel, jname = jtasks.build_model(cfg["model"])
    jdm = jbuild_datamodule(cfg["datamodule"], num_shards=2)
    jdm.setup()
    jtr = JTrainer(jmodel, jtasks.build_loss(jname), optimizer_cfg=dp.OPTIMIZER, mesh=make_mesh(jax.devices()[:2]),
                   early_stopping_patience=None, seed=3, collect_fn=jtasks.build_collect(jname),
                   metric_fns=jtasks.build_metric_fns(jname))
    jtr.init_state(jtr._put(next(iter(jdm.val_batches()))))
    want = jtr.test(jdm)
    # the JAX weights as a checkpoint of the port's
    model, name = tasks.build_model(cfg["model"], device="cpu")
    model.load_state_dict(from_jax_params(jax.device_get(jtr.state.params)))
    state = entry.build_trainer(cfg, model, tasks.build_loss(name), name, checkpoints=False).checkpoint_state()
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(0, state, {"val/loss": 1.0})
    two = eval_entry.main(overrides + ["trainer.devices=2", f"ckpt_path={ckpt}"])
    one = eval_entry.main(overrides + [f"ckpt_path={ckpt}"])
    assert set(two) == set(want) == set(one) and "test/RMSE" in two
    for key, value in want.items():
        np.testing.assert_allclose(two[key], value, atol=FIT_ATOL, err_msg=key)
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, err_msg=key)


def test_captured_step_on_gloo_raises(nms_runs):
    assert "gloo" in nms_runs[3]["capture"] and "NCCL" in nms_runs[3]["capture"]


# --- the EQ and AR trunk --------------------------------------------------------


@pytest.fixture(scope="module")
def trunk_runs():
    out = {}
    for task, loss_fn in (("eq", jeq_loss), ("ar", jar_loss)):
        rng = np.random.default_rng(3)  # the graphs of the JAX test's _two_step_losses
        graphs = [jtrunk._synthetic_graph(rng, task) for _ in range(8)]
        j1, params, _ = jtrunk._two_step_losses(task, loss_fn, 1)
        j4, _, _ = jtrunk._two_step_losses(task, loss_fn, 4)
        out[task] = dict(params=params, graphs=[_as_dict(g) for g in graphs], jax={1: j1, 4: j4})
    runs = [(task, out[task]["params"], out[task]["graphs"]) for task in ("eq", "ar")]
    for task, losses in zip(("eq", "ar"), parallel.launch(dp.trunk_worker, 4, runs, timeout=TIMEOUT)):
        out[task]["port"] = {4: losses, 1: dp.trunk_steps(task, out[task]["params"], out[task]["graphs"])}
    return out


def test_eq_trunk_dp_matches_jax_and_one_device(trunk_runs):
    eq = trunk_runs["eq"]
    for count in (1, 4):
        np.testing.assert_allclose(eq["port"][count], eq["jax"][count], rtol=RTOL, err_msg=f"{count} shards")
    np.testing.assert_allclose(eq["port"][4], eq["port"][1], rtol=RTOL)


def test_ar_dp_loss_is_the_mean_of_shard_losses(trunk_runs):
    ar = trunk_runs["ar"]
    model = dp.trunk_model("ar", ar["params"]).eval()
    per_shard = []
    for rank in range(4):
        batch = dp.trunk_batch("ar", ar["graphs"], Shards(4, rank)).to("cpu")
        with torch.no_grad():
            per_shard.append(float(ar_loss(model(batch, deterministic=True), batch)[0]))
    np.testing.assert_allclose(ar["port"][4][0], np.mean(per_shard), rtol=RTOL)
    np.testing.assert_allclose(ar["port"][4], ar["jax"][4], rtol=RTOL)
    assert abs(ar["port"][1][0] - ar["port"][4][0]) > 1e-4 * ar["port"][1][0]  # not the global loss


# --- the entry point -----------------------------------------------------------


def _nms_overrides(tmp_path, devices: int):
    return [
        "experiment=gcpnet_nms_small", "trainer.accelerator=cpu", f"trainer.devices={devices}",
        "datamodule.num_train=32", "datamodule.num_valid=16", "datamodule.num_test=16", "datamodule.batch_size=16",
        f"datamodule.data_dir={tmp_path}/data", "model.model_cfg.num_encoder_layers=1", "trainer.max_epochs=1",
        "trainer.min_epochs=0", f"paths.output_dir={tmp_path}/run{devices}", "extras.print_config=false",
    ]


def test_entry_point_trains_on_two_processes(tmp_path):
    """``trainer.devices=2`` starts two processes, which fit the same model
    as one process does (NMS graphs are all one size, so the mean of the
    shards' losses is the global batch's), and rank 0 alone writes the
    checkpoints."""
    two = entry.main(_nms_overrides(tmp_path, 2))
    one = entry.main(_nms_overrides(tmp_path, 1))
    assert np.isfinite(two["test/loss"])
    np.testing.assert_allclose(two["test/loss"], one["test/loss"], rtol=2e-4)
    assert (tmp_path / "run2" / "checkpoints" / "last.pt").exists()


def test_a_failing_rank_ends_the_launch():
    """Rank 1 raises while rank 0 waits for it in a barrier: the launch
    stops both and raises rank 1's traceback, without waiting out its
    timeout."""
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        parallel.launch(dp.failing_worker, 2, timeout=TIMEOUT)


def test_launch_ends_when_its_processes_are_reaped_elsewhere():
    """Another part of the program reaps the launched processes (here a
    SIGCHLD handler, so waitpid reports their ends to it and not to
    multiprocessing, whose ``is_alive`` then stays true): the launch still
    sees each end through its sentinel and returns rank 0's result, where
    waiting on ``is_alive`` would wait out its timeout."""
    def reap(signum, frame):
        while True:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return

    old = signal.signal(signal.SIGCHLD, reap)
    try:
        t0 = time.monotonic()
        assert parallel.launch(dp.rank_worker, 2, timeout=TIMEOUT) == 0
        assert time.monotonic() - t0 < TIMEOUT / 2
    finally:
        signal.signal(signal.SIGCHLD, old)


def test_too_many_devices_raise():
    with pytest.raises(ValueError, match="trainer.devices=4096"):
        entry.world_of({"accelerator": "cpu", "devices": 4096})
    assert entry.world_of({"accelerator": "cpu", "devices": "auto"}) == (1, 1)
