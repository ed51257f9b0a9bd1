"""One dispatch per step, on the CPU: what the CUDA graphs of
``gcpnet_torch.train.graphs`` need from the step, and ``scan_chunk_size``
against the JAX ``Trainer``.

- The train step (fp32, bf16, and under gradient accumulation, with the
  adaptive clip, a StepLR schedule, an ``lr_scale`` and dropout), a NaN
  step, the eval step and the serving forward read nothing back to the
  host: they run with ``Tensor.item``, ``__bool__``, ``tolist``, ``cpu``,
  ``numpy``, ``__float__`` and ``__int__`` made to raise.
- The device-side select: three finite steps (Adam, the adaptive clip,
  StepLR, ``lr_scale`` 0.5) against the JAX ``Trainer``'s own step, losses,
  norms, clip thresholds and parameters at fp32 atol 1e-4; then a NaN step
  leaves the parameters, the moments and count, the schedule's count and
  rate and the ring as they were.
- ``scan_chunk_size`` k = 1, 2, 3 over 5 training and 3 validation batches
  (so k = 2 and 3 leave a tail): the port's ``Trainer`` gives the weights of
  k = 1 (on the CPU a chunk is its steps run eagerly, in the same order:
  exactly), and ``train/loss`` and ``val/loss`` equal the JAX ``Trainer``'s
  with the same k at fp32 atol 1e-4.
- The captured step and eval step refuse a model on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import gcpnet_tpu.nn.gcp as jgcp
import gcpnet_tpu.nn.message_passing as jmp
import gcpnet_tpu.ops.pallas_fused as jpallas_fused
from _torch_parity import LBA_BUCKET, LBA_MESSAGE_LAYERS, LBA_MODEL, load_jax_params, np_, random_graphs
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.batching import Bucket as JBucket
from gcpnet_tpu.data.batching import collate_shards as jcollate_shards
from gcpnet_tpu.data.nms import NMSDataModule as JNMSDataModule
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
from gcpnet_tpu.models import GCPNetNMS as JGCPNetNMS
from gcpnet_tpu.models import nms_loss as jnms_loss
from gcpnet_tpu.models.lba import graph_regression_loss as jgraph_regression_loss
from gcpnet_tpu.parallel import make_mesh
from gcpnet_tpu.train import Trainer as JTrainer
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.batching import Bucket, collate_shards
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.predict import Predictor
from gcpnet_torch.train.graphs import CapturedCall, EvalSteps, TrainSteps
from gcpnet_torch.train.optim import build_optimizer, build_schedule
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import eval_step, train_step
from gcpnet_torch.train.trainer import Trainer
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4
HOST_READS = ("item", "__bool__", "tolist", "cpu", "numpy", "__float__", "__int__")
# the ops behind a device value read on the host: a tensor turned into a
# Python scalar (also where an op takes a Scalar and is handed a tensor),
# and the sizes of data-dependent results
HOST_READ_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.is_nonzero")
SCHEDULE = {"_target_": "StepLR", "step_size": 2, "gamma": 0.5}


def _graphs(seed: int, label_scale: float = 1.0):
    graphs = random_graphs(np.random.default_rng(seed), num_graphs=2, nodes=20, edges=70)
    for g in graphs:
        g["extras"]["label"] = np.float32(g["extras"]["label"] * label_scale)
    return graphs


def _port_batch(graphs):
    return collate_shards(
        [[GraphData(**g) for g in graphs]], Bucket(*LBA_BUCKET), extra_graph_keys=("label",), sort_edges=True,
    )


def _port_lba(params=None, **model_kw) -> GCPNetLBA:
    model = GCPNetLBA(
        ModelCfg(**{**LBA_MODEL, **model_kw}), ModuleCfg(),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=LBA_MESSAGE_LAYERS)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return model if params is None else load_jax_params(model, params)


def _port_state(model, lr: float, accumulate: int = 1, compute_dtype=torch.float32) -> TrainState:
    optimizer = build_optimizer(
        model.parameters(), {"_target_": "Adam", "lr": lr, "accumulate_grad_batches": accumulate}
    )
    return TrainState(
        optimizer, ring=GradNormRing(), compute_dtype=compute_dtype,
        scheduler=build_schedule(optimizer, SCHEDULE), lr_scale=torch.tensor(0.5, dtype=torch.float64),
    )


def _snapshot(model, state: TrainState) -> dict:
    """Every tensor of the parameters and the train state, cloned."""
    out = {f"param.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for i, s in enumerate(state.optimizer.state.values()):
        out.update({f"opt.{i}.{k}": v.clone() for k, v in s.items()})
    out["schedule.count"] = state.scheduler.count.clone()
    out["lr"] = state.optimizer.param_groups[0]["lr"].clone()
    ring = state.ring
    out.update({"ring.buffer": ring.buffer.clone(), "ring.count": ring.count.clone(), "ring.head": ring.head.clone()})
    return out


class _RefuseHostReadOps(TorchDispatchMode):
    """Raises on any op of HOST_READ_OPS."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(str(func).startswith(name + ".") for name in HOST_READ_OPS):
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config", ["fp32", "bf16", "accumulate"])
def test_step_reads_nothing_back_to_the_host(monkeypatch, config):
    """Two training steps with dropout, a NaN step, an eval step and the
    serving forward, with every host read of a tensor made to raise."""
    model = _port_lba()
    state = _port_state(
        model, 1e-3, accumulate=2 if config == "accumulate" else 1,
        compute_dtype=torch.bfloat16 if config == "bf16" else torch.float32,
    )
    host = _port_batch(_graphs(3))
    batch = host.to("cpu")
    nan_graphs = _graphs(3)
    for g in nan_graphs:
        g["extras"]["label"] = np.float32("nan")
    nan_batch = _port_batch(nan_graphs).to("cpu")
    generator = torch.Generator().manual_seed(1)

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")

        return read

    with monkeypatch.context() as m, _RefuseHostReadOps():
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse(name))
        results = [train_step(model, state, b, graph_regression_loss, generator) for b in (batch, batch, nan_batch)]
        loss, preds = eval_step(model, batch, graph_regression_loss)
        served = Predictor(model)(host)
    assert [bool(r.ok) for r in results] == [True, True, False] and state.step == 3
    assert torch.isfinite(loss) and preds.shape == served.shape == (3,)
    np.testing.assert_allclose(np_(served), np_(preds), atol=1e-6)


def _jax_lba():
    return JGCPNetLBA(
        model_cfg=JModelCfg(**LBA_MODEL, dropout=0.0, dense_dropout=0.0), module_cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=LBA_MESSAGE_LAYERS)), num_atom_types=9,
    )


def test_device_side_select_matches_jax_step_and_keeps_state_on_nan(monkeypatch):
    """Three finite steps against the JAX Trainer's step (which selects
    with ``jnp.where(ok, ...)``), then a NaN step that changes nothing."""
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", False)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)
    lr = 1e-3
    steps = [_graphs(11), _graphs(12, label_scale=10.0), _graphs(13)]
    trainer = JTrainer(
        _jax_lba(), jgraph_regression_loss, optimizer_cfg={"_target_": "Adam", "lr": lr},
        scheduler_cfg=SCHEDULE, mesh=make_mesh(jax.devices()[:1]), adaptive_clip=True, precision=32,
        early_stopping_patience=None,
    )
    jbatches = [
        trainer._put(jcollate_shards(
            [[JGraphData(**g) for g in gs]], JBucket(*LBA_BUCKET), extra_graph_keys=("label",), sort_edges=True,
        ))
        for gs in steps
    ]
    jstate = trainer.init_state(jbatches[0])
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = trainer._build_train_step()
    want = []
    for b in jbatches:
        jstate, loss, gnorm = jstep(jstate, b, jax.random.key(0), jnp.float32(0.5))
        want.append((float(loss), float(gnorm), float(jstate.grad_norms.clip_threshold())))

    model = _port_lba(params0, dropout=0.0, dense_dropout=0.0)
    state = _port_state(model, lr)
    got = []
    for gs in steps:
        res = train_step(model, state, _port_batch(gs).to("cpu"), graph_regression_loss, deterministic=True)
        assert bool(res.ok)
        got.append((res.loss.item(), res.grad_norm.item(), state.ring.clip_threshold().item()))
    assert got[1][1] > 1.5 * got[0][1]  # the second step is clipped
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    want_params = from_jax_params(jstate.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(np_(p), want_params[name].numpy(), atol=ATOL, err_msg=name)
    assert int(state.scheduler.count) == 3 and float(state.optimizer.param_groups[0]["lr"]) == lr / 2

    before = _snapshot(model, state)
    nan_graphs = _graphs(14)
    nan_graphs[0]["extras"]["label"] = np.float32("nan")
    res = train_step(model, state, _port_batch(nan_graphs).to("cpu"), graph_regression_loss, deterministic=True)
    assert not bool(res.ok) and not np.isfinite(res.loss.item()) and state.step == 4
    after = _snapshot(model, state)
    assert after.keys() == before.keys()
    for key, value in before.items():
        assert torch.equal(after[key], value), key


NMS_SPLITS = dict(data_mode="small", batch_size=16, num_train=80, num_valid=48, num_test=16)
NMS_MODEL = dict(
    h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1, h_hidden_dim=16,
    chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=1, dropout=0.0,
)
OPTIMIZER = {"_target_": "Adam", "lr": 1e-3}


@pytest.fixture(scope="module")
def nms_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nms"))
    JNMSDataModule(data_root=root, **NMS_SPLITS).prepare_data()
    return root


def _datamodule(root, cls=NMSDataModule):
    dm = cls(data_root=root, **NMS_SPLITS)
    dm.setup()
    return dm


def _jax_nms_trainer(chunk: int) -> JTrainer:
    return JTrainer(
        JGCPNetNMS(
            model_cfg=JModelCfg(**NMS_MODEL), module_cfg=JModuleCfg(),
            layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=2)),
        ),
        jnms_loss, optimizer_cfg=OPTIMIZER, max_epochs=1, mesh=make_mesh(jax.devices()[:1]),
        early_stopping_patience=None, seed=3, scan_chunk_size=chunk,
    )


def _port_fit(nms_root, params, chunk: int) -> Trainer:
    model = GCPNetNMS(
        ModelCfg(**NMS_MODEL), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    model.load_state_dict(from_jax_params(params))
    trainer = Trainer(
        model, nms_loss, optimizer_cfg=OPTIMIZER, max_epochs=1, early_stopping_patience=None, seed=3,
        scan_chunk_size=chunk,
    )
    trainer.fit(_datamodule(nms_root))
    return trainer


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_scan_chunk_size_matches_jax_trainer(nms_root, chunk):
    """One epoch of 5 training and 3 validation batches in chunks of
    ``chunk``: the weights of chunk 1, and the JAX Trainer's losses."""
    jtrainer = _jax_nms_trainer(chunk)
    jdm = _datamodule(nms_root, JNMSDataModule)
    params = jtrainer.init_state(jtrainer._put(next(iter(jdm.train_batches(seed=0))))).params
    jtrainer.fit(jdm)
    port = _port_fit(nms_root, params, chunk)
    assert port.state.step == int(jtrainer.state.step) == 5
    for name in ("train/loss", "val/loss"):
        np.testing.assert_allclose(port.history[name], jtrainer.history[name], atol=ATOL, err_msg=name)
    if chunk > 1:
        single = _port_fit(nms_root, params, 1)
        assert port.history["train/loss"] == pytest.approx(single.history["train/loss"], rel=1e-6)
        for (name, p), q in zip(port.model.named_parameters(), single.model.parameters()):
            assert torch.equal(p, q), name


def test_captured_steps_refuse_the_cpu():
    """CUDA graphs run on the card: the captured step and eval step refuse
    a model on the CPU instead of running eagerly."""
    model = _port_lba()
    state = _port_state(model, 1e-3)
    for build in (
        lambda: TrainSteps(model, state, graph_regression_loss),
        lambda: EvalSteps(model, graph_regression_loss),
        lambda: CapturedCall(lambda batches: (), "cpu"),
    ):
        with pytest.raises(ValueError, match="card"):
            build()
