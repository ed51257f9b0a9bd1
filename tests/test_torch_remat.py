"""Per-layer rematerialization (``remat``) in the port, on the CPU.

- The small LBA model with ``remat`` ``True`` and ``"dots"`` against
  ``False``, dropout active (rate 0.1, one seeded generator): the loss, every
  parameter's gradient and the generator's state after the step equal, fp32
  atol 1e-6 (the recompute applies the forward's dropout masks: the
  tape of ``nn.primitives``).
- The same in a bf16 step (``train.step.loss_and_grads``: the model runs
  under ``torch.func.functional_call`` on bf16 copies of its weights, which
  the recompute must use again).
- Each remat'd layer runs twice a step (the forward and the recompute) and
  once under ``torch.no_grad``; ``"dots"`` recomputes no matrix product in
  the backward (its saved outputs) where ``True`` recomputes them all.
- ``tests/test_models.py``'s JAX case (``test_lba_model_remat_matches_plain``:
  ``GCPNetLBA`` with ``remat`` ``True`` and ``"dots"``): the port with
  the flax weights against ``jax.value_and_grad`` of the JAX model with
  the same ``remat``, fp32 atol 1e-4 (deterministic: the two packages'
  dropout masks come from different generators; with dropout each package
  is held to its own step without remat).
- ``remat`` on every task model that has the JAX field (CPD declares it
  and reads it not), and an unknown policy raises.
"""

import inspect

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import LBA_BUCKET, LBA_MESSAGE_LAYERS, LBA_MODEL, lba_graphs, load_jax_params, np_, port_batch, \
    to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.batching import Bucket as JBucket
from gcpnet_tpu.data.batching import collate_shards as jcollate_shards
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
from gcpnet_tpu.models.lba import graph_regression_loss as j_graph_regression_loss
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.models import MODEL_REGISTRY
from gcpnet_torch.models.common import DOT_OPS, check_remat
from gcpnet_torch.models.lba import GCPNetLBA, graph_regression_loss
from gcpnet_torch.train.optim import build_optimizer
from gcpnet_torch.train.state import TrainState
from gcpnet_torch.train.step import loss_and_grads
from gcpnet_torch.weights import from_jax_params

MODES = [True, "dots"]


def _model(remat, dropout=0.1):
    return GCPNetLBA(
        ModelCfg(**{**LBA_MODEL, "dropout": dropout}), ModuleCfg(),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=LBA_MESSAGE_LAYERS)), remat=remat,
        generator=torch.Generator().manual_seed(0), device="cpu",
    )


def _step(model, batch, deterministic=False):
    """Loss, gradients and the generator's state after one backward."""
    gen = torch.Generator().manual_seed(11)
    loss, _ = graph_regression_loss(model(batch, deterministic=deterministic, generator=gen), batch)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}, gen.get_state()


@pytest.mark.parametrize("remat", MODES)
def test_remat_equals_plain_with_dropout(remat):
    batch = port_batch(lba_graphs(), sort_tile=1).to(torch.device("cpu"))
    loss0, grads0, gen0 = _step(_model(False), batch)
    loss1, grads1, gen1 = _step(_model(remat), batch)
    assert loss1 == pytest.approx(loss0, abs=1e-6)
    for name, g in grads0.items():
        np.testing.assert_allclose(grads1[name].numpy(), g.numpy(), atol=1e-6, err_msg=name)
    assert torch.equal(gen0, gen1)  # the recompute drew nothing


@pytest.mark.parametrize("remat", MODES)
def test_remat_equals_plain_in_a_bf16_step(remat):
    batch = port_batch(lba_graphs(), sort_tile=1).to(torch.device("cpu"))
    out = {}
    for mode in (False, remat):
        model = _model(mode)
        state = TrainState(build_optimizer(model.parameters(), {"_target_": "Adam", "lr": 1e-4}),
                           compute_dtype=torch.bfloat16)
        out[mode] = loss_and_grads(model, state, batch, graph_regression_loss, torch.Generator().manual_seed(3))
    assert out[remat][0].item() == pytest.approx(out[False][0].item(), abs=1e-6)
    for got, want in zip(out[remat][1], out[False][1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in DOT_OPS
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_each_layer_and_dots_keeps_the_products():
    batch = port_batch(lba_graphs(), sort_tile=1).to(torch.device("cpu"))
    matmuls = {}
    for remat in (False, True, "dots"):
        model = _model(remat)
        calls = []
        model.encoder.interaction_0.register_forward_pre_hook(lambda *a: calls.append(1))
        gen = torch.Generator().manual_seed(11)
        loss, _ = graph_regression_loss(model(batch, deterministic=False, generator=gen), batch)
        with _CountMatmuls() as counter:
            loss.backward()
        matmuls[remat] = counter.count
        assert len(calls) == (2 if remat else 1), remat
        with torch.no_grad():
            model(batch)
        assert len(calls) == (3 if remat else 2), remat
    assert matmuls[True] > matmuls[False] == matmuls["dots"]


@pytest.fixture(scope="module")
def jax_lba():
    """The JAX LBA of the small parity configuration on the same graphs,
    its weights from key 0 (the batch edge-list, as in test_models.py)."""
    batch = to_jax(jcollate_shards([[JGraphData(**g) for g in lba_graphs()]], JBucket(*LBA_BUCKET),
                                   extra_graph_keys=("label",)))

    def build(remat):
        return JGCPNetLBA(model_cfg=JModelCfg(**{**LBA_MODEL, "dropout": 0.1}), module_cfg=JModuleCfg(),
                          layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=LBA_MESSAGE_LAYERS)),
                          num_atom_types=9, remat=remat)

    params = build(False).init(jax.random.key(0), batch, True)
    return build, batch, params


@pytest.mark.parametrize("remat", MODES)
def test_remat_matches_the_jax_remat_case(jax_lba, remat):
    build, jbatch, params = jax_lba
    jmodel = build(remat)

    def loss_fn(p):
        return j_graph_regression_loss(jmodel.apply(p, jbatch, True), jbatch)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = load_jax_params(_model(remat), params)
    batch = port_batch(lba_graphs(), sort_tile=1).to(torch.device("cpu"))
    loss, grads, _ = _step(port, batch, deterministic=True)
    np.testing.assert_allclose(loss, float(want_loss), atol=1e-4)
    want = from_jax_params(want_grads)
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(np_(g), np_(want[name]), atol=1e-4, err_msg=name)


def test_every_task_model_takes_remat():
    for name, cls in MODEL_REGISTRY.items():
        assert "remat" in inspect.signature(cls).parameters, name
    assert check_remat(True) is True and check_remat(0) is False and check_remat("dots") == "dots"
    with pytest.raises(ValueError, match="unknown remat policy 'everything'"):
        _model("everything")
