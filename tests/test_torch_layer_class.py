"""``model.layer_class`` overrides, and the new datamodule settings through
the config-driven entry points, on the CPU.

- Every task model on the interaction layer its experiment does not name
  (LBA, PSR, NMS, RS and CPD on ``GCPInteractions2``, EQ and AR on
  ``GCPInteractions``), composed from ``configs/`` at 2 layers and narrow
  widths: output, loss and every parameter's gradient against the JAX
  ``tasks.build_model`` of the same config with the same weights, fp32
  atol 1e-4 (CPD's encoder is ``GCPInteractions`` whatever the override
  says, in both packages).
- ``python -m gcpnet_torch.train`` then ``gcpnet_torch.eval`` on the CPU
  with the settings that raised before: LBA on ``GCPInteractions2`` under
  an edge budget, CPD under a node budget, EQ's CA-only graphs on
  ``GCPInteractions``; eval reproduces the run's test/loss bit for bit.
"""

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest

import test_torch_build_model as tbm
from _torch_parity import np_
from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.config.loader import compose as jcompose
from gcpnet_torch import eval as eval_entry
from gcpnet_torch import tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.data.registry import build_datamodule
from gcpnet_torch.train import entry
from gcpnet_torch.weights import from_jax_params, to_jax_params

ATOL = 1e-4
OTHER = {"lba": "GCPInteractions2", "psr": "GCPInteractions2", "nms": "GCPInteractions2", "rs": "GCPInteractions2",
         "cpd": "GCPInteractions2", "eq": "GCPInteractions", "ar": "GCPInteractions"}
EXPERIMENTS = {"lba": "gcpnet_lba", "psr": "gcpnet_psr", "nms": "gcpnet_nms_small_20body", "rs": "gcpnet_rs",
               "cpd": "gcpnet_cpd", "eq": "gcpnet_eq", "ar": "gcpnet_ar"}


scipy_radius_graph = tbm.scipy_radius_graph


@pytest.mark.parametrize("task", sorted(OTHER))
def test_other_layer_class_matches_jax(tmp_path, scipy_radius_graph, task):
    overrides = [f"experiment={EXPERIMENTS[task]}", *tbm.SMALL, *tbm._data(task, str(tmp_path)),
                 "trainer.accelerator=cpu", f"model.layer_class._target_=gcpnet_tpu.nn.{OTHER[task]}"]
    cfg = compose(CONFIG_DIR, "train.yaml", overrides)
    assert cfg == jcompose(CONFIG_DIR, "train.yaml", overrides)
    dm = build_datamodule(cfg["datamodule"], device="cpu")
    dm.prepare_data()
    dm.setup()
    batch = next(iter(dm.val_batches()))
    model, name = tasks.build_model(cfg["model"], device="cpu")
    jmodel, jname = jtasks.build_model(cfg["model"])
    assert name == jname
    if task != "cpd":
        assert type(model.encoder.interaction_0).__name__ == OTHER[task] == jmodel.layer_class
    jb = tbm.jax_batch(batch)
    jloss_fn = jtasks.build_loss(jname)

    def loss_of(p):
        out = jmodel.apply(p, jb, True)
        return jloss_fn(out, jb)[0], out

    # the port's weights in the flax tree (their names are the flax paths)
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(to_jax_params(model.state_dict()))
    tb = batch.to("cpu")
    out = model(tb)
    loss = tasks.build_loss(name)(out, tb)[0]
    want = np.asarray(jout[0] if isinstance(jout, tuple) else jout)
    real = tbm._real(name, batch)
    assert np.abs(want[real]).max() > 1e-3
    np.testing.assert_allclose(np_(out)[real], want[real], atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    loss.backward()
    want_grads = from_jax_params(jgrads)
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert got.keys() == want_grads.keys()
    for k, g in got.items():
        np.testing.assert_allclose(np_(g), want_grads[k].numpy(), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("task,settings", [
    ("lba", ["model.layer_class._target_=gcpnet_tpu.nn.GCPInteractions2", "datamodule.max_units=1500"]),
    ("cpd", ["datamodule.max_units=80", "datamodule.unit=node"]),
    ("eq", ["model.layer_class._target_=gcpnet_tpu.nn.GCPInteractions", "datamodule.subset_to_ca_atoms_only=true"]),
])
def test_new_settings_train_and_evaluate(tmp_path, scipy_radius_graph, monkeypatch, task, settings):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    small = [f"experiment={EXPERIMENTS[task]}", *tbm.SMALL, *tbm._data(task, str(tmp_path)), *settings,
             "trainer.accelerator=cpu", "extras.print_config=false"]
    trained = entry.main(small + ["trainer.max_epochs=1", "trainer.min_epochs=0"])
    assert np.isfinite(trained["test/loss"])
    again = eval_entry.main(small + [f"ckpt_path={tmp_path}/logs/train/runs/checkpoints", "+cpd_num_samples=1"])
    assert again["test/loss"] == trained["test/loss"]
