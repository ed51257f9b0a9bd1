"""The port's training step against the JAX package, on the CPU (split
from ``test_torch_train.py``, which holds the gradients).

- Three fp32 Adam steps with the adaptive clip against the JAX ``Trainer``'s
  own step (plain-XLA fast stack: the fused path's math): losses and
  parameters at atol 1e-4.
- The bf16 step against the port's own fp32 step; dropout; the gradient-norm
  ring against the JAX ring, and its NaN case; optimizers and schedules
  against optax; the ``python -m gcpnet_torch.train`` entry point.
"""

import json

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcpnet_tpu.nn.gcp as jgcp
import gcpnet_tpu.nn.message_passing as jmp
import gcpnet_tpu.ops.pallas_fused as jpallas_fused
from _torch_parity import LBA_BUCKET, LBA_MESSAGE_LAYERS, LBA_MODEL, lba_graphs, np_, port_batch, port_lba, random_graphs, t
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.batching import Bucket as JBucket
from gcpnet_tpu.data.batching import collate_shards as jcollate_shards
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
from gcpnet_tpu.models.lba import graph_regression_loss as jgraph_regression_loss
from gcpnet_tpu.parallel.mesh import make_mesh
from gcpnet_tpu.train.optim import PlateauController as JPlateauController
from gcpnet_tpu.train.optim import build_optimizer as jbuild_optimizer
from gcpnet_tpu.train.optim import build_schedule as jbuild_schedule
from gcpnet_tpu.train.state import GradNormRing as JGradNormRing
from gcpnet_tpu.train.trainer import Trainer
from gcpnet_torch.models.lba import graph_regression_loss
from gcpnet_torch.nn.primitives import GCPDropout
from gcpnet_torch.nn.primitives import ScalarVector as ScalarVectorT
from gcpnet_torch.ops.edge_map import edge_map, edge_map_backward
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.optim import PlateauController, build_optimizer, build_schedule
from gcpnet_torch.train.state import GradNormRing, TrainState
from gcpnet_torch.train.step import train_step
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4


def _train_graphs():
    """Three batches of graphs; the second with labels far off, so that its
    gradient norm exceeds the adaptive clip's threshold."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        graphs = random_graphs(rng, num_graphs=2, nodes=20, edges=70)
        if i == 1:
            for g in graphs:
                g["extras"]["label"] = np.float32(g["extras"]["label"] * 10 + 20)
        out.append(graphs)
    return out


def test_adam_steps_match_jax_trainer(monkeypatch):
    """Three fp32 Adam steps with the adaptive clip on, against the JAX
    Trainer's own train step (dropout off; plain-XLA fast stack)."""
    monkeypatch.setattr(jmp, "USE_FAST_STACK", True)
    monkeypatch.setattr(jpallas_fused, "USE_FUSED_MESSAGE", False)
    monkeypatch.setattr(jgcp, "USE_FUSED_GCP", False)
    optimizer_cfg = {"_target_": "Adam", "lr": 1e-4}
    no_dropout = dict(dropout=0.0, dense_dropout=0.0)
    graphs = _train_graphs()
    jmodel = JGCPNetLBA(
        model_cfg=JModelCfg(**LBA_MODEL, **no_dropout), module_cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=LBA_MESSAGE_LAYERS)), num_atom_types=9,
    )
    trainer = Trainer(
        jmodel, jgraph_regression_loss, optimizer_cfg=optimizer_cfg, mesh=make_mesh(jax.devices()[:1]),
        adaptive_clip=True, precision=32, early_stopping_patience=None,
    )
    jbatches = [
        trainer._put(jcollate_shards(
            [[JGraphData(**g) for g in gs]], JBucket(*LBA_BUCKET), extra_graph_keys=("label",), sort_edges=True,
        ))
        for gs in graphs
    ]
    state = trainer.init_state(jbatches[0])
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = trainer._build_train_step()
    want = []
    for b in jbatches:
        state, loss, gnorm = step(state, b, jax.random.key(0), jnp.float32(1.0))
        want.append((float(loss), float(gnorm), float(state.grad_norms.clip_threshold())))

    model = port_lba(params0, **no_dropout)
    tstate = TrainState(build_optimizer(model.parameters(), optimizer_cfg), ring=GradNormRing())
    got = []
    for gs in graphs:
        res = train_step(model, tstate, port_batch(gs).to("cpu"), graph_regression_loss)
        assert res.ok
        got.append((res.loss.item(), res.grad_norm.item(), tstate.ring.clip_threshold().item()))
    assert tstate.step == 3 and int(tstate.ring.count) == 3
    # the second batch's norm is clipped to the first's 1.5x
    assert got[1][1] > 1.5 * got[0][1]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    want_params = from_jax_params(state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(np_(p), want_params[name].numpy(), atol=ATOL, err_msg=name)


def test_bf16_step_tracks_fp32_step():
    """One bf16 step (bf16 copies of the fp32 masters) against the port's
    own fp32 step from the same weights: loss within 2% and gradient norm
    within 5% (bf16 keeps 8 bits), gradients with cosine similarity above
    0.99; the masters stay float32."""
    batch = port_batch(lba_graphs()).to("cpu")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = port_lba(dropout=0.0, dense_dropout=0.0)
        state = TrainState(build_optimizer(model.parameters(), {"lr": 1e-4}), compute_dtype=dtype)
        res = train_step(model, state, batch, graph_regression_loss)
        assert res.ok and res.loss.dtype == torch.float32
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
        out[dtype] = (res, torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    (r32, g32), (r16, g16) = out[torch.float32], out[torch.bfloat16]
    np.testing.assert_allclose(r16.loss.item(), r32.loss.item(), rtol=2e-2)
    np.testing.assert_allclose(r16.grad_norm.item(), r32.grad_norm.item(), rtol=5e-2)
    assert torch.nn.functional.cosine_similarity(g16, g32, dim=0) > 0.99


def test_dropout_training_mode():
    n, rate = 4000, 0.25
    x = ScalarVectorT(torch.ones(n, 16), torch.ones(n, 3 * 8))
    drop = GCPDropout(rate)
    out = drop(x, False, torch.Generator().manual_seed(0))
    # keep share ~ 1 - rate; kept values scaled by 1 / keep
    keep_s = (out.scalar != 0).float().mean().item()
    keep_v = (out.vector != 0).float().mean().item()
    assert abs(keep_s - (1 - rate)) < 0.01 and abs(keep_v - (1 - rate)) < 0.02
    np.testing.assert_allclose(np_(out.scalar[out.scalar != 0]), 1 / (1 - rate), rtol=1e-6)
    np.testing.assert_allclose(np_(out.vector[out.vector != 0]), 1 / (1 - rate), rtol=1e-6)
    # whole 3-vectors drop together: the x, y and z blocks share a mask
    kept = (out.vector != 0).reshape(n, 3, 8)
    assert torch.equal(kept[:, 0], kept[:, 1]) and torch.equal(kept[:, 0], kept[:, 2])
    # the same seed gives the same masks, another seed others
    again = drop(x, False, torch.Generator().manual_seed(0))
    other = drop(x, False, torch.Generator().manual_seed(1))
    assert torch.equal(again.scalar, out.scalar) and torch.equal(again.vector, out.vector)
    assert not torch.equal(other.scalar, out.scalar)
    # deterministic (or rate 0) is the identity; training needs a generator
    assert drop(x, True) is x and GCPDropout(0.0)(x, False) is x
    with pytest.raises(ValueError, match="Generator"):
        drop(x, False)
    plain = drop(torch.ones(n, 16), False, torch.Generator().manual_seed(0))
    assert abs((plain != 0).float().mean().item() - (1 - rate)) < 0.01


def test_model_dropout_draws_from_generator():
    batch = port_batch(lba_graphs()).to("cpu")
    model = port_lba()
    with torch.no_grad():
        a = model(batch, False, torch.Generator().manual_seed(5))
        b = model(batch, False, torch.Generator().manual_seed(5))
        c = model(batch, False, torch.Generator().manual_seed(6))
        d = model(batch)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_grad_norm_ring_matches_jax():
    norms = [1.0, 2.0, 0.5, 3.0, 1.5, 0.25, 4.0]
    ring, jring = GradNormRing(capacity=4), JGradNormRing.create(capacity=4)
    assert ring.clip_threshold().item() == float("inf")
    for value in norms:
        ring.push(torch.tensor(value))
        jring = jring.push(jnp.float32(value))
        np.testing.assert_allclose(ring.clip_threshold().item(), float(jring.clip_threshold()), rtol=1e-6)
        np.testing.assert_allclose(
            ring.clip_threshold(3.0).item(), float(jring.clip_threshold(3.0)), rtol=1e-6
        )
    assert int(ring.count) == 4 and int(ring.head) == len(norms) % 4


def test_nan_step_keeps_state_and_ring_finite():
    """A NaN loss leaves the parameters and the Adam moments as they were
    and the ring finite, while the step counter advances.  (The JAX ring,
    which takes the norm before the finite check, turns NaN.)"""
    graphs = lba_graphs()
    model = port_lba(dropout=0.0, dense_dropout=0.0)
    state = TrainState(build_optimizer(model.parameters(), {"lr": 1e-3}), ring=GradNormRing())
    assert train_step(model, state, port_batch(graphs).to("cpu"), graph_regression_loss).ok
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {k: v.clone() for s in state.optimizer.state.values() for k, v in s.items()}
    count = int(state.ring.count)
    for g in graphs:
        g["extras"]["label"] = np.float32("nan")
    res = train_step(model, state, port_batch(graphs).to("cpu"), graph_regression_loss)
    assert not res.ok and not np.isfinite(res.loss.item())
    assert state.step == 2 and int(state.ring.count) == count
    assert np.isfinite(state.ring.clip_threshold().item())
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    after = {k: v for s in state.optimizer.state.values() for k, v in s.items()}
    assert all(torch.equal(after[k], v) for k, v in moments.items())
    assert np.isnan(float(JGradNormRing.create().push(jnp.float32(1.0)).push(jnp.nan).clip_threshold()))


@pytest.mark.parametrize(
    "cfg",
    [
        {"_target_": "torch.optim.Adam", "lr": 1e-2},
        {"_target_": "Adam", "lr": 1e-2, "weight_decay": 1e-1},
        {"_target_": "AdamW", "lr": 1e-2, "weight_decay": 1e-1},
        {"_target_": "SGD", "lr": 1e-1, "momentum": 0.9},
        {"_target_": "Adam", "lr": 1e-2, "accumulate_grad_batches": 2},
    ],
    ids=["adam", "adam_l2", "adamw", "sgd_momentum", "adam_accumulate"],
)
def test_optimizers_match_optax(rng, cfg):
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(6)]
    tx = jbuild_optimizer(cfg)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    w = torch.nn.Parameter(t(w0))
    opt = build_optimizer([w], cfg)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        w.grad = t(g)
        opt.step()
        np.testing.assert_allclose(np_(w), np.asarray(params["w"]), atol=1e-6)


def test_schedules_match_jax():
    w = torch.nn.Parameter(torch.zeros(1))
    opt = build_optimizer([w], {"lr": 1.0})
    sched = build_schedule(opt, {"_target_": "StepLR", "step_size": "6 // 2", "gamma": 0.5})
    jsched = jbuild_schedule({"_target_": "StepLR", "step_size": "6 // 2", "gamma": 0.5}, base_lr=1.0)
    for i in range(8):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(i)), rtol=1e-6)
        opt.step()
        sched.step()
    assert build_schedule(opt, {"_target_": "ReduceLROnPlateau"}) is None
    assert build_schedule(opt, None) is None
    with pytest.raises(ValueError):
        build_schedule(opt, {"_target_": "CosineAnnealingLR"})
    plateau, jplateau = PlateauController(patience=1), JPlateauController(patience=1)
    for value in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7):
        assert plateau.update(value) == jplateau.update(value)


class _Weights(torch.nn.Module):
    """A "model" whose prediction is its weight matrix: with the loss
    ``sum(w * g)`` a batch ``g`` is the gradient."""

    def __init__(self, w0):
        super().__init__()
        self.w = torch.nn.Parameter(t(w0))

    def forward(self, batch, deterministic=True, generator=None):
        return self.w


def test_steplr_counts_updates_under_accumulation(rng):
    """Adam with accumulation 2 and StepLR (step size 2, gamma 0.5) through
    ``train_step``, against the JAX chain (``optax.MultiSteps`` around the
    scheduled Adam) on the same 8 gradients: the learning rate of every
    applied update and the weights after every mini-step, fp32 atol 1e-4.
    The schedule counts updates, not mini-steps, and torch does not warn
    that it stepped before the optimizer."""
    import warnings

    cfg = {"_target_": "Adam", "lr": 1e-2, "accumulate_grad_batches": 2}
    sched_cfg = {"_target_": "StepLR", "step_size": 2, "gamma": 0.5}
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(8)]
    jsched = jbuild_schedule(sched_cfg, base_lr=cfg["lr"])
    tx = jbuild_optimizer({**cfg, "_schedule_": jsched})
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)

    model = _Weights(w0)
    optimizer = build_optimizer(model.parameters(), cfg)
    state = TrainState(optimizer, scheduler=build_schedule(optimizer, sched_cfg))
    loss_fn = lambda preds, g: ((preds * g).sum(), g)  # noqa: E731
    lrs = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch's warning on the order of the steps
        for i, g in enumerate(grads):
            updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
            params = optax.apply_updates(params, updates)
            lr = float(optimizer.param_groups[0]["lr"])  # a device tensor the schedule writes in place
            assert train_step(model, state, t(g), loss_fn, deterministic=True).ok
            if i % 2 == 1:  # the second mini-step applies the update
                lrs.append(lr)
            np.testing.assert_allclose(np_(model.w), np.asarray(params["w"]), atol=1e-4, err_msg=f"mini-step {i}")
    np.testing.assert_allclose(lrs, [float(jsched(k)) for k in range(4)], rtol=1e-6)
    assert lrs == [1e-2, 1e-2, 5e-3, 5e-3]
    assert state.step == 8 and optimizer.mini_step == 0


def test_accumulation_state_round_trip(rng):
    """A checkpoint taken between the mini-steps of an accumulated update
    (its pending sum and count) goes on exactly as the run it came from."""
    cfg = {"_target_": "Adam", "lr": 1e-2, "accumulate_grad_batches": 2}
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [t(rng.normal(size=(5, 3))) for _ in range(5)]
    runs = []
    for restore_at in (None, 3):
        w = torch.nn.Parameter(t(w0))
        opt = build_optimizer([w], cfg)
        for i, g in enumerate(grads):
            if i == restore_at:
                saved = {"w": w.detach().clone(), "opt": opt.state_dict()}
                w = torch.nn.Parameter(saved["w"])
                opt = build_optimizer([w], cfg)
                opt.load_state_dict(saved["opt"])
                assert opt.mini_step == 1
            w.grad = g
            opt.step()
        runs.append(w.detach())
    assert torch.equal(runs[0], runs[1])


def test_train_cpu_entry_point(capsys):
    args = ["--steps", "2", "--graphs", "2", "--nodes", "16", "--edges-per-node", "6", "--device", "cpu"]
    launches = (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches)
    train_cli.main(args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert all(ln["updated"] and np.isfinite([ln["loss"], ln["grad_norm"], ln["ms"]]).all() for ln in lines)
    # the same seed gives the same run
    train_cli.main(args)
    again = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["loss"] for ln in again] == [ln["loss"] for ln in lines]
    # the CPU path launches no kernel
    assert (segment_sum_sorted.launches, edge_map.launches, edge_map_backward.launches) == launches


def test_train_entry_point_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--steps", "1", "--graphs", "1", "--nodes", "8", "--edges-per-node", "4"])
    with pytest.raises(RuntimeError):
        train_cli.build_lba_training(0)
