"""The port's NMS slice against the JAX package, on the CPU.

- The simulator: the port's ``"numpy"`` and ``"torch"`` integrators (the
  latter on the CPU) against the JAX ``simulate_batch(..., backend="numpy")``
  at T = 600, seed 7: equal bit for bit (the same float64 leapfrog in the
  same op order, from the same generator stream).
- The datamodule: the port's receiver-sorted CSR batches against the JAX
  module's slot-major dense ones on the same cached splits: node features,
  labels and the shuffle order equal, edge features equal after mapping
  each port row to the JAX row of the same (sender, receiver) pair.
- ``GCPNetNMS``'s predicted positions (with and without the force term)
  and every parameter's gradient of ``nms_loss`` against the JAX model on
  the JAX datamodule's batch, the port on its own: fp32 atol 1e-4.  The
  port's frames carry no gradient (they depend only on the input
  positions), and the gradients agree all the same.
- ``GCPInteractions`` with position updates against the reference's golden
  fixture ``tests/golden/interactions_posupdate.npz``: fp32 atol 1e-4.
"""

import json
import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

from _torch_parity import np_, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.nms import NMSDataModule as JNMSDataModule
from gcpnet_tpu.data.nms_sim import SimConfig as JSimConfig
from gcpnet_tpu.data.nms_sim import generate_split as jgenerate_split
from gcpnet_tpu.data.nms_sim import simulate_batch as jsimulate_batch
from gcpnet_tpu.models import GCPNetNMS as JGCPNetNMS
from gcpnet_tpu.models import nms_loss as jnms_loss
from gcpnet_tpu.utils.torch_compat import translate_state_dict
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import features
from gcpnet_torch.data.batching import sort_edges_by_receiver
from gcpnet_torch.data.nms import NMSDataModule
from gcpnet_torch.data.nms_sim import SimConfig, generate_split, simulate_batch
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.nn.frames import decentralize
from gcpnet_torch.nn.interactions import GCPInteractions
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.ops.edge_map import KINK_MARGIN, kink_margins
from gcpnet_torch.nn.primitives import ScalarVector, pack_vector
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "interactions_posupdate.npz")

# the small NMS configuration of these tests: 2 interaction layers of
# 3-layer message stacks, hidden 16/4/8/4, on 5-body graphs
NMS_MODEL = dict(
    h_input_dim=1, chi_input_dim=3, e_input_dim=17, xi_input_dim=1, h_hidden_dim=16,
    chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2,
    dropout=0.0, dense_dropout=0.0,
)
NMS_MESSAGE_LAYERS = 3
SPLITS = dict(data_mode="small", batch_size=16, num_train=32, num_valid=16, num_test=16)


@pytest.fixture(scope="module")
def nms_root(tmp_path_factory):
    """Small NMS splits cached by the JAX datamodule (its default generator)."""
    root = str(tmp_path_factory.mktemp("nms"))
    JNMSDataModule(data_root=root, **SPLITS).prepare_data()
    return root


def _datamodules(root):
    jdm = JNMSDataModule(data_root=root, **SPLITS)
    dm = NMSDataModule(data_root=root, **SPLITS)
    jdm.setup()
    dm.setup()
    return jdm, dm


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("mode", ["small", "small_20body", "dynamic"])
def test_simulator_matches_jax(mode, backend):
    want = jsimulate_batch(JSimConfig.for_mode(mode), 2, np.random.default_rng(7), T=600, backend="numpy")
    got = simulate_batch(SimConfig.for_mode(mode), 2, np.random.default_rng(7), T=600, backend=backend, device="cpu")
    for a, b, name in zip(got, want, ("loc", "vel", "edges", "charges")):
        np.testing.assert_array_equal(a, b, err_msg=f"{mode} {backend}: {name}")
    assert got[0].shape == (2, 5, SimConfig.for_mode(mode).n_balls, 3)


def test_generate_split_matches_jax():
    """A split in chunks drawn from one seeded stream, as the JAX
    ``generate_split`` (its XLA integrator, bit for bit the numpy loop at
    this horizon) draws it."""
    want = jgenerate_split("small", 5, seed=3, T=300, chunk=2)
    got = generate_split("small", 5, seed=3, T=300, chunk=2, backend="torch", device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (5, 2, 5, 3) and all(a.dtype == np.float32 for a in got)
    with pytest.raises(ValueError, match="backend"):
        simulate_batch(SimConfig(), 1, np.random.default_rng(0), T=200, backend="xla")


def test_features_match_jax():
    from gcpnet_tpu.data import features as jfeatures

    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    x[3] = x[2]  # a zero difference: the unit vector is 0
    d = np.abs(rng.normal(size=(5, 4))) * 5
    np.testing.assert_array_equal(features.normalize(x[1:] - x[:-1]), jfeatures.normalize(x[1:] - x[:-1]))
    np.testing.assert_array_equal(features.rbf(d, d_max=4.5), jfeatures.rbf(d, d_max=4.5))
    np.testing.assert_array_equal(features.orientations(x), jfeatures.orientations(x))


def _jax_row_of_port_row(jbatch, batch) -> np.ndarray:
    jrows = {(int(s), int(r)): i for i, (s, r) in enumerate(zip(jbatch.senders, jbatch.receivers))}
    return np.asarray([jrows[(int(s), int(r))] for s, r in zip(batch.senders, batch.receivers)])


def test_datamodule_matches_jax(nms_root):
    jdm, dm = _datamodules(nms_root)
    assert dm.num_batches("train") == jdm.num_batches("train") == 2
    for split, (jbatches, batches) in {
        "train epoch 0": (jdm.train_batches(0), dm.train_batches(0)),
        "train epoch 1": (jdm.train_batches(1), dm.train_batches(1)),
        "valid": (jdm.val_batches(), dm.val_batches()),
    }.items():
        pairs = list(zip(jbatches, batches))
        assert len(pairs) == 2 if split.startswith("train") else 1
        for jb, b in pairs:
            for name in ("h", "chi", "x", "graph_id", "node_pad_mask"):
                np.testing.assert_array_equal(np.asarray(getattr(jb, name)), getattr(b, name), err_msg=f"{split} {name}")
            np.testing.assert_array_equal(np.asarray(jb.extras["label"]), b.extras["label"])
            rows = _jax_row_of_port_row(jb, b)
            assert sorted(rows) == list(range(jb.num_edges))  # a permutation of the JAX rows
            np.testing.assert_array_equal(np.asarray(jb.e)[rows], b.e, err_msg=split)
            np.testing.assert_array_equal(np.asarray(jb.xi)[rows], b.xi, err_msg=split)
            # the port's layout is the CSR layout of sort_edges_by_receiver
            again = sort_edges_by_receiver(b.replace(edge_row_splits=None), tile=1)
            np.testing.assert_array_equal(again.senders, b.senders)
            np.testing.assert_array_equal(again.edge_row_splits, b.edge_row_splits)
            assert np.all(np.diff(b.receivers) >= 0) and b.edge_row_splits[-1] == b.num_edges
    # a different epoch seed gives a different order
    first = [b.x for b in dm.train_batches(0)]
    assert not np.array_equal(first[0], next(dm.train_batches(1)).x)


def _port_nms(params, ablate: bool) -> GCPNetNMS:
    """The port's model with the JAX parameters (those of the force term
    left out when ``ablate``)."""
    model = GCPNetNMS(
        ModelCfg(**NMS_MODEL), ModuleCfg(ablate_x_force_update=ablate),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=NMS_MESSAGE_LAYERS)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    state = from_jax_params(params)
    model.load_state_dict({k: v for k, v in state.items() if not (ablate and "phi_force" in k)})
    return model


@pytest.fixture(scope="module", params=[True, False], ids=["ablate_force", "force"])
def jax_nms(request, nms_root):
    """The JAX NMS model on the JAX datamodule's first validation batch:
    (ablate, params, predictions, loss, gradient tree).  With the force
    term on, its kernel is scaled up 300 x so that the term moves the
    positions by more than the tolerance."""
    ablate = request.param
    jdm, _ = _datamodules(nms_root)
    batch = to_jax(next(jdm.val_batches()))
    model = JGCPNetNMS(
        model_cfg=JModelCfg(**NMS_MODEL), module_cfg=JModuleCfg(ablate_x_force_update=ablate),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=NMS_MESSAGE_LAYERS)),
    )
    params = jax.jit(model.init, static_argnums=2)(jax.random.key(0), batch, True)
    if not ablate:
        params = jax.tree_util.tree_map_with_path(
            lambda path, p: p * 300.0 if "phi_force_ij_kernel" in jax.tree_util.keystr(path) else p, params
        )

    @jax.jit
    def run(p):
        def loss_fn(q):
            preds = model.apply(q, batch, True)
            return jnms_loss(preds, batch)[0], preds

        (loss, preds), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return preds, loss, grads

    preds, loss, grads = run(params)
    return ablate, params, np.asarray(preds), float(loss), grads


def test_nms_forward_matches_jax(jax_nms, nms_root):
    ablate, params, want, _, _ = jax_nms
    _, dm = _datamodules(nms_root)
    batch = next(dm.val_batches())
    model = _port_nms(params, ablate)
    with torch.no_grad():
        got = model(batch.to("cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the positions moved, and (with the force term) the force moved them
    assert np.abs(got - batch.x).max() > 100 * ATOL
    if not ablate:
        with torch.no_grad():
            without = _port_nms(params, True)(batch.to("cpu")).numpy()
        assert np.abs(without - got).max() > 100 * ATOL


def test_nms_gradients_match_jax(jax_nms, nms_root):
    """``nms_loss`` and every parameter's gradient against ``jax.grad`` (no
    dropout); the frames the port builds require no gradient."""
    ablate, params, _, want_loss, want_grads = jax_nms
    _, dm = _datamodules(nms_root)
    batch = next(dm.val_batches()).to("cpu")
    model = _port_nms(params, ablate)
    loss, labels = nms_loss(model(batch), batch)
    assert torch.equal(labels, batch.extras["label"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=ATOL)
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert any("phi_force" in k for k in got) != ablate
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(np_(g), want[name].numpy(), atol=ATOL, err_msg=name)


def test_decentralize_and_scalar_embedding():
    x = torch.arange(12.0).reshape(4, 3)
    graph_id = torch.tensor([0, 0, 1, 1])
    centroid = torch.tensor([[1.0, 1.0, 1.0], [-1.0, 0.0, 2.0]])
    out = decentralize(x, graph_id, centroid, node_mask=torch.tensor([True, True, False, True]))
    np.testing.assert_array_equal(out.numpy()[[0, 1, 3]], (x + centroid[graph_id]).numpy()[[0, 1, 3]])
    assert not out[2].any()
    model = GCPNetNMS(
        ModelCfg(**NMS_MODEL), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=2)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    assert model.encoder.gcp_embedding.atom_embedding is None  # float node scalars, no table


@pytest.mark.parametrize("scalar_nonlinearity", ["relu", None, "leakyrelu"])
def test_relu_margins_find_a_kink(scalar_nonlinearity):
    """kink_margins, which tells a relu (or leaky relu) kink from a kernel
    fault where K3 parts from its plain version: row 0 (all-zero message) is
    put on the kink of layer 0's first scalar by its bias, so its margin is
    within float32 rounding of 0, while most other rows lie well off every
    kink; a stack without a kinked activation has no kink."""
    mp = GCPMessagePassing(
        (16, 4), (16, 4), (8, 4), ModuleCfg(scalar_nonlinearity=scalar_nonlinearity),
        LayerCfg(mp_cfg=MPCfg(num_message_layers=4)), generator=torch.Generator().manual_seed(0), device="cpu",
    )
    with torch.no_grad():
        stack = mp.packed_stack()
        s_in, _, h, _, _ = stack.layers[0].dims
        w = stack.layer_weights(stack.weights)[0]
        vnorm = float(np.sqrt(np.float32(1e-8))) + 1e-8  # the norm of a zero vector (eps 1e-8)
        w["b_so"][0] = -vnorm * w["w_so"][s_in : s_in + h, 0].double().sum()
    rng = np.random.default_rng(5)
    message = torch.from_numpy(rng.normal(size=(512, stack.in_dim)).astype(np.float32))
    message[0] = 0.0
    frames = torch.from_numpy(rng.normal(size=(512, 9)).astype(np.float32))
    margins = kink_margins(message, frames, stack)
    assert margins.shape == (512,) and margins.dtype == torch.float64
    if scalar_nonlinearity is None:
        assert bool(torch.isinf(margins).all())
        return
    assert margins[0] <= 2.0**-20
    assert bool(((margins >= 0) & (margins <= 1)).all())
    assert (margins[1:] > KINK_MARGIN).double().mean() > 0.9


def test_interactions_posupdate_golden():
    """The reference's own fixture of one interaction layer with position
    updates and the force term (node dims 8/4, edges 6/2, 4 message layers,
    node_positions_weight 1.5), weights translated as
    tests/test_parity_golden.py translates them."""
    z = np.load(GOLDEN)
    meta = json.loads(str(z["meta"]))
    ins = {k[3:]: z[k] for k in z.files if k.startswith("in:")}
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd:")}
    outs = {k[4:]: z[k] for k in z.files if k.startswith("out:")}
    assert meta["updating_node_positions"] and not meta["cfg"]["ablate_x_force_update"]
    module = GCPInteractions(
        tuple(meta["node_dims"]), tuple(meta["edge_dims"]), ModuleCfg.from_dict(meta["cfg"]),
        LayerCfg.from_dict(meta["layer_cfg"]), dropout=0.0, updating_node_positions=True,
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    module.load_state_dict(from_jax_params(translate_state_dict(sd)))
    f32 = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in ins.items() if k != "edge_index"}
    senders, receivers = (torch.from_numpy(ins["edge_index"][i].astype(np.int64)) for i in (0, 1))
    with torch.no_grad():
        node_rep, pos = module(
            ScalarVector(f32["hs"], pack_vector(f32["hv"])), ScalarVector(f32["es"], pack_vector(f32["ev"])),
            senders, receivers, f32["frames"].reshape(-1, 9), node_pos=f32["x"],
        )
    np.testing.assert_allclose(pos.numpy(), outs["pos"], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(node_rep.scalar.numpy(), outs["scalar"], atol=ATOL, rtol=ATOL)
    vec = node_rep.vector.reshape(-1, 3, meta["node_dims"][1]).transpose(1, 2).numpy()
    np.testing.assert_allclose(vec, outs["vector"], atol=ATOL, rtol=ATOL)
