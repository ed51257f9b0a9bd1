"""The dense and sender-dense layouts in the port against the JAX package,
on the CPU.

- The host side (``densify_edges_by_receiver``, ``check_sender_budget``,
  and ``collate_shards`` / ``batches_from_dataset`` with the dense
  budgets): every array the JAX function makes, exactly; the senders'
  sorted form the port keeps (``sorted_index``) in place of the JAX
  slot-major permutation (``build_sender_perm``, ``invert_sender_perm``,
  ``attach_sender_perm``) is that permutation's CSR form; the budgets'
  overflow raises where the JAX functions raise.
- The dense ops: the slot sum, count and mean over a ``DenseIndex``, the
  receiver gather as a broadcast, and ``gather_rows``, ``segment_sum``
  and ``sender_mean`` over the senders' sorted form, forward and gradients
  against the JAX ``gather_by_senders``, ``sender_sum`` and ``sender_mean``
  on the slot-major permutation, fp32 atol 1e-6.
- Whole models on a dense batch, forward and every parameter's gradient
  against ``jax.grad`` of the flax model with the same weights, fp32 atol
  1e-4: LBA on a JAX dense batch (with per-edge extras), and EQ (GCP3,
  ``aggregate_with_row``, message attention) on the batches of both EQ
  datamodules under ``GCPNET_EQ_DENSE=1`` (their arrays equal).
- The datamodules: ATOM3D's, CATH's and NMS's batches, laid out dense,
  against the JAX modules' dense default; the ``GCPNET_EQ_DENSE`` and
  ``GCPNET_AR_DENSE`` switches against the JAX modules' budgets.
"""

import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcpnet_tpu.data.native as jnative
from _torch_parity import LBA_MESSAGE_LAYERS, LBA_MODEL, load_jax_params, np_, port_lba, to_jax
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data import batching as jbatching
from gcpnet_tpu.data import eq as jeq
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models.eq import GCPNetEQ as JGCPNetEQ
from gcpnet_tpu.models.eq import eq_loss as j_eq_loss
from gcpnet_tpu.models.lba import GCPNetLBA as JGCPNetLBA
from gcpnet_tpu.models.lba import graph_regression_loss as j_graph_regression_loss
from gcpnet_tpu.ops import segment as jseg
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import batching, eq
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.models.lba import graph_regression_loss
from gcpnet_torch.ops import segment as seg
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-4
OPS_ATOL = 1e-6
DEG_MAX = 6


def _random_graph(rng, n=20, deg_max=DEG_MAX):
    """In-degree-capped edges, as the radius and kNN featurizers make them
    (``tests/test_dense_layout.py``'s graphs), as keyword arguments."""
    senders, receivers = [], []
    for i in range(n):
        deg = int(rng.integers(2, deg_max + 1))
        js = rng.choice([j for j in range(n) if j != i], size=deg, replace=False)
        senders.extend(js)
        receivers.extend([i] * deg)
    e = len(senders)
    return dict(
        h=rng.integers(0, 9, size=n).astype(np.int32),
        chi=rng.normal(size=(n, 2, 3)).astype(np.float32),
        e=rng.normal(size=(e, 16)).astype(np.float32),
        xi=rng.normal(size=(e, 1, 3)).astype(np.float32),
        x=(rng.normal(size=(n, 3)) * 4).astype(np.float32),
        senders=np.asarray(senders, np.int32),
        receivers=np.asarray(receivers, np.int32),
        extras={"label": np.float32(rng.normal()), "edge_tag": rng.normal(size=(e,)).astype(np.float32)},
    )


def _graphs(seed, num_graphs=2, n=20):
    rng = np.random.default_rng(seed)
    return [_random_graph(rng, n) for _ in range(num_graphs)]


def _bucket(graphs, module):
    n = sum(g["x"].shape[0] for g in graphs)
    e = sum(g["senders"].shape[0] for g in graphs)
    return module.Bucket(num_nodes=n + 4, num_edges=e + 11, num_graphs=len(graphs))


def _plain(graphs):
    """The same graphs as one plain (edge-list) batch of each package."""
    jb = jbatching.collate_shards([[JGraphData(**g) for g in graphs]], _bucket(graphs, jbatching),
                                  extra_graph_keys=("label",))
    b = batching.collate_shards([[GraphData(**g) for g in graphs]], _bucket(graphs, batching),
                                extra_graph_keys=("label",))
    return jb, b


def _csr_of(perm, num_nodes, num_edges):
    """``(perm, inv, splits)`` of a slot-major sender-dense permutation in
    CSR form: node by node, its slots in order, then the edge rows no slot
    holds in row order."""
    slots = np.asarray(perm).reshape(-1, num_nodes)
    node_major = slots.T.reshape(-1)
    real_rows = node_major[node_major >= 0].astype(np.int64)
    is_real = np.zeros(num_edges, dtype=bool)
    is_real[real_rows] = True
    csr = np.concatenate([real_rows, np.flatnonzero(~is_real)])
    inv = np.empty_like(csr)
    inv[csr] = np.arange(csr.shape[0])
    splits = np.concatenate([[0], np.cumsum((slots >= 0).sum(axis=0))]).astype(np.int32)
    return csr, inv, splits


def _assert_same_arrays(b, jb):
    """Every array of the JAX batch but its slot-major permutation, and
    the senders' sorted form the port keeps in its place."""
    for name in ("h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id", "node_pad_mask", "edge_pad_mask",
                 "graph_pad_mask", "node_mask", "edge_row_splits"):
        want, got = getattr(jb, name), getattr(b, name)
        assert (want is None) == (got is None), name
        if want is not None:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert sorted(b.extras) == sorted(jb.extras)
    for key in b.extras:
        np.testing.assert_array_equal(b.extras[key], np.asarray(jb.extras[key]), err_msg=key)
    assert b.edge_dense_degree == jb.edge_dense_degree and b.sender_out_degree == jb.sender_out_degree
    ours = batching.sorted_index(b.senders, b.edge_pad_mask, b.num_nodes)
    if jb.sender_perm is not None:
        for got, want in zip(ours, _csr_of(jb.sender_perm, b.num_nodes, b.num_edges)):
            np.testing.assert_array_equal(got, want)
    # the port's sorted form is the one every sorted batch carries
    if b.sender_perm is not None:
        for got, want in zip((b.sender_perm, b.sender_inv_perm, b.sender_splits), ours):
            np.testing.assert_array_equal(got, want)


# --- host side ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sender_perm_and_its_inverse_match_jax(seed):
    """The port's senders' sorted form is the JAX slot-major permutation
    read node by node: each real row's sorted position is its slot's
    (node ``n``, slot ``k``: ``splits[n] + k``, through the JAX inverse);
    and the budget check raises exactly where the JAX function does."""
    rng = np.random.default_rng(seed)
    n, e = 30, 150
    senders = rng.integers(0, n, size=e).astype(np.int32)
    real = rng.random(e) < 0.8
    budget = int(np.bincount(senders[real], minlength=n).max()) + seed
    perm = jbatching.build_sender_perm(senders, real, n, budget)
    jinv = jbatching.invert_sender_perm(perm, e)
    ours = batching.sorted_index(senders, real, n)
    for got, want in zip(ours, _csr_of(perm, n, e)):
        np.testing.assert_array_equal(got, want)
    _, inv, splits = ours
    slot, node = jinv[real] // n, jinv[real] % n
    np.testing.assert_array_equal(inv[real], splits[node] + slot)
    assert (jinv[~real] == -1).all()
    batching.check_sender_budget(senders, real, n, budget - seed)
    for fn in (batching.check_sender_budget, jbatching.build_sender_perm):
        with pytest.raises(ValueError, match="out-degree"):
            fn(senders, real, n, budget - seed - 1)


def test_densify_matches_jax():
    graphs = _graphs(0)
    jb, b = _plain(graphs)
    for out_degree in (None, 4 * DEG_MAX):
        want = jbatching.densify_edges_by_receiver(jb, DEG_MAX + 2, out_degree=out_degree)
        got = batching.densify_edges_by_receiver(b, DEG_MAX + 2, out_degree=out_degree)
        _assert_same_arrays(got, want)
        assert got.num_edges == got.num_nodes * (DEG_MAX + 2)
        np.testing.assert_array_equal(got.graph_splits, batching.with_sorted_indices(got).graph_splits)
    for module, batch in ((jbatching, jb), (batching, b)):
        with pytest.raises(ValueError, match="in-degree"):
            module.densify_edges_by_receiver(batch, 3)
        with pytest.raises(ValueError, match="out-degree"):
            module.densify_edges_by_receiver(batch, DEG_MAX + 2, out_degree=1)


def test_attach_sender_perm_matches_jax():
    """``collate_shards`` with the sender budget alone, the port's
    counterpart of the JAX ``attach_sender_perm``: the same edge list (or,
    with the port's sorted edges, the JAX batch sorted the same way), the
    budget recorded, the senders' sorted form the JAX permutation's CSR."""
    graphs = _graphs(1)
    jb, _ = _plain(graphs)
    ours = [[GraphData(**g) for g in graphs]]
    bucket = _bucket(graphs, batching)
    _assert_same_arrays(batching.collate_shards(ours, bucket, extra_graph_keys=("label",), dense_out_degree=24),
                        jbatching.attach_sender_perm(jb, 24))
    want = jbatching.sort_edges_by_receiver(jbatching.attach_sender_perm(jb, 24), tile=1)
    got = batching.collate_shards(ours, bucket, extra_graph_keys=("label",), sort_edges=True, sort_tile=1,
                                  dense_out_degree=24)
    assert got.sender_out_degree == 24 and got.edge_row_splits is not None
    for name in ("senders", "receivers", "e", "edge_pad_mask", "edge_row_splits"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    with pytest.raises(ValueError, match="out-degree"):
        jbatching.attach_sender_perm(jb, 2)
    with pytest.raises(ValueError, match="out-degree"):
        batching.collate_shards(ours, bucket, extra_graph_keys=("label",), sort_edges=True, sort_tile=1,
                                dense_out_degree=2)


def test_batches_from_dataset_dense_matches_jax():
    graphs = [g for seed in range(3) for g in _graphs(seed, num_graphs=2)]
    bucket = (50, 400, 2)
    jbs = list(jbatching.batches_from_dataset(
        [JGraphData(**g) for g in graphs], jbatching.Bucket(*bucket), drop_last=False,
        extra_graph_keys=("label",), dense_degree=DEG_MAX, dense_out_degree=3 * DEG_MAX))
    bs = list(batching.batches_from_dataset(
        [GraphData(**g) for g in graphs], batching.Bucket(*bucket), extra_graph_keys=("label",),
        dense_degree=DEG_MAX, dense_out_degree=3 * DEG_MAX))
    assert len(bs) == len(jbs) == 3
    for b, jb in zip(bs, jbs):
        _assert_same_arrays(b, jb)


# --- the ops --------------------------------------------------------------


def _ops_operands(seed=3):
    graphs = _graphs(seed)
    jb, b = _plain(graphs)
    jd = jbatching.densify_edges_by_receiver(jb, DEG_MAX + 2, out_degree=4 * DEG_MAX)
    d = batching.densify_edges_by_receiver(b, DEG_MAX + 2, out_degree=4 * DEG_MAX)
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(d.num_edges, 7)).astype(np.float32)
    nodes = rng.normal(size=(d.num_nodes, 5)).astype(np.float32)
    pad = np.asarray(d.edge_pad_mask)
    mask = pad & (rng.random(d.num_edges) < 0.8)
    return jd, d.to(torch.device("cpu")), data, nodes, pad, mask


def test_dense_receiver_ops_match_jax():
    jd, d, data, nodes, pad, mask = _ops_operands()
    n, k = d.num_nodes, d.edge_dense_degree
    rids = d.receiver_index()
    assert isinstance(rids, seg.DenseIndex) and rids.degree == k
    recv = jnp.asarray(np.asarray(jd.receivers))
    jm, jpad = jnp.asarray(mask), jnp.asarray(pad)

    def port(fn):
        x = torch.tensor(data, requires_grad=True)
        out = fn(x)
        out.backward(torch.ones_like(out) * torch.arange(out.numel()).reshape(out.shape).float().sin())
        return out.detach().numpy(), x.grad.numpy()

    def jax_(fn):
        x = jnp.asarray(data)
        out, vjp = jax.vjp(fn, x)
        (g,) = vjp(jnp.sin(jnp.arange(out.size, dtype=jnp.float32)).reshape(out.shape))
        return np.asarray(out), np.asarray(g)

    tm, tpad = torch.tensor(mask), torch.tensor(pad)
    for got, want in (
        (port(lambda x: seg.segment_sum(x, rids, n, mask=tm)),
         jax_(lambda x: jseg.segment_sum(x, recv, n, mask=jm, dense_degree=k))),
        (port(lambda x: seg.segment_mean(x, rids, n, mask=tm, count_mask=tpad)),
         jax_(lambda x: jseg.segment_mean(x, recv, n, mask=jm, count_mask=jpad, dense_degree=k))),
    ):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=OPS_ATOL)
    np.testing.assert_array_equal(seg.segment_count(rids, n, mask=tm).numpy(),
                                  np.asarray(jseg.segment_count(recv, n, mask=jm, dense_degree=k)))
    with pytest.raises(ValueError, match="mask"):
        seg.segment_sum(torch.tensor(data), rids, n)
    # the receiver gather is a broadcast over the slots; its backward the slot sum
    x = torch.tensor(nodes, requires_grad=True)
    rows = seg.gather_rows(x, rids)
    np.testing.assert_array_equal(rows.detach().numpy(), nodes[np.asarray(jd.receivers)])
    cot = np.random.default_rng(0).normal(size=rows.shape).astype(np.float32)
    rows.backward(torch.tensor(cot))
    (want,) = jax.vjp(lambda v: v[recv], jnp.asarray(nodes))[1](jnp.asarray(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=OPS_ATOL)


def test_sender_ops_match_jax():
    """``gather_rows``, ``segment_sum`` and ``sender_mean`` over the
    senders' sorted form against the JAX ``gather_by_senders``,
    ``sender_sum`` and ``sender_mean`` on the slot-major permutation and its
    inverse (cotangents of padding rows zero, the JAX functions'
    contract)."""
    jd, d, data, nodes, pad, mask = _ops_operands(4)
    n = d.num_nodes
    sids = d.sender_index()
    assert isinstance(sids, seg.SortedIndex)
    snd = jnp.asarray(np.asarray(jd.senders))
    perm, inv, k_out = jnp.asarray(np.asarray(jd.sender_perm)), jnp.asarray(np.asarray(jd.sender_inv_perm)), \
        jd.sender_out_degree
    tm, tpad, jm, jpad = torch.tensor(mask), torch.tensor(pad), jnp.asarray(mask), jnp.asarray(pad)
    cot_rows = np.random.default_rng(1).normal(size=(d.num_edges, nodes.shape[1])).astype(np.float32) * pad[:, None]

    x = torch.tensor(nodes, requires_grad=True)
    rows = seg.gather_rows(x, sids)
    rows.backward(torch.tensor(cot_rows))
    out, vjp = jax.vjp(lambda v: jseg.gather_by_senders(v, snd, perm, k_out), jnp.asarray(nodes))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot_rows))[0]), atol=OPS_ATOL)

    cot = np.random.default_rng(2).normal(size=(n, data.shape[1])).astype(np.float32)
    for port_fn, jax_fn in (
        (lambda v: seg.segment_sum(v, sids, n, mask=tm),
         lambda v: jseg.sender_sum(v, snd, n, mask=jm, sender_perm=perm, out_degree=k_out, inv_perm=inv)),
        (lambda v: seg.sender_mean(v, sids, n, mask=tm, count_mask=tpad),
         lambda v: jseg.sender_mean(v, snd, n, mask=jm, count_mask=jpad, sender_perm=perm, out_degree=k_out,
                                    inv_perm=inv)),
    ):
        x = torch.tensor(data, requires_grad=True)
        got = port_fn(x)
        got.backward(torch.tensor(cot))
        want, vjp = jax.vjp(jax_fn, jnp.asarray(data))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=OPS_ATOL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), atol=OPS_ATOL)


# --- whole models ---------------------------------------------------------


def _assert_grads(port, want_grads):
    want = from_jax_params(want_grads)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(np_(g), np_(want[name]), atol=ATOL, err_msg=name)


def test_lba_on_a_dense_batch_matches_jax():
    graphs = _graphs(5, num_graphs=3)
    jb, b = _plain(graphs)
    jd = jbatching.densify_edges_by_receiver(jb, DEG_MAX + 2, out_degree=4 * DEG_MAX)
    d = batching.densify_edges_by_receiver(b, DEG_MAX + 2, out_degree=4 * DEG_MAX)
    _assert_same_arrays(d, jd)
    jmodel = JGCPNetLBA(model_cfg=JModelCfg(**LBA_MODEL), module_cfg=JModuleCfg(),
                        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=LBA_MESSAGE_LAYERS)), num_atom_types=9)
    jdense = to_jax(jd)
    params = jax.jit(lambda: jmodel.init(jax.random.key(0), jdense, True))()

    def loss_fn(p):
        out = jmodel.apply(p, jdense, True)
        return j_graph_regression_loss(out, jdense)[0], out

    (want_loss, want_out), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = port_lba(params)
    td = d.to(torch.device("cpu"))
    out = port(td)
    np.testing.assert_allclose(np_(out), np.asarray(want_out), atol=ATOL)
    loss, _ = graph_regression_loss(out, td)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    loss.backward()
    _assert_grads(port, want_grads)


EQ_MODEL = dict(
    h_input_dim=1281, chi_input_dim=2, e_input_dim=18, xi_input_dim=1, h_hidden_dim=16, chi_hidden_dim=4,
    e_hidden_dim=8, xi_hidden_dim=4, num_encoder_layers=2, dropout=0.0, dense_dropout=0.0,
)
EQ_LAYER = dict(use_scalar_message_attention=True, aggregate_with_row=True, num_feedforward_layers=1)
EQ_DATA = dict(batch_size=2, max_nodes_per_batch=640, max_residues_per_batch=80)


@pytest.fixture(scope="module")
def eq_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("eq"))
    write_eq_decoys(root, seed=2, targets={"train": 2, "valid": 1, "test": 1}, decoys=2, residues=(10, 30))
    return root


def _eq_batches(eq_root, tmp_path, monkeypatch):
    """The first validation batch of each package's EQ datamodule under
    ``GCPNET_EQ_DENSE=1`` (the JAX radius graph on its scipy path)."""
    monkeypatch.setenv("GCPNET_EQ_DENSE", "1")
    monkeypatch.setattr(jnative, "radius_graph_native", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("off")))
    kw = dict(splits_dir=os.path.join(eq_root, "splits"), decoy_dir=os.path.join(eq_root, "decoy_model"),
              true_dir=os.path.join(eq_root, "true_model"),
              esm_cache_dir=os.path.join(eq_root, "model_data_cache", "esm"), **EQ_DATA)
    jdm = jeq.EQDataModule(model_data_cache_dir=str(tmp_path / "jax"), **kw)
    dm = eq.EQDataModule(model_data_cache_dir=str(tmp_path / "port"), **kw)
    jdm.setup()
    dm.setup()
    return next(jdm.val_batches()), next(dm.val_batches())


def _eq_configs(model_cls, module_cls, layer_cls, mp_cls):
    return dict(model_cfg=model_cls(**EQ_MODEL), module_cfg=module_cls(selected_gcp="GCP3"),
                layer_cfg=layer_cls(**EQ_LAYER, mp_cfg=mp_cls(num_message_layers=2)))


def test_eq_with_aggregate_with_row_on_a_dense_batch_matches_jax(eq_root, tmp_path, monkeypatch):
    jb, b = _eq_batches(eq_root, tmp_path, monkeypatch)
    assert b.edge_dense_degree == 32 and b.sender_out_degree == 64
    for name in ("h", "e", "senders", "receivers", "edge_pad_mask"):
        np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(jb, name)), err_msg=name)
    for key in ("label", "res_mask", "atom_residue_idx", "atom_types"):
        np.testing.assert_array_equal(b.extras[key], np.asarray(jb.extras[key]), err_msg=key)
    jmodel = JGCPNetEQ(**_eq_configs(JModelCfg, JModuleCfg, JLayerCfg, JMPCfg))
    jbatch = to_jax(jb)
    params = jax.jit(lambda: jmodel.init(jax.random.key(3), jbatch, True))()

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, True)
        return j_eq_loss(out, jbatch)[0], out

    (want_loss, want_out), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = load_jax_params(GCPNetEQ(**_eq_configs(ModelCfg, ModuleCfg, LayerCfg, MPCfg),
                                    generator=torch.Generator().manual_seed(0), device="cpu"), params)
    tb = b.to(torch.device("cpu"))
    out = port(tb)
    real = b.extras["res_mask"] > 0
    np.testing.assert_allclose(np_(out)[real], np.asarray(want_out)[real], atol=ATOL)
    loss, _ = eq_loss(out, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    loss.backward()
    _assert_grads(port, want_grads)


# --- the datamodules' switches --------------------------------------------


def test_eq_dense_switch_is_off_by_default_and_for_ca_only(eq_root, tmp_path, monkeypatch):
    monkeypatch.delenv("GCPNET_EQ_DENSE", raising=False)
    dm = eq.EQDataModule.from_data_dir(eq_root, **EQ_DATA)
    assert dm.dense_budgets() == (None, None)
    monkeypatch.setenv("GCPNET_EQ_DENSE", "true")
    assert dm.dense_budgets() == (32, 64)
    assert eq.EQDataModule.from_data_dir(eq_root, subset_to_ca_atoms_only=True, **EQ_DATA).dense_budgets() == (None,
                                                                                                              None)


def test_atom3d_and_cath_dense_batches_match_jax(tmp_path, monkeypatch):
    """The port's ATOM3D (PSR records) and CATH batches (receiver-sorted)
    laid out dense at the JAX modules' budgets equal the JAX modules' dense
    default batches (the JAX radius graph on its scipy path; CATH's kNN
    graph is numpy in both)."""
    from chip_smoke import write_psr_records
    from gcpnet_tpu.data import atom3d as jatom3d
    from gcpnet_tpu.data import cath as jcath
    from gcpnet_torch.data import atom3d, cath
    from gcpnet_torch.data.cath_synthetic import write_cath_chains

    monkeypatch.setattr(jnative, "radius_graph_native", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("off")))
    assert jbatching.DENSE_EDGES_DEFAULT
    write_psr_records(str(tmp_path / "atom3d"), targets={"train": 1, "val": 1, "test": 1}, decoys=3, atoms=(20, 40))
    write_cath_chains(str(tmp_path / "cath"), chains={"train": 2, "validation": 2, "test": 2}, lengths=(30, 60))
    kw = dict(batch_size=3, max_nodes_per_batch=256)
    atom3d_dm = atom3d.ATOM3DDataModule(task="PSR", data_dir=str(tmp_path / "atom3d"), **kw)
    cath_dm = cath.CATHDataModule(data_dir=str(tmp_path / "cath"), **kw)
    cases = [(jatom3d.ATOM3DDataModule(task="PSR", data_dir=str(tmp_path / "atom3d"), **kw), atom3d_dm,
              (atom3d_dm.max_neighbors, 2 * atom3d_dm.max_neighbors)),
             (jcath.CATHDataModule(data_dir=str(tmp_path / "cath"), **kw), cath_dm, (cath_dm.top_k, 2 * cath_dm.top_k))]
    for jdm, dm, budgets in cases:
        jdm.setup()
        dm.setup()
        jbs, bs = list(jdm.val_batches()), list(dm.val_batches())
        assert len(bs) == len(jbs) > 0
        for b, jb in zip(bs, jbs):
            assert b.edge_dense_degree is None and b.edge_row_splits is not None
            assert jb.edge_dense_degree == budgets[0] and jb.sender_out_degree == budgets[1]
            _assert_same_arrays(batching.densify_edges_by_receiver(b, *budgets), jb)


def test_nms_dense_layout_matches_jax(tmp_path):
    """The port's NMS batch (receiver-sorted CSR) laid out dense at the
    fully connected degree ``n - 1`` equals the JAX module's dense batch."""
    from gcpnet_tpu.data.nms import NMSDataModule as JNMSDataModule
    from gcpnet_torch.data.nms import NMSDataModule

    kw = dict(data_mode="small", batch_size=4, num_train=8, num_valid=4, num_test=4)
    JNMSDataModule(data_root=str(tmp_path), **kw).prepare_data()  # the splits' cache both modules read
    jdm = JNMSDataModule(data_root=str(tmp_path), **kw)
    jdm.setup()
    dm = NMSDataModule(data_root=str(tmp_path), sim_device="cpu", **kw)
    dm.setup()
    jb, sorted_b = next(jdm.val_batches()), next(dm.val_batches())
    assert sorted_b.edge_dense_degree is None and sorted_b.edge_row_splits is not None
    degree = sorted_b.num_edges // sorted_b.num_nodes
    b = batching.densify_edges_by_receiver(sorted_b, degree, degree)
    for name in ("e", "xi", "senders", "receivers", "edge_pad_mask", "x", "h"):
        np.testing.assert_allclose(getattr(b, name), np.asarray(getattr(jb, name)), atol=1e-6, err_msg=name)
    assert b.edge_dense_degree == jb.edge_dense_degree == b.sender_out_degree == jb.sender_out_degree
    for got, want in zip((b.sender_perm, b.sender_inv_perm, b.sender_splits),
                         _csr_of(jb.sender_perm, b.num_nodes, b.num_edges)):
        np.testing.assert_array_equal(got, want)


def test_ar_sender_budget_switch(monkeypatch, tmp_path):
    from gcpnet_torch.data.ar import ARDataModule

    dm = ARDataModule.from_data_dir(str(tmp_path))
    monkeypatch.delenv("GCPNET_AR_DENSE", raising=False)
    assert dm.sender_budget() is None
    monkeypatch.setenv("GCPNET_AR_DENSE", "1")
    assert dm.sender_budget() == dm.k_max + 2 * dm.k_min


@pytest.mark.parametrize("value", ["1", "true", "True", "0", ""])
def test_layout_switches_read_as_in_jax(value, eq_root, monkeypatch):
    """``GCPNET_EQ_DENSE`` and ``GCPNET_AR_DENSE`` at ``value`` give the
    budgets the JAX modules' ``_dense_budgets`` and ``_sender_budget``
    give."""
    from gcpnet_tpu.data.ar import ARDataModule as JARDataModule
    from gcpnet_torch.data.ar import ARDataModule

    monkeypatch.setenv("GCPNET_EQ_DENSE", value)
    monkeypatch.setenv("GCPNET_AR_DENSE", value)
    dirs = [os.path.join(eq_root, d) for d in ("splits", "decoy_model", "true_model")]
    for ca in (False, True):
        assert eq.EQDataModule(*dirs, subset_to_ca_atoms_only=ca).dense_budgets() == \
            jeq.EQDataModule(*dirs, subset_to_ca_atoms_only=ca)._dense_budgets()
    assert ARDataModule(*dirs).sender_budget() == JARDataModule(*dirs)._sender_budget()
