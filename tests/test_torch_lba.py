"""The port's LBA slice as a whole: host batching against the JAX package's,
the weight bridge, the full GCPNetLBA forward against the JAX model in its
``"fused"`` configuration (fast MM-form stack in the Pallas edge map, Pallas
sorted segment sum; interpret mode on the CPU) at fp32 with atol 1e-4, and
the ``predict`` entry point."""

import json

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcpnet_tpu.nn.gcp as jgcp
import gcpnet_tpu.nn.message_passing as jmp
import gcpnet_tpu.ops.pallas_fused as jpallas_fused
import gcpnet_tpu.ops.segment as jseg
from _torch_parity import (
    LBA_BUCKET as BUCKET,
    LBA_MESSAGE_LAYERS as MESSAGE_LAYERS,
    LBA_MODEL as MODEL,
    load_jax_params,
    np_,
    random_graphs,
    to_jax,
)
from gcpnet_tpu.config.schema import LayerCfg as JLayerCfg
from gcpnet_tpu.config.schema import ModelCfg as JModelCfg
from gcpnet_tpu.config.schema import ModuleCfg as JModuleCfg
from gcpnet_tpu.config.schema import MPCfg as JMPCfg
from gcpnet_tpu.data.batching import Bucket as JBucket
from gcpnet_tpu.data.batching import collate_shards as jcollate_shards
from gcpnet_tpu.data.batching import sort_edges_by_receiver as jsort_edges
from gcpnet_tpu.graph import GraphData as JGraphData
from gcpnet_tpu.models import GCPNetLBA as JGCPNetLBA
from gcpnet_torch import predict as port_predict
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data.batching import Bucket, collate_shards
from gcpnet_torch.graph import GraphData
from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.ops.edge_map import edge_map
from gcpnet_torch.ops.segment_sorted import segment_sum_sorted
from gcpnet_torch.weights import from_jax_params, save_npz, to_jax_params


def _graphs():
    return random_graphs(np.random.default_rng(3), num_graphs=2, nodes=20, edges=70)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX model in the fused configuration (the bench variant
    ``"fused"``), on the receiver-sorted batch: (params, predictions)."""
    batch = jcollate_shards(
        [[JGraphData(**g) for g in _graphs()]], JBucket(*BUCKET),
        extra_graph_keys=("label",), sort_edges=True,
    )
    assert batch.edge_row_splits is not None
    model = JGCPNetLBA(
        model_cfg=JModelCfg(**MODEL), module_cfg=JModuleCfg(),
        layer_cfg=JLayerCfg(mp_cfg=JMPCfg(num_message_layers=MESSAGE_LAYERS)), num_atom_types=9,
    )
    dev = to_jax(batch)
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(jmp, "USE_FAST_STACK", True)
        mp.setattr(jpallas_fused, "USE_FUSED_MESSAGE", True)
        mp.setattr(jseg, "USE_PALLAS_SEGMENT", True)
        mp.setattr(jgcp, "USE_FUSED_GCP", False)
        params = model.init(jax.random.key(0), dev, True)
        preds = np.asarray(model.apply(params, dev, True))
    return params, preds


def _port_model(params):
    model = GCPNetLBA(
        ModelCfg(**MODEL), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=MESSAGE_LAYERS)),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    return load_jax_params(model, params)


@pytest.mark.parametrize("tile", [128, 1])
def test_lba_forward_matches_jax_fused(jax_reference, tile):
    """Both the tile-aligned layout (as the JAX kernel needs it) and the
    hole-free CSR layout give the JAX predictions."""
    params, want = jax_reference
    batch = collate_shards(
        [[GraphData(**g) for g in _graphs()]], Bucket(*BUCKET),
        extra_graph_keys=("label",), sort_edges=True, sort_tile=tile,
    )
    with torch.inference_mode():
        got = _port_model(params)(batch.to("cpu"))
    np.testing.assert_allclose(np_(got), want, atol=1e-4)


def test_lba_forward_edge_list_layout(jax_reference):
    """Without row splits the port runs its module-path stack and index_add_
    mean: same predictions."""
    params, want = jax_reference
    batch = collate_shards([[GraphData(**g) for g in _graphs()]], Bucket(*BUCKET), extra_graph_keys=("label",))
    assert batch.edge_row_splits is None
    with torch.inference_mode():
        got = _port_model(params)(batch.to("cpu"))
    np.testing.assert_allclose(np_(got), want, atol=1e-4)


@pytest.mark.parametrize("tile", [128, 1])
def test_sorted_batching_matches_jax(tile):
    graphs = _graphs()
    jb = jsort_edges(
        jcollate_shards([[JGraphData(**g) for g in graphs]], JBucket(*BUCKET), extra_graph_keys=("label",)),
        tile=tile,
    )
    tb = collate_shards(
        [[GraphData(**g) for g in graphs]], Bucket(*BUCKET),
        extra_graph_keys=("label",), sort_edges=True, sort_tile=tile,
    )
    for name in ("h", "chi", "e", "xi", "x", "senders", "receivers", "graph_id",
                 "node_pad_mask", "edge_pad_mask", "graph_pad_mask", "edge_row_splits"):
        np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb.extras["label"], np.asarray(jb.extras["label"]))


def test_weight_bridge_round_trip(jax_reference, tmp_path):
    params, _ = jax_reference
    state = from_jax_params(params)
    assert "encoder.interaction_0.interaction.message_fusion_2.vector_down.kernel" in state
    back = to_jax_params(state)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(np.asarray(leaf), flat_back[path])
    path = tmp_path / "weights.npz"
    save_npz(state, path)
    again = from_jax_params(path)
    assert again.keys() == state.keys()
    for k in state:
        assert torch.equal(again[k], state[k])
    # strict load into the port model: every name matches
    _port_model(params)


def test_predict_cpu_entry_point(capsys, tmp_path):
    args = ["--graphs", "2", "--nodes", "16", "--edges-per-node", "6", "--batches", "2", "--device", "cpu"]
    launches = (segment_sum_sorted.launches, edge_map.launches)
    port_predict.main(args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["batch"] for ln in lines] == [0, 1]
    assert all(len(ln["predictions"]) == 2 and np.isfinite(ln["predictions"]).all() for ln in lines)
    # the same weights through --weights give the same predictions
    model = port_predict.build_model(0, "cpu")
    save_npz(model.state_dict(), tmp_path / "w.npz")
    port_predict.main(args + ["--weights", str(tmp_path / "w.npz"), "--seed", "0"])
    again = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert again == lines
    # the CPU path launches no kernel
    assert (segment_sum_sorted.launches, edge_map.launches) == launches


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_predict.main(["--graphs", "1", "--nodes", "8", "--edges-per-node", "4"])
    with pytest.raises(RuntimeError):
        port_predict.build_model(0)

