"""The GCP layer family of the port against the reference's golden
fixtures (``tests/golden/*.npz``: the reference modules' outputs on fixed
inputs), read as ``tests/test_parity_golden.py`` reads them for flax: the
fixture's torch weights translated by ``utils.torch_compat`` into flax
names, which the port shares (``weights.from_jax_params``); fp32 atol and
rtol 1e-4.

Held here: the GCP2 units (edge and node inputs, bottleneck with vector
residual, scalar output, self gate), GCP3 with ``feedforward_out``, the
message passing (mean ResGCP, without residual, and the sum with scalar
message attention keyed by sender), the pre-norm embedding, the
``GCPInteractions`` layer (node mask, post-norm, pre-norm with three
feed-forward GCPs), ``GCPInteractions2``
(default, GCP3, node mask, and pre-norm with scalar message attention,
sums over senders and AR's position update), the layer norm, and the
geometry (centring, frames, scalarize and vectorize on node and edge rows,
node-masked means).  The rest of the GCP family's fixtures (GCP v1, the
frame gates, E(3) mode, inputs without vectors) and the geometry's E(3)
outputs are held in ``tests/test_torch_gcp_family.py``.
"""

import json
import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest
import torch

from gcpnet_tpu.utils.torch_compat import translate_state_dict
from gcpnet_torch.config.schema import LayerCfg, ModuleCfg
from gcpnet_torch.graph import GraphBatch
from gcpnet_torch.nn.embedding import GCPEmbedding
from gcpnet_torch.nn.frames import (
    NodeFrames, centralize, decentralize, localize, node_mean_frames, scalarize, vectorize,
)
from gcpnet_torch.nn.gcp import GCP_CLASSES, GCPSettings
from gcpnet_torch.nn.interactions import GCPInteractions, GCPInteractions2
from gcpnet_torch.nn.message_passing import GCPMessagePassing
from gcpnet_torch.nn.primitives import GCPLayerNorm, ScalarVector, pack_vector
from gcpnet_torch.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL = RTOL = 1e-4
CASES = [
    "gcp2_default_edge", "gcp2_default_node", "gcp2_bottleneck_residual", "gcp2_scalar_out", "gcp2_self_gate",
    "gcp3_feedforward", "mp_mean_resgcp", "mp_no_residual", "mp_sum_attention_row", "embedding_prenorm",
    "interactions_node_mask", "interactions_postnorm", "interactions_prenorm_ff3", "interactions2_default",
    "interactions2_gcp3", "interactions2_node_mask", "interactions2_attention_posupdate", "gcp_layer_norm", "geometry",
]
GEN = dict(generator=torch.Generator().manual_seed(0), device="cpu")


def _load(name):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    meta = json.loads(str(z["meta"]))
    ins = {k[3:]: z[k] for k in z.files if k.startswith("in:")}
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd:")}
    outs = {k[4:]: z[k] for k in z.files if k.startswith("out:")}
    return meta, ins, sd, outs


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _sv(s, v):
    return ScalarVector(_t(s), pack_vector(_t(v)))


def _edges(ins):
    ei = ins["edge_index"].astype(np.int64)
    return torch.from_numpy(ei[0]), torch.from_numpy(ei[1])


def _check(got, want, label):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL, err_msg=label)


def _check_vec(packed, want, label):
    c = want.shape[-2]
    _check(packed.reshape(-1, 3, c).transpose(1, 2), want, label)


def _loaded(module, sd):
    module.load_state_dict(from_jax_params(translate_state_dict(sd)))
    return module


def _gcp(meta, ins, sd, outs):
    cfg, nl = meta["cfg"], meta["nonlinearities"]
    settings = GCPSettings(
        scalar_nonlinearity=nl[0], vector_nonlinearity=nl[1], scalar_gate=cfg["scalar_gate"],
        vector_gate=cfg["vector_gate"], frame_gate=cfg["frame_gate"], sigma_frame_gate=cfg["sigma_frame_gate"],
        bottleneck=cfg["bottleneck"], vector_residual=cfg["vector_residual"],
        vector_frame_residual=cfg["vector_frame_residual"], ablate_frame_updates=cfg["ablate_frame_updates"],
        ablate_scalars=cfg["ablate_scalars"], ablate_vectors=cfg["ablate_vectors"],
        enable_e3_equivariance=cfg["enable_e3_equivariance"],
        feedforward_out=meta.get("extra_kwargs", {}).get("feedforward_out", False),
    )
    module = _loaded(GCP_CLASSES[meta["cls"]](tuple(meta["in_dims"]), tuple(meta["out_dims"]), settings, **GEN), sd)
    senders, _ = _edges(ins)
    frames = _t(ins["frames"]).reshape(-1, 9)
    if meta["node_inputs"]:
        frames = NodeFrames(frames, senders, ins["s"].shape[0])
    out = module(_sv(ins["s"], ins["v"]), frames)
    if "vector" in outs:
        _check(out.scalar, outs["scalar"], "scalar")
        _check_vec(out.vector, outs["vector"], "vector")
    else:
        _check(out, outs["scalar"], "scalar")


def _message_passing(meta, ins, sd, outs):
    module = _loaded(GCPMessagePassing(
        tuple(meta["node_dims"]), tuple(meta["node_dims"]), tuple(meta["edge_dims"]),
        ModuleCfg.from_dict(meta["cfg"]), LayerCfg.from_dict(meta["layer_cfg"]),
        reduce_function=meta["reduce_function"], use_scalar_message_attention=meta["use_scalar_message_attention"],
        aggregate_with_row=meta["aggregate_with_row"], **GEN,
    ), sd)
    senders, receivers = _edges(ins)
    out = module(_sv(ins["hs"], ins["hv"]), _sv(ins["es"], ins["ev"]), senders, receivers,
                 _t(ins["frames"]).reshape(-1, 9))
    _check(out.scalar, outs["scalar"], "scalar")
    _check_vec(out.vector, outs["vector"], "vector")


def _interactions(meta, ins, sd, outs):
    cls = GCPInteractions if meta["cls"] == "GCPInteractions" else GCPInteractions2
    moves = meta["updating_node_positions"]
    assert not meta["autoregressive"] and not (moves and cls is GCPInteractions)
    module = _loaded(cls(
        tuple(meta["node_dims"]), tuple(meta["edge_dims"]), ModuleCfg.from_dict(meta["cfg"]),
        LayerCfg.from_dict(meta["layer_cfg"]), dropout=0.0, updating_node_positions=moves, **GEN,
    ), sd)
    senders, receivers = _edges(ins)
    kw = {}
    if meta["has_node_mask"]:
        # with a semantic node mask the denominators count every edge
        edges = senders.shape[0]
        kw = dict(node_mask=torch.from_numpy(ins["node_mask"]), edge_mask=torch.ones(edges, dtype=torch.bool),
                  count_mask=torch.ones(edges, dtype=torch.bool))
    if moves:
        kw["node_pos"] = _t(ins["x"])
    out = module(_sv(ins["hs"], ins["hv"]), _sv(ins["es"], ins["ev"]), senders, receivers,
                 _t(ins["frames"]).reshape(-1, 9), **kw)
    if moves:
        out, pos = out
        _check(pos, outs["pos"], "pos")
    _check(out.scalar, outs["scalar"], "scalar")
    _check_vec(out.vector, outs["vector"], "vector")


def _embedding(meta, ins, sd, outs):
    module = _loaded(GCPEmbedding(
        tuple(meta["edge_input_dims"]), tuple(meta["node_input_dims"]), tuple(meta["edge_hidden_dims"]),
        tuple(meta["node_hidden_dims"]), ModuleCfg.from_dict(meta["cfg"]), meta["num_atom_types"],
        pre_norm=meta["pre_norm"], **GEN,
    ), sd)
    n, e = ins["h"].shape[0], ins["es"].shape[0]
    senders, receivers = _edges(ins)
    batch = GraphBatch(
        h=torch.from_numpy(ins["h"].astype(np.int64)), chi=_t(ins["chi"]), e=_t(ins["es"]), xi=_t(ins["ev"]),
        x=torch.zeros(n, 3), senders=senders, receivers=receivers, graph_id=torch.zeros(n, dtype=torch.long),
        node_pad_mask=torch.ones(n, dtype=torch.bool), edge_pad_mask=torch.ones(e, dtype=torch.bool),
        graph_pad_mask=torch.ones(1, dtype=torch.bool),
        extras={"lig_flag": torch.from_numpy(ins["lig_flag"].astype(np.int64))},
    )
    node_rep, edge_rep = module(batch, _t(ins["frames"]).reshape(-1, 9))
    _check(node_rep.scalar, outs["node_scalar"], "node_scalar")
    _check_vec(node_rep.vector, outs["node_vector"], "node_vector")
    _check(edge_rep.scalar, outs["edge_scalar"], "edge_scalar")
    _check_vec(edge_rep.vector, outs["edge_vector"], "edge_vector")


def _layer_norm(meta, ins, sd, outs):
    module = _loaded(GCPLayerNorm(meta["ds"], device="cpu"), sd)
    out = module(_sv(ins["s"], ins["v"]))
    _check(out.scalar, outs["scalar"], "scalar")
    _check_vec(out.vector, outs["vector"], "vector")


def _geometry(meta, ins, sd, outs):
    n = meta["N"]
    x = _t(ins["x"])
    senders, receivers = _edges(ins)
    graph_id = torch.from_numpy((np.arange(n) >= meta["batch_index_split"]).astype(np.int64))
    centroid, centered = centralize(x, graph_id, 2)
    _check(centroid, outs["centroid"], "centroid")
    _check(centered, outs["centered"], "centered")
    # the fixture decentralizes the original x
    _check(decentralize(x, graph_id, centroid), outs["recovered"], "recovered")
    frames = localize(x, senders, receivers, norm_x_diff=True)
    _check(frames.reshape(-1, 3, 3), outs["frames"], "frames")
    nf = node_mean_frames(frames, senders, n)
    _check(scalarize(pack_vector(_t(ins["v9"])), nf), outs["scalarize_node"], "scalarize_node")
    _check(scalarize(pack_vector(_t(ins["e9"])), frames), outs["scalarize_edge"], "scalarize_edge")
    _check_vec(vectorize(_t(ins["gate_n"]), nf), outs["vectorize_node"], "vectorize_node")
    _check_vec(vectorize(_t(ins["gate_e"]), frames), outs["vectorize_edge"], "vectorize_edge")
    # node-masked numerators, every edge in the denominators
    node_mask = torch.from_numpy(ins["node_mask"])
    masked = node_mean_frames(frames, senders, n, node_mask[senders] & node_mask[receivers],
                              torch.ones(senders.shape[0], dtype=torch.bool))
    _check(scalarize(pack_vector(_t(ins["v9"])), masked), outs["scalarize_node_masked"], "scalarize_node_masked")
    _check_vec(vectorize(_t(ins["gate_n"]), masked), outs["vectorize_node_masked"], "vectorize_node_masked")


KINDS = {
    "gcp": _gcp, "message_passing": _message_passing, "interactions": _interactions, "embedding": _embedding,
    "layer_norm": _layer_norm, "geometry": _geometry,
}


@pytest.mark.parametrize("name", CASES)
def test_golden_fixture(name):
    meta, ins, sd, outs = _load(name)
    with torch.no_grad():
        KINDS[meta["kind"]](meta, ins, sd, outs)
