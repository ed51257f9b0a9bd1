"""NMS datamodule: Newtonian many-body trajectories as receiver-sorted graph
batches.

Port of ``gcpnet_tpu/data/nms.py:40-253``.  The splits (seeds 42/43/44,
10,000/2,000/2,000 trajectories unless given) are generated by
``data.nms_sim`` and cached as ``.npz`` files under ``data_root``, the same
files and names the JAX module writes, so either package reads the other's
cache.  Featurized wholesale with numpy over fully connected graphs: node
scalar ``‖v‖``, node vectors ``[v, forward, backward]``, edge scalars ``[q_i
q_j, RBF16(d)]``, edge vectors the unit ``r_ij``; the label is frame 40's
positions for frame 30's.

One difference from the JAX module: the edge layout.  The JAX module emits
the SLOT-MAJOR dense layout (``edge_dense_degree``), which runs no kernel
(``data.batching.densify_edges_by_receiver`` of a sorted batch gives
it).  Here every batch is sorted by receiver with plain CSR row splits
(node ``i`` owns rows ``[i (n-1), (i+1) (n-1))``): the fully connected
template leaves no spare edge row for the 128-row
alignment of the tiled layout, and CSR needs none.  The features equal the
JAX module's up to that permutation of the edge rows, and every aggregation
runs through K1 and every message stack through K2/K3 on the card.

NMS graphs have a fixed size, so a batch of ``B`` graphs is exactly
``(B n, B n (n-1))`` with no padding.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from gcpnet_torch.data.batching import Shards, with_sorted_indices
from gcpnet_torch.data.features import normalize, rbf
from gcpnet_torch.data.nms_sim import Mode, generate_split
from gcpnet_torch.device import DeviceLike
from gcpnet_torch.graph import GraphBatch


def _fc_edges(n: int):
    """Ordered fully connected pairs (i != j), sorted by receiver: receiver
    ``j``'s in-edges come from senders ``0..n-1`` without ``j``, in order."""
    receivers = np.repeat(np.arange(n, dtype=np.int32), n - 1)
    senders = np.asarray([i for j in range(n) for i in range(n) if i != j], np.int32)
    return senders, receivers


class NMSDataModule:
    """Generates (or loads cached) NMS splits and yields host
    :class:`GraphBatch` es, receiver-sorted with CSR row splits."""

    SPLIT_SEEDS = {"train": 42, "valid": 43, "test": 44}
    SPLIT_SIZES = {"train": 10000, "valid": 2000, "test": 2000}

    def __init__(
        self,
        data_root: str = "data/NMS",
        data_mode: Mode = "small",
        batch_size: int = 100,
        frame_0: int = 30,
        frame_T: int = 40,
        rbf_edge_dist_cutoff: float = 4.5,
        num_rbf: int = 16,
        num_train: Optional[int] = None,
        num_valid: Optional[int] = None,
        num_test: Optional[int] = None,
        sim_device: DeviceLike = None,
        shards: Shards = Shards(),
    ):
        """Missing splits are simulated on ``sim_device`` (``None``: the
        card) by ``data.nms_sim``'s float64 torch integrator.  ``shards``
        is this process's share of each batch: ``batch_size`` counts the
        global batch's graphs, and ``shards.count`` must divide it."""
        if batch_size % shards.count:
            raise ValueError(f"batch_size {batch_size} must be divisible by the {shards.count} shards")
        self.shards = shards
        self.data_root = data_root
        self.data_mode = data_mode
        self.batch_size = batch_size
        self.frame_0, self.frame_T = frame_0, frame_T
        self.d_max, self.num_rbf = rbf_edge_dist_cutoff, num_rbf
        self.sim_device = sim_device
        self.sizes = dict(self.SPLIT_SIZES)
        for split, size in (("train", num_train), ("valid", num_valid), ("test", num_test)):
            if size:
                self.sizes[split] = size
        self.splits = {}

    def _cache_path(self, split: str) -> str:
        n = self.sizes[split]
        return os.path.join(self.data_root, f"nms_{self.data_mode}_{split}_{n}.npz")

    def prepare_data(self) -> None:
        """Generate and cache every split that is not cached yet."""
        os.makedirs(self.data_root, exist_ok=True)
        for split, size in self.sizes.items():
            path = self._cache_path(split)
            if os.path.exists(path):
                continue
            loc, vel, edges, charges = generate_split(
                self.data_mode, size, seed=self.SPLIT_SEEDS[split], device=self.sim_device
            )
            np.savez_compressed(path, loc=loc, vel=vel, edges=edges, charges=charges)

    def setup(self) -> None:
        for split in self.sizes:
            with np.load(self._cache_path(split)) as z:
                self.splits[split] = self._precompute_features(z["loc"], z["vel"], z["edges"])

    @property
    def num_nodes_per_graph(self) -> int:
        return self.splits["train"]["x"].shape[1]

    def _precompute_features(self, loc, vel, qq):
        """Featurize a whole split at once: per batch, the host only
        indexes and reshapes."""
        loc0 = loc[:, self.frame_0].astype(np.float32)  # [S, n, 3]
        locT = loc[:, self.frame_T].astype(np.float32)
        vel0 = vel[:, self.frame_0].astype(np.float32)
        S, n, _ = loc0.shape
        s, r = _fc_edges(n)

        h = np.linalg.norm(vel0, axis=-1, keepdims=True).astype(np.float32)
        fwd = normalize(loc0[:, 1:] - loc0[:, :-1])
        bwd = normalize(loc0[:, :-1] - loc0[:, 1:])
        zeros = np.zeros((S, 1, 3), np.float32)
        orient = np.stack([np.concatenate([fwd, zeros], axis=1), np.concatenate([zeros, bwd], axis=1)], axis=2)
        chi = np.concatenate([vel0[:, :, None, :], orient], axis=2).astype(np.float32)

        vec = loc0[:, s] - loc0[:, r]
        dist = np.linalg.norm(vec, axis=-1)
        e_rbf = rbf(dist, d_max=self.d_max, d_count=self.num_rbf)
        qq_e = qq[:, s, r][..., None].astype(np.float32)
        e_s = np.nan_to_num(np.concatenate([qq_e, e_rbf], axis=-1).astype(np.float32))
        e_v = np.nan_to_num(normalize(vec)[:, :, None, :].astype(np.float32))
        return {"h": h, "chi": chi, "e": e_s, "xi": e_v, "x": loc0, "label": locT, "senders": s, "receivers": r}

    def _featurize(self, split: str, idx: np.ndarray) -> GraphBatch:
        """One batch of the samples ``idx``: graph ``g``'s nodes are rows
        ``g n .. g n + n - 1`` and its edges follow graph ``g - 1``'s, so the
        batch stays sorted by receiver."""
        d = self.splits[split]
        B = idx.shape[0]
        n = d["x"].shape[1]
        offsets = (np.arange(B, dtype=np.int32) * n)[:, None]
        senders = (d["senders"][None, :] + offsets).reshape(-1)
        receivers = (d["receivers"][None, :] + offsets).reshape(-1)
        N, E = B * n, senders.shape[0]
        return with_sorted_indices(GraphBatch(
            h=d["h"][idx].reshape(N, 1),
            chi=d["chi"][idx].reshape(N, 3, 3),
            e=d["e"][idx].reshape(E, 1 + self.num_rbf),
            xi=d["xi"][idx].reshape(E, 1, 3),
            x=d["x"][idx].reshape(N, 3),
            senders=senders,
            receivers=receivers,
            graph_id=np.repeat(np.arange(B, dtype=np.int32), n),
            node_pad_mask=np.ones(N, bool),
            edge_pad_mask=np.ones(E, bool),
            graph_pad_mask=np.ones(B, bool),
            node_mask=None,
            edge_row_splits=(np.arange(N + 1) * (n - 1)).astype(np.int32),
            extras={"label": d["label"][idx].reshape(N, 3)},
        ))

    def num_batches(self, split: str) -> int:
        return self.sizes[split] // self.batch_size

    def batches(self, split: str, shuffle: bool = False, seed: int = 0) -> Iterator[GraphBatch]:
        """Full batches only (the last partial batch is dropped); ``shuffle``
        permutes the split with ``np.random.default_rng(seed)``.  Of each
        batch this process takes its shard's graphs (``Shards.split``: the
        JAX module's graphs per shard, with shard-local offsets)."""
        size = self.sizes[split]
        order = np.arange(size)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        bs = self.batch_size
        for start in range(0, size - bs + 1, bs):
            yield self._featurize(split, self.shards.split(order[start : start + bs]))

    def train_batches(self, seed: int = 0) -> Iterator[GraphBatch]:
        return self.batches("train", shuffle=True, seed=seed)

    def val_batches(self) -> Iterator[GraphBatch]:
        return self.batches("valid")

    def test_batches(self) -> Iterator[GraphBatch]:
        return self.batches("test")
