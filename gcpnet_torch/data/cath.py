"""The CATH 4.2 data path of CPD (protein design).

Port of ``gcpnet_tpu/data/cath.py``: chain records of ``chain_set.jsonl``
(``name``, ``seq``, ``coords`` keyed by atom name ``N``, ``CA``, ``C``,
``O``) split by ``chain_set_splits.json`` (``train``, ``validation``,
``test``), with the test subsets ``short`` (``test_split_L100.json``) and
``single_chain`` (``test_split_sc.json``) that CPD's metrics report
apart.  Chains become kNN residue graphs (``data.protein_graph``) with
``top_k`` neighbours, taken from ``features_cfg`` or 30: ``max_neighbors``
is accepted and not read, as in the JAX module.  The bucket holds
``max_nodes_per_batch`` nodes, or with ``max_units > 0`` comes from that
edge or node budget, as the JAX module's does (:meth:`CATHDataModule.bucket`).

Two differences from the JAX module.  ``prepare_data`` downloads nothing:
the files must be in ``data_dir``, and it raises naming those that are
missing.  Batches are receiver-sorted with CSR row splits (``tile=1``,
``data.batching.batches_from_dataset``), so on the card the encoder runs
K1, K2 and K3; the JAX module's default is the dense slot-major layout,
which the port does not have yet (the math is the same).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from gcpnet_torch.data.batching import Bucket, Shards, batches_from_dataset, made_ahead, make_bucket, shuffled_order
from gcpnet_torch.data.protein_graph import featurize_protein
from gcpnet_torch.graph import GraphBatch, GraphData

log = logging.getLogger(__name__)

BACKBONE_ATOMS = ("N", "CA", "C", "O")


class CATHDataModule:
    def __init__(
        self,
        data_dir: str = "data/CATH",
        file_name: str = "chain_set.jsonl",
        splits_file_name: str = "chain_set_splits.json",
        short_file_name: str = "test_split_L100.json",
        single_chain_file_name: str = "test_split_sc.json",
        max_neighbors: int = 32,
        batch_size: int = 8,
        features_cfg: Optional[Dict] = None,
        top_k: int = 30,
        num_rbf: int = 16,
        max_nodes_per_batch: int = 2048,
        max_units: int = 0,
        unit: str = "edge",
        shards: Shards = Shards(),
    ):
        """``max_units > 0`` packs under that budget of ``unit`` (``edge``
        or ``node``) instead of ``max_nodes_per_batch`` (:meth:`bucket`);
        ``shards`` is this process's share of each global batch."""
        self.data_dir = data_dir
        self.file_name = file_name
        self.splits_file_name = splits_file_name
        self.short_file_name = short_file_name
        self.single_chain_file_name = single_chain_file_name
        self.batch_size = batch_size
        self.features_cfg = features_cfg or {}
        self.top_k = int(self.features_cfg.get("top_k", top_k))
        self.num_rbf = num_rbf
        self.max_nodes_per_batch = max_nodes_per_batch
        self.max_units = max_units
        self.unit = unit
        self.shards = shards
        self.splits: Dict[str, List[dict]] = {}
        self.custom_splits: Dict[str, set] = {}
        self._featurized: Dict[str, List[int]] = {}  # split -> indices of the records that featurize

    def prepare_data(self) -> None:
        """Downloads nothing (the JAX module fetches the files from the
        CATH 4.2 release); raises naming the files not in ``data_dir``."""
        files = (self.file_name, self.splits_file_name, self.short_file_name, self.single_chain_file_name)
        missing = [f for f in files if not os.path.exists(os.path.join(self.data_dir, f))]
        if missing:
            raise FileNotFoundError(
                f"CATHDataModule: {missing} not found in {self.data_dir}; the port downloads nothing: "
                "stage chain_set.jsonl, chain_set_splits.json and the two test subsets there"
            )

    def setup(self, stage: Optional[str] = None) -> None:
        with open(os.path.join(self.data_dir, self.splits_file_name)) as f:
            split_ids = json.load(f)
        wanted = {name: set(ids) for name, ids in split_ids.items() if name in ("train", "validation", "test")}
        records: Dict[str, List[dict]] = {k: [] for k in wanted}
        with open(os.path.join(self.data_dir, self.file_name)) as f:
            for line in f:
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue
                name = entry.get("name") or entry.get("id")
                coords = entry.get("coords")
                if isinstance(coords, dict):
                    entry["coords"] = np.stack(
                        [np.asarray(coords[a], dtype=np.float32) for a in BACKBONE_ATOMS], axis=1
                    )
                for split, ids in wanted.items():
                    if name in ids:
                        records[split].append(entry)
        self.splits = {
            "train": records.get("train", []),
            "valid": records.get("validation", []),
            "test": records.get("test", []),
        }
        for key, fname in (("short", self.short_file_name), ("single_chain", self.single_chain_file_name)):
            path = os.path.join(self.data_dir, fname)
            if os.path.exists(path):
                with open(path) as f:
                    subset = json.load(f)
                self.custom_splits[key] = set(subset.get("test", subset))
        self._featurized = {}
        log.info("CATH splits: " + ", ".join(f"{k}={len(v)}" for k, v in self.splits.items()))

    # ------------------------------------------------------------------
    def _featurize(self, entry: dict) -> GraphData:
        return featurize_protein(entry, features_cfg=self.features_cfg, top_k=self.top_k, num_rbf=self.num_rbf)

    def named_graphs(self, split: str, index: Optional[List[int]] = None) -> Iterator[Tuple[str, GraphData]]:
        """``(name, graph)`` of the split's chains in record order (or the
        records ``index`` names, in its order), featurized on threads a few
        ahead (``data.batching.made_ahead``), skipping a chain that fails to
        featurize (``KeyError``, ``ValueError``), as the JAX module does.  A
        pass over the whole split in record order records which records
        featurize."""
        entries = self.splits[split]
        order = range(len(entries)) if index is None else index
        chosen = [entries[i] for i in order]
        kept = []
        for i, entry, made in zip(order, chosen, made_ahead(self._featurize, chosen)):
            try:
                g = made.result()
            except (KeyError, ValueError):
                continue
            kept.append(i)
            yield entry.get("name") or entry.get("id") or "", g
        if index is None:
            self._featurized[split] = kept

    def _graphs(self, split: str, index: Optional[List[int]] = None) -> Iterator[GraphData]:
        return (g for _, g in self.named_graphs(split, index))

    def bucket(self) -> Bucket:
        """The padded shape of every batch: under a unit budget
        (``max_units > 0``) the JAX module's ``make_bucket`` with ``top_k``
        as the mean degree, else ``max_nodes_per_batch`` nodes, that many
        times ``top_k`` edge rows; ``batch_size`` graphs.  The CSR layout
        needs no alignment slack in either mode."""
        if self.max_units > 0:
            return make_bucket(self.max_units, self.unit, self.batch_size, avg_degree=self.top_k)
        n = self.max_nodes_per_batch
        return Bucket(num_nodes=n, num_edges=n * self.top_k, num_graphs=self.batch_size)

    def batches(self, split: str, shuffle: bool = False, seed: int = 0) -> Iterator[GraphBatch]:
        """The split's batches; shuffled, in the order of
        ``np.random.default_rng(seed).shuffle`` of the records that
        featurize, as the JAX module shuffles its featurized graphs (the
        split's first pass learns which)."""
        index = None
        if shuffle:
            if split not in self._featurized:
                for _ in self.named_graphs(split):
                    pass
            kept = np.asarray(self._featurized[split], dtype=np.int64)
            index = kept[shuffled_order(len(kept), seed)].tolist()
        return batches_from_dataset(self._graphs(split, index), self.bucket(), shards=self.shards, drop_last=shuffle)

    def train_batches(self, seed: int = 0) -> Iterator[GraphBatch]:
        return self.batches("train", shuffle=True, seed=seed)

    def val_batches(self) -> Iterator[GraphBatch]:
        return self.batches("valid")

    def test_batches(self) -> Iterator[GraphBatch]:
        return self.batches("test")
