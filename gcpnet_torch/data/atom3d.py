"""The ATOM3D data path for LBA (ligand binding affinity) and PSR (protein
structure ranking).

Port of ``gcpnet_tpu/data/atom3d.py``: the atoms of a record become a
radius graph (r = 4.5, at most 32 neighbours) with 16 Gaussian RBF edge
scalars, unit edge vectors, 9-way atom-type node ids and chain-orientation
node vectors.

The port reads the ``.npz`` record directories that
``scripts/convert_atom3d_to_npz.py`` writes from the ATOM3D LMDB archives
(``<data_dir>/LBA/split-by-sequence-identity-<n>/data/<split>_npz`` and
``<data_dir>/PSR/split-by-year/data/<split>_npz``, one file a record:
``coords`` ``[n, 3]``, ``elements`` ``[n]``, ``label``, and ``lig_flag``
``[n]`` for LBA or ``target`` for PSR).  It has no LMDB reader and
downloads nothing.

Batches are receiver-sorted with CSR row splits (``tile=1``), so on the
card every step runs K1, K2 and K3; the JAX module's default is the dense
slot-major layout, which the port does not have yet (the math is the same).
With ``max_units > 0`` the bucket comes from that edge or node budget, as
the JAX module's does (:meth:`ATOM3DDataModule.bucket`).
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gcpnet_torch.data.batching import Bucket, Shards, batches_from_dataset, made_ahead, make_bucket, shuffled_order
from gcpnet_torch.data.features import edge_geometric_features, orientations
from gcpnet_torch.graph import GraphBatch, GraphData

log = logging.getLogger(__name__)

ATOM_TYPES = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4, "S": 5, "Cl": 6, "CL": 6, "P": 7}
NUM_ATOM_TYPES = 9  # 8 named and "other"
CONVERTER = "scripts/convert_atom3d_to_npz.py"


def element_to_type(elements) -> np.ndarray:
    """Atom-type ids: ``ATOM_TYPES``, 8 for any other element."""
    names, inverse = np.unique(np.asarray(elements).astype(str), return_inverse=True)
    return np.asarray([ATOM_TYPES.get(str(e), 8) for e in names], dtype=np.int32)[inverse.reshape(-1)]


def radius_graph(coords: np.ndarray, r: float, max_num_neighbors: int = 32):
    """``torch_cluster.radius_graph``'s edges: for each atom ``i`` its
    nearest atoms ``j`` with ``|x_i - x_j| <= r``, itself excluded, at most
    ``max_num_neighbors`` of them nearest first, as ``(senders j,
    receivers i)`` int32, receivers ascending.  The arrays of the JAX
    function's scipy path, from one ``cKDTree.query`` without its per-atom
    loop."""
    from scipy.spatial import cKDTree

    n = coords.shape[0]
    k = min(max_num_neighbors + 1, n)  # the query finds the atom itself too
    dists, idx = cKDTree(coords).query(coords, k=k, distance_upper_bound=r)
    dists, idx = dists.reshape(n, -1), idx.reshape(n, -1)
    valid = (idx != np.arange(n)[:, None]) & np.isfinite(dists) & (idx < n)
    keep = valid & (np.cumsum(valid, axis=1) <= max_num_neighbors)
    receivers, slots = np.nonzero(keep)
    return idx[receivers, slots].astype(np.int32), receivers.astype(np.int32)


def featurize_atoms(
    coords: np.ndarray, elements, edge_cutoff: float = 4.5, num_rbf: int = 16, max_neighbors: int = 32
) -> GraphData:
    """The atom graph of LBA and PSR: atom types, chain orientations, and
    the radius graph's RBF distances and unit vectors."""
    coords = np.asarray(coords, dtype=np.float32)
    senders, receivers = radius_graph(coords, edge_cutoff, max_neighbors)
    edge_s, edge_v = edge_geometric_features(coords, senders, receivers, d_max=edge_cutoff, num_rbf=num_rbf)
    return GraphData(
        h=element_to_type(elements),
        chi=np.nan_to_num(orientations(coords)),
        e=edge_s,
        xi=edge_v,
        x=coords,
        senders=senders,
        receivers=receivers,
    )


class ATOM3DDataModule:
    """LBA and PSR batches from npz records.

    As the JAX module: PSR target codes are given in the order records are
    first featurized and shared by the splits; a record that fails to
    featurize (``KeyError``, ``ValueError``) is logged and skipped; a
    shuffled split's order is ``np.random.default_rng(seed).shuffle`` of
    its graphs' indices; the last batch is kept.  Unlike it, graphs are
    featurized on threads a few ahead of the one being packed
    (:func:`~gcpnet_torch.data.batching.made_ahead`), and a shuffled epoch never holds its split's
    graphs: the JAX module featurizes the whole split into memory before
    shuffling it (about 3 MB a 1,300-atom decoy), where the port reads a
    split through once, to learn which records featurize and to give the
    target codes in record order, and from then on featurizes each
    shuffled epoch's graphs as its batches are packed (in the Trainer's
    prefetch thread).
    """

    def __init__(
        self,
        task: str = "LBA",
        data_dir: str = "data/ATOM3D",
        lba_split: int = 30,
        edge_cutoff: float = 4.5,
        max_neighbors: int = 32,
        batch_size: int = 16,
        max_nodes_per_batch: int = 16384,
        max_units: int = 0,
        unit: str = "edge",
        shards: Shards = Shards(),
    ):
        """``max_units > 0`` packs under that budget of ``unit`` (``edge``
        or ``node``) instead of ``max_nodes_per_batch`` (:meth:`bucket`);
        ``shards`` is this process's share of each global batch."""
        self.task = task.upper()
        if self.task not in ("LBA", "PSR"):
            raise ValueError(f"ATOM3DDataModule: task {task!r} is not LBA or PSR")
        self.data_dir = data_dir
        self.lba_split = lba_split
        self.edge_cutoff = edge_cutoff
        self.max_neighbors = max_neighbors
        self.batch_size = batch_size
        self.max_nodes_per_batch = max_nodes_per_batch
        self.max_units = max_units
        self.unit = unit
        self.shards = shards
        self.datasets = {}
        self._target_codes = {}
        self._featurized = {}  # split -> indices of the records that featurize

    # --- storage ----------------------------------------------------------
    def _split_dir(self, split: str) -> str:
        names = {
            "LBA": f"LBA/split-by-sequence-identity-{self.lba_split}/data",
            "PSR": "PSR/split-by-year/data",
        }
        return os.path.join(self.data_dir, names[self.task], split)

    def prepare_data(self) -> None:
        """Downloads nothing (the JAX module downloads through the atom3d
        package when it is importable); warns where the records are
        expected, as the JAX module does without that package."""
        log.warning(
            f"the port reads npz records only: expecting them under {self.data_dir} "
            f"(convert the ATOM3D LMDB splits once with {CONVERTER})"
        )

    def _load_split(self, split: str) -> List[dict]:
        """The split's records, one dict of arrays each, in file-name order."""
        path = self._split_dir(split)
        npz_dir = path + "_npz"
        if not os.path.isdir(npz_dir):
            found = f"an LMDB split at {path}, which the port does not read" if os.path.exists(path) else "nothing"
            raise RuntimeError(f"no npz records at {npz_dir} (found {found}); convert once with {CONVERTER}")
        records = []
        for fname in sorted(os.listdir(npz_dir)):
            if fname.endswith(".npz"):
                with np.load(os.path.join(npz_dir, fname), allow_pickle=True) as npz:
                    records.append(dict(npz))
        return records

    def setup(self, stage=None) -> None:
        for split in ("train", "val", "test"):
            self.datasets[split] = self._load_split(split)
        self._featurized = {}
        log.info(f"{self.task} splits: " + ", ".join(f"{k}={len(v)}" for k, v in self.datasets.items()))

    # --- featurization ----------------------------------------------------
    def _featurize(self, elem: dict) -> Tuple[GraphData, Optional[str]]:
        """A record's graph, and its PSR target (``None`` for LBA), whose
        code the caller assigns in record order."""
        if self.task == "LBA":
            return self._featurize_lba(elem), None
        return self._featurize_psr(elem)

    def _featurize_lba(self, elem: dict) -> GraphData:
        """Pocket and ligand atoms in one graph, with the ligand flag."""
        g = featurize_atoms(elem["coords"], elem["elements"], self.edge_cutoff, max_neighbors=self.max_neighbors)
        g.extras["lig_flag"] = np.asarray(elem["lig_flag"], dtype=np.int32)
        g.extras["label"] = np.float32(elem["label"])
        return g

    def _featurize_psr(self, elem: dict) -> Tuple[GraphData, str]:
        """A decoy's heavy atoms, labelled with its GDT-TS, and its target."""
        coords, elements = elem["coords"], np.asarray(elem["elements"])
        label = np.float32(elem["label"])
        target = str(elem.get("target", ""))
        heavy = elements.astype(str) != "H"
        coords = np.asarray(coords, dtype=np.float32)[heavy]
        g = featurize_atoms(coords, elements[heavy], self.edge_cutoff, max_neighbors=self.max_neighbors)
        g.extras["label"] = label
        return g, target

    # --- iteration --------------------------------------------------------
    def _graphs(self, split: str, index: Optional[Sequence[int]] = None) -> Iterator[GraphData]:
        """The split's graphs in record order (or the records ``index``
        names, in its order), skipping (and logging) a record that fails to
        featurize; PSR target codes are assigned here, in that order.  A
        pass over the whole split in record order records which records
        featurize."""
        records = self.datasets[split]
        order = range(len(records)) if index is None else index
        kept = []
        for i, made in zip(order, made_ahead(self._featurize, (records[i] for i in order))):
            try:
                g, target = made.result()
            except (KeyError, ValueError) as exc:
                log.warning(f"skipping malformed record: {exc!r}")
                continue
            if target is not None:
                g.extras["target_id"] = np.int32(self._target_codes.setdefault(target, len(self._target_codes)))
            kept.append(i)
            yield g
        if index is None:
            self._featurized[split] = kept

    def bucket(self) -> Bucket:
        """The padded shape of every batch: under a unit budget
        (``max_units > 0``, the reference's edge-budget sampler) the JAX
        module's ``make_bucket`` with the radius graph's neighbour cap as the
        mean degree, else ``max_nodes_per_batch`` nodes and that many times
        ``max_neighbors`` edge rows.  Batches take the CSR layout, which
        needs no alignment slack, in both modes (the JAX module turns its
        dense layout off under a budget)."""
        if self.max_units > 0:
            return make_bucket(self.max_units, self.unit, self.batch_size, avg_degree=self.max_neighbors)
        n = self.max_nodes_per_batch
        return Bucket(num_nodes=n, num_edges=n * self.max_neighbors, num_graphs=self.batch_size)

    def batches(self, split: str, shuffle: bool = False, seed: int = 0) -> Iterator[GraphBatch]:
        if shuffle:
            return self._shuffled_batches(split, seed)
        return batches_from_dataset(self._graphs(split), self.bucket(), ("label", "target_id"), self.shards)

    def _shuffled_batches(self, split: str, seed: int) -> Iterator[GraphBatch]:
        if split not in self._featurized:
            for _ in self._graphs(split):  # the split's first pass
                pass
        index = np.asarray(self._featurized[split])[shuffled_order(len(self._featurized[split]), seed)]
        yield from batches_from_dataset(
            self._graphs(split, index.tolist()), self.bucket(), ("label", "target_id"), self.shards, drop_last=True
        )

    def train_batches(self, seed: int = 0) -> Iterator[GraphBatch]:
        return self.batches("train", shuffle=True, seed=seed)

    def val_batches(self) -> Iterator[GraphBatch]:
        return self.batches("val")

    def test_batches(self) -> Iterator[GraphBatch]:
        return self.batches("test")
