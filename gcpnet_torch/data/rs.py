"""RS datamodule: R/S enantiomer chirality classification.

Port of ``gcpnet_tpu/data/rs.py``: covalent-bond graphs with 52 node
scalars (atom, degree, charge, hydrogen and hybridization one-hots,
aromaticity, mass, global and local chiral tags), 30 edge scalars (14 bond
features + RBF16 of the bond length), two orientation vectors a node and
the unit bond vector an edge.  ``stereo_mask`` zeroes the chiral-tag
columns (``h[:, -9:]``) and the bond-stereo columns, so the model must
infer chirality from geometry.  Training batches pair each anchor with
``num_neg`` conformers of each opposite stereoisomer
(:class:`SingleConformerBatchSampler`).

The reference's pickled splits need RDKit to build (``mol_to_record`` is
not ported); where no split file is given, or the file is absent, the
synthetic tetrahedral-stereocenter task (:func:`synthetic_chiral_molecule`)
with the same feature schema takes its place, as in the JAX module.  One
difference: a split file that is there but cannot be read, or a row that
cannot be featurized, raises here, where the JAX module warns and trains
on synthetic data (or skips the row).

Every batch is receiver-sorted with CSR row splits
(``batching.batches_from_dataset``), where the JAX module's default is the
unsorted layout; the graphs in a batch and their features are the same.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.data.features import normalize, orientations, rbf
from gcpnet_torch.graph import GraphBatch, GraphData

ATOM_TYPES_RS = ["H", "B", "C", "N", "O", "F", "Si", "P", "S", "Cl", "Br", "I"]
DEGREES = [0, 1, 2, 3, 4, 5, 6]
FORMAL_CHARGES = [-2, -1, 0, 1, 2]
NUM_HS = [0, 1, 2, 3, 4]
HYBRIDIZATIONS = ["S", "SP", "SP2", "SP3", "SP3D", "SP3D2", "UNSPECIFIED"]
BOND_TYPES = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"]

NODE_FEATURE_DIM = 52
EDGE_FEATURE_DIM = 14


def _one_hot(value, options) -> List[float]:
    """One-hot over ``options`` plus a last slot for anything else."""
    out = [0.0] * (len(options) + 1)
    idx = options.index(value) if value in options else -1
    out[idx] = 1.0
    return out


def record_to_graph(
    record: dict, d_max: float = 4.5, num_rbf: int = 16, stereo_mask: bool = True, label: Optional[float] = None
) -> GraphData:
    """Featurize a molecule record (``coords``, ``atoms``, ``bonds``; the
    plain dicts the JAX package's ``mol_to_record`` extracts from an RDKit
    conformer).  Each bond gives two edges, ``(i, j)`` then ``(j, i)``, in
    order of ``(min, max)`` atom index."""
    x = np.asarray(record["coords"], dtype=np.float32)
    bonds = sorted((min(b["i"], b["j"]), max(b["i"], b["j"]), b) for b in record["bonds"])
    senders_l, receivers_l, edge_feats = [], [], []
    for i, j, b in bonds:
        f = _one_hot(b["type"], BOND_TYPES)
        f += [float(b["conjugated"]), float(b["in_ring"])]
        f += _one_hot(int(b["stereo"]), list(range(6)))
        senders_l += [i, j]
        receivers_l += [j, i]
        edge_feats += [f, f]
    senders = np.asarray(senders_l, dtype=np.int32)
    receivers = np.asarray(receivers_l, dtype=np.int32)
    bond_feats = np.asarray(edge_feats, dtype=np.float32).reshape(-1, EDGE_FEATURE_DIM)

    node_feats = []
    for atom in record["atoms"]:
        f = _one_hot(atom["symbol"], ATOM_TYPES_RS)
        f += _one_hot(atom["degree"], DEGREES)
        f += _one_hot(atom["charge"], FORMAL_CHARGES)
        f += _one_hot(atom["num_hs"], NUM_HS)
        f += _one_hot(atom["hybridization"], HYBRIDIZATIONS)
        f += [float(atom["aromatic"]), atom["mass"] * 0.01]
        tag = atom["global_tag"]
        gtag = 1 if tag == "R" else 2 if tag == "S" else -1 if tag else 0
        f += _one_hot(gtag, [0, 1, 2])
        f += _one_hot(int(atom["chiral_tag"]), [0, 1, 2, 3])
        node_feats.append(f)
    h = np.asarray(node_feats, dtype=np.float32)
    return _assemble_rs_graph(x, h, bond_feats, senders, receivers, d_max, num_rbf, stereo_mask, label)


def _assemble_rs_graph(x, h, bond_feats, senders, receivers, d_max, num_rbf, stereo_mask, label) -> GraphData:
    """Edge scalars ``[bond features | RBF(|x_s - x_r|)]``, the stereo mask,
    node orientations and unit edge vectors."""
    e_vec = x[senders] - x[receivers]
    e_rbf = rbf(np.linalg.norm(e_vec, axis=-1), d_max=d_max, d_count=num_rbf)
    e = np.concatenate([bond_feats, e_rbf], axis=-1).astype(np.float32)
    if stereo_mask:
        h = h.copy()
        e = e.copy()
        h[:, -9:] = 0.0  # global + local chiral tag one-hots
        e[:, (-7 - num_rbf) : -num_rbf] = 0.0  # bond stereo one-hot
    chi = np.nan_to_num(orientations(x))
    xi = np.nan_to_num(normalize(e_vec)[:, None, :])
    extras = {} if label is None else {"label": np.float32(label)}
    return GraphData(
        h=np.nan_to_num(h),
        chi=chi.astype(np.float32),
        e=np.nan_to_num(e),
        xi=xi.astype(np.float32),
        x=np.nan_to_num(x),
        senders=senders,
        receivers=receivers,
        node_mask=np.isfinite(x.sum(-1)),
        extras=extras,
    )


def synthetic_chiral_molecule(rng: np.random.Generator, stereo_mask: bool = True, d_max: float = 4.5,
                              num_rbf: int = 16):
    """A tetrahedral stereocenter with four substituent chains of lengths
    1-4, each of its own element, randomly rotated, with 0.08 A of noise on
    each atom.  The R/S label is the sign of the signed volume of the three
    longest chains' first atoms seen from the centre.  Returns the
    enantiomer pair ``(graph, mirror image through x)`` with opposite labels.
    Draws from ``rng`` in the JAX function's order, so one seed gives the
    same pair in both packages."""
    dirs = np.asarray([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], dtype=np.float32) / np.sqrt(3.0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    dirs = dirs @ q.T

    coords = [np.zeros(3, np.float32)]
    types = [2]  # the centre: carbon
    bonds = []
    chain_lengths = rng.permutation([1, 2, 3, 4])
    first_atoms = []
    for ci, (dvec, clen) in enumerate(zip(dirs, chain_lengths)):
        prev = 0
        for a in range(clen):
            pos = coords[prev] + dvec * 1.5 + rng.normal(scale=0.08, size=3).astype(np.float32)
            coords.append(pos.astype(np.float32))
            types.append(int(3 + (ci % 4)))
            bonds.append((prev, len(coords) - 1))
            if a == 0:
                first_atoms.append(len(coords) - 1)
            prev = len(coords) - 1
    coords = np.stack(coords)

    pr = np.argsort(-chain_lengths)  # priority by chain length
    v = [coords[first_atoms[p]] for p in pr[:3]]
    chirality = np.sign(np.dot(np.cross(v[0], v[1]), v[2]))

    def build(c3d, label):
        n = c3d.shape[0]
        h = np.zeros((n, NODE_FEATURE_DIM), np.float32)
        for i, t in enumerate(types):
            h[i, t % 13] = 1.0  # atom-type block
            h[i, 13 + 3] = 1.0  # degree block
            h[i, 43] = 0.12  # mass
        s = np.asarray([b[0] for b in bonds] + [b[1] for b in bonds], np.int32)
        r = np.asarray([b[1] for b in bonds] + [b[0] for b in bonds], np.int32)
        bond_feats = np.zeros((s.shape[0], EDGE_FEATURE_DIM), np.float32)
        bond_feats[:, 0] = 1.0  # single bonds
        return _assemble_rs_graph(c3d.astype(np.float32), h, bond_feats, s, r, d_max, num_rbf, stereo_mask,
                                  float(label))

    label_r = 1.0 if chirality > 0 else 0.0
    mirrored = coords.copy()
    mirrored[:, 0] = -mirrored[:, 0]
    return build(coords, label_r), build(mirrored, 1.0 - label_r)


# --- enantiomer-paired samplers (the reference's rs_dataset.py:224-332) ---


class SampleMapToPositives:
    """index -> the other conformers of the same stereoisomer (equal
    ``ID``), or all of them with ``include_anchor``."""

    def __init__(self, ids: List, include_anchor: bool = False):
        by_id: dict = {}
        for i, mol_id in enumerate(ids):
            by_id.setdefault(mol_id, set()).add(i)
        self.mapping = {i: by_id[mol_id] if include_anchor else by_id[mol_id] - {i} for i, mol_id in enumerate(ids)}

    def sample(self, i, rng, N=1, without_replacement=True):
        pool = sorted(self.mapping[i])
        if not pool:
            return []
        if without_replacement:
            return [int(j) for j in rng.choice(pool, min(N, len(pool)), replace=False)]
        return [int(rng.choice(pool)) for _ in range(N)]


class SampleMapToNegatives:
    """index -> the conformers of the other stereoisomers of the same
    molecule (equal ``SMILES_nostereo``, another ``ID``), one pool for each
    such stereoisomer (for stratified sampling)."""

    def __init__(self, ids: List, smiles_nostereo: List):
        by_smiles: dict = {}
        for i, (mol_id, sm) in enumerate(zip(ids, smiles_nostereo)):
            by_smiles.setdefault(sm, {}).setdefault(mol_id, set()).add(i)
        self.mapping = {
            i: [sorted(members) for other, members in by_smiles[sm].items() if other != mol_id]
            for i, (mol_id, sm) in enumerate(zip(ids, smiles_nostereo))
        }

    def sample(self, i, rng, N=1, without_replacement=True, stratified=True):
        classes = self.mapping[i]
        if not classes:
            return []
        if stratified:
            out = []
            for pool in classes:
                if without_replacement:
                    out += [int(j) for j in rng.choice(pool, min(N, len(pool)), replace=False)]
                else:
                    out += [int(rng.choice(pool)) for _ in range(N)]
            return out
        population = [j for pool in classes for j in pool]
        if without_replacement:
            return [int(j) for j in rng.choice(population, min(N, len(population)), replace=False)]
        return [int(rng.choice(population)) for _ in range(N)]


def _grouped_batches(groups: list, batch_size: int, rng) -> Iterator[List[int]]:
    """Shuffle the groups with ``rng`` and yield the indices of each whole
    run of ``batch_size`` groups (a last partial run is dropped)."""
    rng.shuffle(groups)
    for b in range(len(groups) // batch_size):
        yield [i for grp in groups[b * batch_size : (b + 1) * batch_size] for i in grp]


class SingleConformerBatchSampler:
    """Groups of an anchor (one conformer per stereoisomer) with ``num_pos``
    more conformers of its stereoisomer and ``num_neg`` conformers of each
    opposite stereoisomer; ``batch_size`` groups a batch."""

    def __init__(self, single_conformer_indices: List[int], ids: List, smiles_nostereo: List, batch_size: int,
                 num_pos: int = 0, num_neg: int = 1, seed: int = 0, without_replacement: bool = True,
                 stratified: bool = True):
        self.anchors = list(single_conformer_indices)
        self.positive_sampler = SampleMapToPositives(ids, include_anchor=True)
        self.negative_sampler = SampleMapToNegatives(ids, smiles_nostereo)
        self.batch_size = batch_size
        self.num_pos = num_pos
        self.num_neg = num_neg
        self.seed = seed
        self.without_replacement = without_replacement
        self.stratified = stratified

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        groups = [
            [
                *self.positive_sampler.sample(i, rng, N=1 + self.num_pos,
                                              without_replacement=self.without_replacement),
                *self.negative_sampler.sample(i, rng, N=self.num_neg, without_replacement=self.without_replacement,
                                              stratified=self.stratified),
            ]
            for i in self.anchors
        ]
        return _grouped_batches(groups, self.batch_size, rng)

    def __len__(self):
        return len(self.anchors) // self.batch_size


class NegativeBatchSampler:
    """Every conformer as an anchor with ``num_neg`` conformers of each
    opposite stereoisomer; ``batch_size`` groups a batch."""

    def __init__(self, ids: List, smiles_nostereo: List, batch_size: int, num_neg: int = 1, seed: int = 0,
                 without_replacement: bool = True, stratified: bool = True):
        self.n = len(ids)
        self.negative_sampler = SampleMapToNegatives(ids, smiles_nostereo)
        self.batch_size = batch_size
        self.num_neg = num_neg
        self.seed = seed
        self.without_replacement = without_replacement
        self.stratified = stratified

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        groups = [
            [i, *self.negative_sampler.sample(i, rng, N=self.num_neg, without_replacement=self.without_replacement,
                                              stratified=self.stratified)]
            for i in range(self.n)
        ]
        return _grouped_batches(groups, self.batch_size, rng)

    def __len__(self):
        return self.n // self.batch_size


class RSDataModule:
    """The RS splits (pickled reference splits where given and present,
    else synthetic) as host :class:`GraphBatch` es.  A batch's bucket holds
    ``batch_size`` groups of ``1 + num_pos + num_neg`` graphs of up to
    ``max_nodes_per_graph`` nodes and twice as many edges each; training
    batches are paired (``iteration_mode``: ``"stereoisomers"``, one anchor
    conformer per stereoisomer, or ``"conformers"``, every conformer), the
    validation and test splits go in order.  ``synthetic_sizes`` sets the
    synthetic splits' graph counts; a split it leaves out keeps its default
    (train 4096, valid 512, test 512)."""

    SPLIT_OFFSETS = {"train": 0, "valid": 1, "test": 2}

    def __init__(
        self,
        train_data_filepath: Optional[str] = None,
        val_data_filepath: Optional[str] = None,
        test_data_filepath: Optional[str] = None,
        seed: int = 42,
        iteration_mode: str = "stereoisomers",
        stereo_mask: bool = True,
        num_pos: int = 0,
        num_neg: int = 1,
        d_max: float = 4.5,
        num_rbf: int = 16,
        batch_size: int = 64,
        synthetic_sizes: Optional[dict] = None,
        max_nodes_per_graph: int = 64,
    ):
        if iteration_mode not in ("stereoisomers", "conformers"):
            raise ValueError(f"RSDataModule: unknown iteration_mode {iteration_mode!r}")
        self.paths = {"train": train_data_filepath, "valid": val_data_filepath, "test": test_data_filepath}
        self.seed = seed
        self.iteration_mode = iteration_mode
        self.stereo_mask = stereo_mask
        self.num_pos = num_pos
        self.num_neg = num_neg
        self.d_max = d_max
        self.num_rbf = num_rbf
        self.batch_size = batch_size
        self.synthetic_sizes = {"train": 4096, "valid": 512, "test": 512, **(synthetic_sizes or {})}
        self.max_nodes_per_graph = max_nodes_per_graph
        self.graphs: dict = {}
        self.meta: dict = {}

    def prepare_data(self) -> None:
        pass

    def _load_pickle_split(self, split: str) -> bool:
        """The reference's pickled dataframe (columns ``ID``,
        ``SMILES_nostereo``, ``RS_label_binary`` and ``record``, the
        RDKit-free records of the JAX package's
        ``scripts/convert_rs_pickles.py``); False where no file is given or
        it is absent.  A file that is there but cannot be read, or a row
        without a record, raises."""
        path = self.paths.get(split)
        if not path or not os.path.exists(path):
            return False
        import pandas as pd

        df = pd.read_pickle(path)
        graphs, labels, ids, smiles = [], [], [], []
        for _, row in df.iterrows():
            record = row["record"] if "record" in row else None
            if record is None:
                raise ValueError(f"{path}: a row without a 'record' (RDKit molecules are not read by the port)")
            label = float(row["RS_label_binary"])
            graphs.append(record_to_graph(record, d_max=self.d_max, num_rbf=self.num_rbf,
                                          stereo_mask=self.stereo_mask, label=label))
            ids.append(row["ID"])
            smiles.append(row.get("SMILES_nostereo", row["ID"]))
            labels.append(label)
        self.graphs[split] = graphs
        self._set_meta(split, ids, smiles, np.asarray(labels))
        return True

    def _set_meta(self, split, ids, smiles, labels) -> None:
        seen, single_idx = set(), []
        for i, mol_id in enumerate(ids):
            if mol_id not in seen:
                seen.add(mol_id)
                single_idx.append(i)
        self.meta[split] = {"ids": ids, "smiles": smiles, "labels": labels, "single_idx": single_idx}

    def _make_synthetic_split(self, split: str) -> None:
        """``synthetic_sizes[split] // 2`` enantiomer pairs from
        ``np.random.default_rng(seed + split offset)``, as the JAX module
        makes them."""
        rng = np.random.default_rng(self.seed + self.SPLIT_OFFSETS.get(split, 3))
        graphs, labels, ids, smiles = [], [], [], []
        for p in range(self.synthetic_sizes[split] // 2):
            pair = synthetic_chiral_molecule(rng, stereo_mask=self.stereo_mask, d_max=self.d_max,
                                             num_rbf=self.num_rbf)
            for g, tag in zip(pair, "RS"):
                ids.append(f"{split}-mol{p}-{tag}")
                smiles.append(f"{split}-mol{p}")
                labels.append(float(g.extras["label"]))
                graphs.append(g)
        self.graphs[split] = graphs
        self._set_meta(split, ids, smiles, np.asarray(labels))

    def setup(self) -> None:
        for split in ("train", "valid", "test"):
            if not self._load_pickle_split(split):
                self._make_synthetic_split(split)

    def bucket(self) -> Bucket:
        """``batch_size`` counts anchors; each group adds ``num_pos``
        positives and ``num_neg`` negatives a stereoisomer."""
        group = 1 + self.num_pos + self.num_neg
        n = self.max_nodes_per_graph * self.batch_size * group
        return Bucket(num_nodes=n, num_edges=2 * n, num_graphs=self.batch_size * group)

    def sampler(self, split: str, seed: int = 0):
        """The paired batch sampler of ``split`` for the epoch ``seed``."""
        meta = self.meta[split]
        if self.iteration_mode == "conformers":
            return NegativeBatchSampler(meta["ids"], meta["smiles"], self.batch_size, num_neg=self.num_neg,
                                        seed=seed)
        return SingleConformerBatchSampler(meta["single_idx"], meta["ids"], meta["smiles"], self.batch_size,
                                           num_pos=self.num_pos, num_neg=self.num_neg, seed=seed)

    def batches(self, split: str, paired: bool = False, seed: int = 0) -> Iterator[GraphBatch]:
        graphs = self.graphs[split]
        if paired:
            ordered = (graphs[i] for batch_idx in self.sampler(split, seed) for i in batch_idx)
        else:
            ordered = iter(graphs)
        return batches_from_dataset(ordered, self.bucket(), extra_graph_keys=("label",))

    def train_batches(self, seed: int = 0) -> Iterator[GraphBatch]:
        return self.batches("train", paired=True, seed=seed)

    def val_batches(self) -> Iterator[GraphBatch]:
        return self.batches("valid")

    def test_batches(self) -> Iterator[GraphBatch]:
        return self.batches("test")
