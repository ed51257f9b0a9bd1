"""The EQ data path: decoy PDBs into all-atom structure-quality graphs.

Port of ``gcpnet_tpu/data/eq.py``:

- heavy-atom graphs with the radius graph of ``data.atom3d`` (r 4.5 A, at
  most 32 neighbours);
- node scalars ``[ESM-2 residue embedding (1280) ‖ plDDT from the
  b-factors (1)]`` and an atom-type index (``EQ_ATOM_TYPES``, 38 with the
  unknown) that the model embeds; chain orientations as node vectors;
- edge scalars ``[same chain, same residue, RBF16]`` and unit edge
  vectors;
- per-residue lDDT labels against the native, native
  (``utils.structure_metrics``) or from the lddt binary at
  ``lddt_exec_path`` (``utils.external_tools.generate_lddt_score``),
  computed once a decoy: featurized graphs are cached in
  ``model_data_cache_dir``, as the JAX module caches its graphs (an
  ``.npz`` a decoy here, where it pickles them).  The port's cache name
  also says which scorer labelled the graph (``_lddt-<digest of the
  binary's path>`` after the name; the JAX cache keeps one name for
  both), so that native labels are never read back as a binary's, nor
  the other way round.

As in ``data.atom3d`` and ``data.cath``, graphs are featurized on threads
a few ahead of the packing, a split's first pass learns which decoys
featurize, and each shuffled epoch draws over those (the JAX module
shuffles the graphs that featurized).  Batches are receiver-sorted with
CSR row splits and carry the sorted forms of the senders and of the
atoms' residue index (``residue_perm``, ``residue_inv_perm``,
``residue_splits``), so that on the card every sum of EQ runs through K1.
The prediction path (``predict_batches``, ``record_predictions``) gives
one batch a decoy of ``predict_input_dir`` and writes its b-factor-annotated
PDB and its CSV row.  ``subset_to_ca_atoms_only`` builds CA-only graphs
(one node a residue, radius 8 A, at most 128 neighbours), cached apart
(``<name>_ca.graph.npz``).  ``GCPNET_EQ_DENSE=1`` lays the batches out
dense (``data.batching.densify_edges_by_receiver``: receiver budget
``max_neighbors``, sender budget twice that), off for CA-only graphs, as
the JAX module does.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from gcpnet_torch.data.atom3d import radius_graph
from gcpnet_torch.data import esm
from gcpnet_torch.data.batching import (
    Bucket, Shards, batches_from_dataset, layout_switch, made_ahead, shuffled_order, sorted_index,
)
from gcpnet_torch.data.esm import embed_sequence
from gcpnet_torch.device import DeviceLike
from gcpnet_torch.data.features import edge_geometric_features, orientations
from gcpnet_torch.data.pdb import Structure, annotate_pdb_bfactor_column, parse_pdb
from gcpnet_torch.graph import GraphBatch, GraphData
from gcpnet_torch.utils.external_tools import configured_executable, generate_lddt_score

log = logging.getLogger(__name__)

# heavy-atom name vocabulary (37 names); index 37 is the unknown
EQ_ATOM_TYPES = [
    "N", "CA", "C", "O", "CB", "OG", "CG", "CD1", "CD2", "CE1", "CE2", "CZ",
    "OD1", "ND2", "CG1", "CG2", "CD", "CE", "NZ", "OD2", "OE1", "NE2", "OE2",
    "OH", "NE", "NH1", "NH2", "OG1", "SD", "ND1", "SG", "NE1", "CE3", "CZ2",
    "CZ3", "CH2", "OXT",
]
EQ_ATOM_TYPE_INDEX = {name: i for i, name in enumerate(EQ_ATOM_TYPES)}
NUM_EQ_ATOM_TYPES = len(EQ_ATOM_TYPES) + 1

THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
}

# the per-atom arrays a batch carries for EQ beside the graph's
RESIDUE_INDEX_KEYS = ("residue_perm", "residue_inv_perm", "residue_splits")


def structure_sequence(s: Structure) -> str:
    """One letter a residue, in order of first appearance ("X" unknown)."""
    seq, seen = [], set()
    for a in s.atoms:
        rid = (a.chain, a.resseq, a.icode)
        if rid not in seen:
            seen.add(rid)
            seq.append(THREE_TO_ONE.get(a.resname, "X"))
    return "".join(seq)


def featurize_decoy(
    decoy_path: str,
    native_path: Optional[str],
    esm_cache_dir: Optional[str] = None,
    edge_cutoff: float = 4.5,
    max_neighbors: int = 32,
    rbf_edge_dist_cutoff: float = 4.5,
    num_rbf: int = 16,
    esm_device: DeviceLike = None,
    subset_to_ca_atoms_only: bool = False,
    lddt_exec_path: Optional[str] = None,
) -> GraphData:
    """One decoy (and its native, for the labels) as a graph; the labels are
    zeros without a native.  An ESM-2 checkpoint runs on ``esm_device``
    (``data.esm``).  ``subset_to_ca_atoms_only`` keeps the CA atoms alone,
    each its own residue, over a radius graph of 8 A and at most 128
    neighbours whatever the arguments say (``gcpnet_tpu/data/eq.py:103-112``).
    The labels come from the lddt binary at ``lddt_exec_path`` where one is
    configured (a missing binary, or one that prints no score, raises)."""
    s = parse_pdb(decoy_path, heavy_only=True)
    if not s.atoms:
        raise ValueError(f"no atoms parsed from {decoy_path}")
    res_idx = s.residue_index()
    num_res = int(res_idx.max()) + 1
    chain_ids = np.asarray([(ord(a.chain[0]) if a.chain else 0) % 97 for a in s.atoms], dtype=np.int32)
    coords = s.coords
    atom_types = np.asarray(
        [EQ_ATOM_TYPE_INDEX.get(a.name, len(EQ_ATOM_TYPES)) for a in s.atoms], dtype=np.int32
    )
    plddt_res = np.zeros(num_res, dtype=np.float32)
    for i, a in enumerate(s.atoms):
        plddt_res[res_idx[i]] = a.bfactor  # AlphaFold keeps plDDT in the b-factor column
    plddt_atom = plddt_res[res_idx]

    esm_res = embed_sequence(structure_sequence(s), cache_dir=esm_cache_dir, device=esm_device)
    if esm_res.shape[0] != num_res:
        esm_res = np.zeros((num_res, esm_res.shape[1]), np.float32)
    esm_atom = esm_res[res_idx]
    ca_idx = s.ca_indices()
    if subset_to_ca_atoms_only:
        coords, atom_types, chain_ids = coords[ca_idx], atom_types[ca_idx], chain_ids[ca_idx]
        plddt_atom, esm_atom = plddt_atom[ca_idx], esm_atom[ca_idx]
        res_idx = np.arange(ca_idx.shape[0], dtype=np.int32)
        ca_idx = np.arange(ca_idx.shape[0], dtype=np.int32)
        edge_cutoff, max_neighbors, rbf_edge_dist_cutoff = 8.0, 128, 8.0

    senders, receivers = radius_graph(coords, edge_cutoff, max_neighbors)
    e_rbf, e_vec = edge_geometric_features(coords, senders, receivers, d_max=rbf_edge_dist_cutoff, num_rbf=num_rbf)
    same_chain = (chain_ids[senders] == chain_ids[receivers]).astype(np.float32)[:, None]
    same_res = (res_idx[senders] == res_idx[receivers]).astype(np.float32)[:, None]
    label = np.zeros(num_res, dtype=np.float32)
    if native_path is not None and os.path.exists(native_path):
        scores = _per_residue_lddt(decoy_path, native_path, num_res, lddt_exec_path)
        if scores is not None:
            label = scores
    return GraphData(
        h=np.concatenate([esm_atom, plddt_atom[:, None]], axis=-1).astype(np.float32),
        chi=np.nan_to_num(orientations(coords)),
        e=np.concatenate([same_chain, same_res, e_rbf], axis=-1),
        xi=e_vec,
        x=coords,
        senders=senders,
        receivers=receivers,
        node_mask=np.ones(coords.shape[0], dtype=bool),
        extras={
            "atom_types": atom_types,
            "atom_residue_idx": res_idx.astype(np.int32),
            "label": label,
            "res_mask": np.ones(num_res, dtype=np.float32),
            "ca_atom_idx": ca_idx,
        },
    )


def _per_residue_lddt(
    decoy_path: str, native_path: str, num_res: int, lddt_exec_path: Optional[str] = None
) -> Optional[np.ndarray]:
    """The decoy's per-residue lDDT, cut or zero-padded to ``num_res``;
    natively ``None`` (logged) where it cannot be computed.  A configured
    binary's failure raises (the JAX module labels such a decoy with zeros
    or native scores)."""
    if lddt_exec_path:
        scores = np.asarray(generate_lddt_score(decoy_path, native_path, lddt_exec_path), dtype=np.float32)
    else:
        try:
            scores = np.asarray(generate_lddt_score(decoy_path, native_path), dtype=np.float32)
        except Exception as exc:  # the JAX module labels such a decoy with zeros
            log.warning(f"lDDT labeling failed for {decoy_path}: {exc}")
            return None
    if scores.shape[0] == num_res:
        return scores
    out = np.zeros(num_res, dtype=np.float32)
    out[: min(num_res, scores.shape[0])] = scores[:num_res]
    return out


def _save_graph(path: str, g: GraphData) -> None:
    arrays = {k: getattr(g, k) for k in ("h", "chi", "e", "xi", "x", "senders", "receivers", "node_mask")
              if getattr(g, k) is not None}
    arrays.update({f"extras.{k}": v for k, v in g.extras.items()})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load_graph(path: str) -> GraphData:
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    extras = {k[7:]: arrays.pop(k) for k in list(arrays) if k.startswith("extras.")}
    return GraphData(**arrays, extras=extras)


class EQDataModule:
    """EQ's splits (``splits_dir/{train,valid,test}.lst``, one decoy name
    a line), decoys (``decoy_dir/<name>[.pdb]``) and natives
    (``true_dir/<name>[.pdb]`` or ``<name up to its first "_">[.pdb]``),
    the ESM cache ``model_data_cache_dir/esm`` (or ``esm_cache_dir``), and
    the bucket of ``max_nodes_per_batch`` nodes, 32 times as many edge
    rows, ``batch_size`` decoys and ``max_residues_per_batch`` residues.
    An ESM-2 checkpoint (``data.esm``) runs on ``esm_device``, over each
    split's sequences before its first pass (:meth:`prepare_embeddings`);
    ``subset_to_ca_atoms_only`` featurizes CA-only graphs (and turns the
    dense layout off for them, as the JAX module does); ``lddt_exec_path``
    labels with the lddt binary; ``shards`` is this process's share of
    each global batch."""

    def __init__(
        self,
        splits_dir: str,
        decoy_dir: str,
        true_dir: str,
        model_data_cache_dir: Optional[str] = None,
        edge_cutoff: float = 4.5,
        max_neighbors: int = 32,
        rbf_edge_dist_cutoff: float = 4.5,
        num_rbf: int = 16,
        batch_size: int = 1,
        max_nodes_per_batch: int = 8192,
        max_residues_per_batch: int = 1100,
        esm_cache_dir: Optional[str] = None,
        predict_input_dir: Optional[str] = None,
        predict_true_dir: Optional[str] = None,
        esm_device: DeviceLike = None,
        subset_to_ca_atoms_only: bool = False,
        lddt_exec_path: Optional[str] = None,
        shards: Shards = Shards(),
    ):
        self.splits_dir = splits_dir
        self.decoy_dir = decoy_dir
        self.true_dir = true_dir
        self.cache_dir = model_data_cache_dir
        self.edge_cutoff = edge_cutoff
        self.max_neighbors = max_neighbors
        self.rbf_edge_dist_cutoff = rbf_edge_dist_cutoff
        self.num_rbf = num_rbf
        self.batch_size = batch_size
        self.max_nodes_per_batch = max_nodes_per_batch
        self.max_residues_per_batch = max_residues_per_batch
        self.esm_cache_dir = esm_cache_dir or (
            os.path.join(model_data_cache_dir, "esm") if model_data_cache_dir else None
        )
        self.predict_input_dir = predict_input_dir
        self.predict_true_dir = predict_true_dir
        self.esm_device = esm_device
        self.subset_to_ca = subset_to_ca_atoms_only
        self.lddt_exec_path = lddt_exec_path
        configured_executable(lddt_exec_path, "lddt_exec_path")
        self.shards = shards
        self.splits: Dict[str, List[str]] = {}
        self._featurized: Dict[str, List[int]] = {}
        self._embedded: set = set()
        self.predict_paths: List[str] = []

    @classmethod
    def from_data_dir(cls, data_dir: str, **kw) -> "EQDataModule":
        """The JAX datamodule config's layout under ``data_dir``:
        ``splits/``, ``decoy_model/``, ``true_model/``,
        ``model_data_cache/``."""
        return cls(
            os.path.join(data_dir, "splits"), os.path.join(data_dir, "decoy_model"),
            os.path.join(data_dir, "true_model"), os.path.join(data_dir, "model_data_cache"), **kw,
        )

    def prepare_data(self) -> None:
        """Nothing to download: EQ data ship as PDB directories."""

    def setup(self, stage: Optional[str] = None) -> None:
        for split in ("train", "valid", "test"):
            path = os.path.join(self.splits_dir, f"{split}.lst")
            if os.path.exists(path):
                with open(path) as f:
                    self.splits[split] = [line.strip() for line in f if line.strip()]
            else:
                self.splits[split] = []
        self._featurized = {}
        self._embedded = set()
        log.info("EQ splits: " + ", ".join(f"{k}={len(v)}" for k, v in self.splits.items()))

    def _decoy_path(self, name: str) -> str:
        for cand in (name, name + ".pdb"):
            path = os.path.join(self.decoy_dir, cand)
            if os.path.exists(path):
                return path
        return os.path.join(self.decoy_dir, name)

    def _native_path(self, name: str) -> Optional[str]:
        base = name.split("_")[0]
        for cand in (name, name + ".pdb", base, base + ".pdb"):
            path = os.path.join(self.true_dir, cand)
            if os.path.exists(path):
                return path
        return None

    def _graph_cache(self, name: str) -> Optional[str]:
        """``<name>[_ca][_lddt-<digest>].graph.npz``: the digest is of the
        lddt binary's absolute path, where one labels the graphs."""
        suffix = "_ca" if self.subset_to_ca else ""
        if self.lddt_exec_path:
            full = os.path.abspath(os.path.expanduser(self.lddt_exec_path))
            suffix += "_lddt-" + hashlib.sha1(full.encode()).hexdigest()[:12]
        return os.path.join(self.cache_dir, f"{name}{suffix}.graph.npz") if self.cache_dir else None

    def dense_budgets(self):
        """``(dense_degree, dense_out_degree)`` of the batches: ``(None,
        None)`` (the receiver-sorted layout) unless ``GCPNET_EQ_DENSE`` is
        ``1`` or ``true`` and the graphs are not CA-only, then the
        featurizer's in-degree cap and twice it (the JAX
        ``_dense_budgets``)."""
        if self.subset_to_ca or not layout_switch("GCPNET_EQ_DENSE"):
            return None, None
        return self.max_neighbors, 2 * self.max_neighbors

    def prepare_embeddings(self, paths: Sequence[str]) -> int:
        """Embed, here and now, the sequences of the decoys ``paths`` that
        no ESM cache holds (``esm.prepare``); the number embedded.  A decoy
        that fails to parse is left to the featurizer to report."""
        if not esm.source_available():
            return 0
        seqs = []
        for path in paths:
            try:
                seqs.append(structure_sequence(parse_pdb(path, heavy_only=True)))
            except (ValueError, OSError):
                continue
        return esm.prepare(seqs, self.esm_cache_dir, self.esm_device)

    def _prepare_split(self, split: str) -> None:
        """Before a split's first pass: embed its decoys without a cached graph."""
        if split in self._embedded:
            return
        self._embedded.add(split)
        names = self.splits.get(split, [])
        cached = self._graph_cache
        self.prepare_embeddings([
            self._decoy_path(n) for n in names if not (cached(n) and os.path.exists(cached(n)))
        ])

    def featurize(self, name: str) -> GraphData:
        """A decoy's graph, from the cache where it was made before."""
        cache_path = self._graph_cache(name)
        if cache_path:
            os.makedirs(self.cache_dir, exist_ok=True)
            if os.path.exists(cache_path):
                return _load_graph(cache_path)
        g = featurize_decoy(
            self._decoy_path(name), self._native_path(name), esm_cache_dir=self.esm_cache_dir,
            edge_cutoff=self.edge_cutoff, max_neighbors=self.max_neighbors,
            rbf_edge_dist_cutoff=self.rbf_edge_dist_cutoff, num_rbf=self.num_rbf, esm_device=self.esm_device,
            subset_to_ca_atoms_only=self.subset_to_ca, lddt_exec_path=self.lddt_exec_path,
        )
        if cache_path:
            _save_graph(cache_path, g)
        return g

    def _graphs(self, split: str, index: Optional[Sequence[int]] = None) -> Iterator[GraphData]:
        """The split's graphs in list order (or the decoys ``index`` names,
        in its order), featurized on threads a few ahead, skipping (and
        logging) a decoy that fails to featurize (``ValueError``,
        ``OSError``), as the JAX module does.  A pass over the whole split
        in list order records which decoys featurize."""
        names = self.splits.get(split, [])
        order = range(len(names)) if index is None else index
        kept = []
        for i, made in zip(order, made_ahead(self.featurize, (names[i] for i in order))):
            try:
                g = made.result()
            except (ValueError, OSError) as exc:
                log.warning(f"skipping {names[i]}: {exc}")
                continue
            kept.append(i)
            yield g
        if index is None:
            self._featurized[split] = kept

    def bucket(self) -> Bucket:
        n = self.max_nodes_per_batch
        return Bucket(num_nodes=n, num_edges=n * self.max_neighbors, num_graphs=self.batch_size)

    def batches(self, split: str, shuffle: bool = False, seed: int = 0) -> Iterator[GraphBatch]:
        """The split's batches (this process's shard of each); shuffled, in
        the order of ``np.random.default_rng(seed).shuffle`` of the decoys
        that featurize (the split's first pass learns which), and then an
        incomplete last group of shards is dropped, as in the JAX module.
        Call :meth:`_prepare_split` first where a checkpoint embeds."""
        index = None
        if shuffle:
            if split not in self._featurized:
                for _ in self._graphs(split):
                    pass
            kept = np.asarray(self._featurized[split], dtype=np.int64)
            index = kept[shuffled_order(len(kept), seed)].tolist()
        degree, out_degree = self.dense_budgets()
        for batch in batches_from_dataset(
            self._graphs(split, index), self.bucket(), shards=self.shards, drop_last=shuffle,
            dense_degree=degree, dense_out_degree=out_degree,
        ):
            yield globalize_residues(batch, self.max_residues_per_batch)

    # each embeds a split's sequences in the caller's thread before the
    # batches' generator is handed to the fit's prefetch thread
    def train_batches(self, seed: int = 0) -> Iterator[GraphBatch]:
        self._prepare_split("train")
        return self.batches("train", shuffle=True, seed=seed)

    def val_batches(self) -> Iterator[GraphBatch]:
        self._prepare_split("valid")
        return self.batches("valid")

    def test_batches(self) -> Iterator[GraphBatch]:
        self._prepare_split("test")
        return self.batches("test")

    # --- prediction -------------------------------------------------------
    def predict_batches(self) -> Iterator[GraphBatch]:
        """One batch a decoy of ``predict_input_dir`` (its ``.pdb`` files in
        name order), labelled against the native of the same name in
        ``predict_true_dir`` where there is one; each decoy's path is queued
        for :meth:`record_predictions`.  The decoys' sequences are embedded
        at the call."""
        if not self.predict_input_dir or not os.path.isdir(self.predict_input_dir):
            return iter(())
        names = sorted(f for f in os.listdir(self.predict_input_dir) if f.endswith(".pdb"))
        self.prepare_embeddings([os.path.join(self.predict_input_dir, n) for n in names])
        return self._predict_batches(names)

    def _predict_batches(self, names: List[str]) -> Iterator[GraphBatch]:
        for name in names:
            decoy = os.path.join(self.predict_input_dir, name)
            native = os.path.join(self.predict_true_dir, name) if self.predict_true_dir else None
            g = featurize_decoy(
                decoy, native if native and os.path.exists(native) else None, esm_cache_dir=self.esm_cache_dir,
                edge_cutoff=self.edge_cutoff, max_neighbors=self.max_neighbors,
                rbf_edge_dist_cutoff=self.rbf_edge_dist_cutoff, num_rbf=self.num_rbf, esm_device=self.esm_device,
                subset_to_ca_atoms_only=self.subset_to_ca, lddt_exec_path=self.lddt_exec_path,
            )
            degree, out_degree = self.dense_budgets()
            (batch,) = batches_from_dataset([g], self.bucket(), dense_degree=degree, dense_out_degree=out_degree)
            self.predict_paths.append(decoy)
            yield globalize_residues(batch, self.max_residues_per_batch)

    def record_predictions(self, batch: GraphBatch, preds, output_dir: str, decoy: Optional[str] = None) -> List[dict]:
        """Write the decoy's PDB to ``output_dir`` with each residue's
        predicted lDDT in its b-factor column, and return its CSV row:
        ``decoy``, ``global_plddt_pred`` (the mean over its residues),
        ``global_lddt_true`` (the labels' mean) and ``annotated_pdb``.
        ``decoy`` defaults to the oldest one :meth:`predict_batches` queued."""
        if decoy is None and self.predict_paths:
            decoy = self.predict_paths.pop(0)
        if not decoy:
            return []
        res_mask = np.asarray(batch.extras["res_mask"]).astype(bool)
        preds = np.asarray(preds)[res_mask]
        rid_order, seen = [], set()
        for a in parse_pdb(decoy, heavy_only=True).atoms:
            rid = (a.chain, a.resseq, a.icode)
            if rid not in seen:
                seen.add(rid)
                rid_order.append(rid)
        values = {rid: float(preds[i]) for i, rid in enumerate(rid_order) if i < preds.shape[0]}
        out_path = os.path.join(output_dir, os.path.basename(decoy))
        annotate_pdb_bfactor_column(decoy, out_path, values)
        labels = np.asarray(batch.extras["label"])[res_mask]
        return [{
            "decoy": os.path.basename(decoy),
            "global_plddt_pred": float(preds.mean()),
            "global_lddt_true": float(labels.mean()),
            "annotated_pdb": out_path,
        }]


def globalize_residues(batch: GraphBatch, max_residues: int) -> GraphBatch:
    """Per-graph residue indices made batch-global, the per-residue
    ``label`` and ``res_mask`` padded to ``max_residues`` (the JAX
    ``_globalize_residues`` for one shard), and the residue index's sorted
    form over the real atoms (``RESIDUE_INDEX_KEYS``)."""
    res_idx = np.asarray(batch.extras["atom_residue_idx"])
    graph_id = np.asarray(batch.graph_id)
    real = np.asarray(batch.node_pad_mask)
    labels = np.asarray(batch.extras["label"])
    res_masks = np.asarray(batch.extras["res_mask"])
    new_idx = np.zeros_like(res_idx)
    out_labels, out_masks = [], []
    offset = 0
    for g in np.unique(graph_id[real]):
        rows = real & (graph_id == g)
        local = res_idx[rows]
        n_res = int(local.max()) + 1
        new_idx[rows] = local + offset
        out_labels.append(labels[offset:offset + n_res])
        out_masks.append(res_masks[offset:offset + n_res])
        offset += n_res
    if offset > max_residues:
        raise ValueError(f"a batch holds {offset} residues > budget {max_residues} (raise max_residues_per_batch)")
    lab = np.concatenate(out_labels) if out_labels else np.zeros(0, np.float32)
    msk = np.concatenate(out_masks) if out_masks else np.zeros(0, np.float32)
    perm, inv, splits = sorted_index(new_idx, real, max_residues)
    extras = dict(batch.extras)
    extras.update(
        atom_residue_idx=new_idx,
        label=np.pad(lab, (0, max_residues - offset)).astype(np.float32),
        res_mask=np.pad(msk, (0, max_residues - offset)).astype(np.float32),
        residue_perm=perm, residue_inv_perm=inv, residue_splits=splits,
    )
    return batch.replace(extras=extras)
