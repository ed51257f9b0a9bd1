"""The AR data path: AF2 decoy and native PDB pairs into all-atom
refinement graphs, and the windowed refinement writer.

Port of ``gcpnet_tpu/data/ar.py``:

- node scalars ``[residue one-hot (21) ‖ atom-name one-hot (37) ‖ ESM-2
  (1280)]`` = 1,338, chain orientations as node vectors;
- per-residue local frames from N/CA/C with a virtual Cb; each edge
  carries 13 invariant pair features (the frame-projected displacement p
  and the frame-alignment rows q/k/t, and a covalent-bond flag) and RBF16:
  29 edge scalars, and one unit edge vector;
- hybrid connectivity (:func:`hybrid_knn_edges`): the ``k_max`` nearest
  atoms of each atom, or an atom-index separation under ``k_min``;
- training crops to 250 contiguous residues, seeded per example; inference
  splits sequences of 1,500 residues or more into 900-residue windows
  shifted by 850, the overlap trimmed from the later window;
- labels are the native atom positions matched by chain, residue and atom
  name.

As in ``data.eq``, graphs are featurized on threads a few ahead of the
packing, a split's first pass learns which decoys featurize, and each
shuffled epoch draws over those in the order of the JAX
``batches_from_dataset``, each crop seeded as the JAX module seeds it
(``seed + the decoy's index in its list``).  Uncropped graphs are cached in
``model_data_cache_dir`` as an ``.npz`` a decoy.  Batches are
receiver-sorted with CSR row splits and carry the sorted forms of the
senders and of the graph ids, so that on the card every sum of AR runs
through K1; the residues' Ca table ``ca_x`` is batch-global
(:func:`globalize_ar_residues`).

The JAX package reads ``cpp/libgraphkernels.so`` for the hybrid kNN graph
when it loads; the port keeps its own copy (a ``scipy.spatial.cKDTree``
query, exact in float32), which gives the same edge set.  The JAX module's
signal-based 120 s guard around a decoy's featurization is not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gcpnet_torch.data import esm
from gcpnet_torch.data.batching import Bucket, Shards, batches_from_dataset, made_ahead, shuffled_order
from gcpnet_torch.data.eq import EQ_ATOM_TYPES, _load_graph, _save_graph, structure_sequence
from gcpnet_torch.data.esm import embed_sequence
from gcpnet_torch.device import DeviceLike
from gcpnet_torch.data.features import normalize, orientations, rbf
from gcpnet_torch.data.pdb import Structure, parse_pdb, write_structure
from gcpnet_torch.graph import GraphBatch, GraphData
from gcpnet_torch.utils.structure_metrics import matched_lddt, matched_structure_scores

log = logging.getLogger(__name__)

TRAINING_SEQUENCE_CROP_LENGTH = 250
INFERENCE_WINDOW = 900
INFERENCE_SHIFT = 850
INFERENCE_MIN_SPLIT_LEN = 1500

AA_ORDER = "ARNDCQEGHILKMFPSTWYVX"
AA_INDEX = {a: i for i, a in enumerate(AA_ORDER)}

# single-bond covalent radii (A) of the elements of protein heavy atoms
COVALENT_RADII = {"C": 0.77, "N": 0.70, "O": 0.66, "S": 1.04, "P": 1.10, "H": 0.37}
COVALENT_TOLERANCE = 0.2

# nearest-neighbour candidates a query takes beyond k_max; a row whose
# candidates cannot prove its k_max nearest is redone over every atom
KNN_SLACK = 16


def residue_frames(n: np.ndarray, ca: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Per-residue local frames ``[R, 3, 3]`` (rows are the axes) from the
    backbone N/CA/C with a reconstructed Cb direction."""
    b = ca - n
    cvec = c - ca
    a = np.cross(b, cvec)
    cb = -0.58273431 * a + 0.56802827 * b + -0.54067466 * cvec
    z = normalize(cb)
    x = normalize(np.cross(ca - n, z))
    y = normalize(np.cross(z, x))
    return np.stack([x, y, z], axis=1)


def _per_residue_backbone(s: Structure):
    """``(n, ca, c)``, each ``[R, 3]``; a residue without N or C takes its
    Ca there (zeros without a Ca), so that its frame stays finite."""
    res_idx = s.residue_index()
    num_res = int(res_idx.max()) + 1 if len(s.atoms) else 0
    out = {name: np.zeros((num_res, 3), np.float32) for name in ("N", "CA", "C")}
    seen = {name: np.zeros(num_res, bool) for name in out}
    coords = s.coords
    for i, atom in enumerate(s.atoms):
        if atom.name in seen and not seen[atom.name][res_idx[i]]:
            out[atom.name][res_idx[i]] = coords[i]
            seen[atom.name][res_idx[i]] = True
    for name in ("N", "C"):
        out[name][~seen[name]] = out["CA"][~seen[name]]
    return out["N"], out["CA"], out["C"]


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a b + c`` rounded once (a float32 product is exact in
    float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _sq_dists(x: np.ndarray, i, j) -> np.ndarray:
    """Float32 squared distances from atoms ``i`` to atoms ``j``
    (broadcast) as ``cpp/graph_kernels.cpp`` computes them when its
    compiler contracts ``dx dx + dy dy + dz dz`` into fused multiply-adds
    (``-O3 -march=native`` on an x86-64 with FMA): ``dz dz + (dx dx + dy
    dy)``, each of the two adds fused with its product."""
    d = x[i] - x[j]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return _fma(dz, dz, _fma(dx, dx, dy * dy))


def _nearest(x: np.ndarray, k: int) -> np.ndarray:
    """Each atom's ``k`` nearest other atoms ``[N, k]``: by float32 squared
    distance, ties to the lower index (the order of the pairs
    ``(distance, index)``).  A ``cKDTree`` query gives ``k + KNN_SLACK``
    candidates; a row whose farthest candidate is not clearly beyond its
    k-th distance is ranked over every atom."""
    from scipy.spatial import cKDTree

    n = x.shape[0]
    rows = np.arange(n)
    m = min(n, k + 1 + KNN_SLACK)
    dist64, cand = cKDTree(x.astype(np.float64)).query(x.astype(np.float64), k=m)
    cand = cand.reshape(n, m)
    d = _sq_dists(x, rows[:, None], cand)
    d[cand == rows[:, None]] = np.inf
    order = np.lexsort((cand, d), axis=-1)[:, :k]
    out = np.take_along_axis(cand, order, axis=1)
    if m < n:
        kth = np.take_along_axis(d, order[:, -1:], axis=1)[:, 0].astype(np.float64)
        far = dist64.reshape(n, m)[:, -1] ** 2
        for i in np.nonzero(~(far * (1.0 - 1e-4) > kth + 1e-6))[0]:
            others = np.delete(rows, i)
            di = _sq_dists(x, i, others)
            out[i] = others[np.lexsort((others, di))[:k]]
    return out


def hybrid_knn_edges(coords: np.ndarray, k_min: int, k_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """Edges ``i -> j`` (senders the centres ``i``) where ``j`` is one of
    the ``k_max`` nearest atoms of ``i`` or ``0 < |i - j| < k_min``, in
    ``(i, j)`` order: the edge set of ``cpp/graph_kernels.cpp``'s
    ``hybrid_knn_graph``, without its ``[N, N]`` matrix."""
    x = np.ascontiguousarray(coords, dtype=np.float32)
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    k = min(k_max, n - 1)
    parts_i, parts_j = [], []
    if k > 0:
        parts_i.append(np.repeat(np.arange(n), k))
        parts_j.append(_nearest(x, k).reshape(-1))
    for off in range(1, k_min):
        i = np.arange(n - off) if off < n else np.zeros(0, np.int64)
        parts_i += [i, i + off]
        parts_j += [i + off, i]
    key = np.unique(np.concatenate(parts_i).astype(np.int64) * n + np.concatenate(parts_j))
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def covalent_flags(coords: np.ndarray, elements: List[str], senders, receivers) -> np.ndarray:
    """1 where an edge's atoms lie within their covalent radii and the
    tolerance, else 0."""
    r = np.asarray([COVALENT_RADII.get(e, 0.77) for e in elements], dtype=np.float32)
    d = np.linalg.norm(coords[senders] - coords[receivers], axis=-1)
    cutoff = r[senders] + r[receivers] + COVALENT_TOLERANCE
    return (d <= cutoff).astype(np.float32)


def pair_frame_features(coords: np.ndarray, frames: np.ndarray, atom_res: np.ndarray, senders, receivers) -> np.ndarray:
    """12 invariant pair features an edge: ``p = F_i (x_j - x_i)`` and
    ``q/k/t = F_i`` applied to the axes of ``F_j``."""
    f_i = frames[atom_res[senders]]
    f_j = frames[atom_res[receivers]]
    disp = coords[receivers] - coords[senders]
    p = np.einsum("eab,eb->ea", f_i, disp)
    q = np.einsum("eab,eb->ea", f_i, f_j[:, 0])
    k = np.einsum("eab,eb->ea", f_i, f_j[:, 1])
    t = np.einsum("eab,eb->ea", f_i, f_j[:, 2])
    return np.concatenate([p, q, k, t], axis=-1).astype(np.float32)


def _match_native_positions(decoy: Structure, native: Structure):
    """The native's positions in the decoy's atom order, matched by
    ``(chain, resseq, icode, name)``; an unmatched atom keeps its decoy
    position.  Returns ``(positions, matched)``."""
    native_map = {(a.chain, a.resseq, a.icode, a.name): i for i, a in enumerate(native.atoms)}
    coords = decoy.coords.copy()
    ncoords = native.coords
    matched = np.zeros(len(decoy.atoms), dtype=bool)
    for i, a in enumerate(decoy.atoms):
        j = native_map.get((a.chain, a.resseq, a.icode, a.name))
        if j is not None:
            coords[i] = ncoords[j]
            matched[i] = True
    return coords, matched


def decoy_structure(
    decoy_path: str, residue_range: Optional[Tuple[int, int]] = None, backbone_only: bool = False
) -> Structure:
    """The decoy's heavy atoms (only N, CA and C with ``backbone_only``),
    cut to its residues ``[lo, hi)`` with ``residue_range``."""
    s = parse_pdb(decoy_path, heavy_only=True)
    if not s.atoms:
        raise ValueError(f"no atoms parsed from {decoy_path}")
    if backbone_only:
        s = Structure([a for a in s.atoms if a.name in ("N", "CA", "C")])
    if residue_range is not None:
        lo, hi = residue_range
        res_idx = s.residue_index()
        keep = (res_idx >= lo) & (res_idx < hi)
        s = Structure([a for a, k in zip(s.atoms, keep) if k])
    return s


def featurize_refinement_pair(
    decoy_path: str,
    native_path: Optional[str],
    esm_cache_dir: Optional[str] = None,
    k_min: int = 12,
    k_max: int = 128,
    rbf_edge_dist_cutoff: float = 4.5,
    num_rbf: int = 16,
    residue_range: Optional[Tuple[int, int]] = None,
    subset_to_backbone_atoms_only: bool = False,
    esm_device: DeviceLike = None,
) -> GraphData:
    """One decoy (its residues ``[lo, hi)`` with ``residue_range``) as a
    graph; the labels are the native's positions (the decoy's without a
    native).  An ESM-2 checkpoint runs on ``esm_device`` (``data.esm``)."""
    s = decoy_structure(decoy_path, residue_range, subset_to_backbone_atoms_only)
    res_idx = s.residue_index()
    coords = s.coords
    num_res = int(res_idx.max()) + 1
    seq = structure_sequence(s)
    res_onehot = np.zeros((num_res, len(AA_ORDER)), np.float32)
    for r, aa in enumerate(seq):
        res_onehot[r, AA_INDEX.get(aa, AA_INDEX["X"])] = 1.0
    atom_onehot = np.zeros((len(s.atoms), len(EQ_ATOM_TYPES)), np.float32)
    for i, a in enumerate(s.atoms):
        if a.name in EQ_ATOM_TYPES:
            atom_onehot[i, EQ_ATOM_TYPES.index(a.name)] = 1.0
    esm_res = embed_sequence(seq, cache_dir=esm_cache_dir, device=esm_device)
    if esm_res.shape[0] != num_res:
        esm_res = np.zeros((num_res, esm_res.shape[1]), np.float32)
    h = np.concatenate([res_onehot[res_idx], atom_onehot, esm_res[res_idx]], axis=-1).astype(np.float32)

    senders, receivers = hybrid_knn_edges(coords, k_min, k_max)
    n_bb, ca, c_bb = _per_residue_backbone(s)
    frames = residue_frames(n_bb, ca, c_bb)
    pqkt = pair_frame_features(coords, frames, res_idx, senders, receivers)
    cov = covalent_flags(coords, s.elements, senders, receivers)[:, None]
    e_vec = coords[senders] - coords[receivers]
    e_rbf = rbf(np.linalg.norm(e_vec, axis=-1), d_max=rbf_edge_dist_cutoff, d_count=num_rbf)

    label = coords
    if native_path and os.path.exists(native_path):
        label, _ = _match_native_positions(s, parse_pdb(native_path, heavy_only=True))
    return GraphData(
        h=h,
        chi=np.nan_to_num(orientations(coords)),
        e=np.nan_to_num(np.concatenate([pqkt, cov, e_rbf], axis=-1).astype(np.float32)),
        xi=np.nan_to_num(normalize(e_vec)[:, None, :].astype(np.float32)),
        x=coords,
        senders=senders,
        receivers=receivers,
        extras={
            "label": label.astype(np.float32),
            "atom_residue_idx": res_idx.astype(np.int32),
            "ca_x_local": ca.astype(np.float32),
            "num_atoms_per_residue": np.bincount(res_idx, minlength=num_res).astype(np.int32),
        },
    )


def sliding_windows(num_res: int) -> List[Tuple[int, int, int, int]]:
    """``(lo, hi, keep_lo, keep_hi)`` residue windows for inference: one
    window under INFERENCE_MIN_SPLIT_LEN residues, else windows of
    INFERENCE_WINDOW shifted by INFERENCE_SHIFT, each later one keeping its
    residues from past the overlap."""
    if num_res < INFERENCE_MIN_SPLIT_LEN:
        return [(0, num_res, 0, num_res)]
    windows = []
    start = 0
    while start < num_res:
        end = min(start + INFERENCE_WINDOW, num_res)
        keep_lo = start if start == 0 else start + (INFERENCE_WINDOW - INFERENCE_SHIFT)
        windows.append((start, end, keep_lo, end))
        if end == num_res:
            break
        start += INFERENCE_SHIFT
    return windows


class ARDataModule:
    """AR's splits (``splits_dir/train<k>.lst``, ``valid<k>.lst`` and
    ``test_ar.lst``, one decoy name a line), AF2 decoys
    (``af2_dir/<name>[.pdb]``) and natives (``true_dir/<name>[.pdb]``), the
    ESM cache ``model_data_cache_dir/esm`` (or ``esm_cache_dir``), the
    bucket of ``max_nodes_per_batch`` nodes, ``k_max + 2 k_min`` edge rows
    a node and ``batch_size`` decoys, and a Ca table of
    ``max_residues_per_batch`` residues.  ``predict_input_dir`` (with
    ``predict_true_dir`` for the scores) holds the decoys to refine.  An
    ESM-2 checkpoint (``data.esm``) runs on ``esm_device``, over the
    sequences of a pass (the epoch's crops) before it starts
    (:meth:`prepare_embeddings`); ``shards`` is this process's share of
    each global batch."""

    def __init__(
        self,
        splits_dir: str,
        af2_dir: str,
        true_dir: str,
        model_data_cache_dir: Optional[str] = None,
        split_index: int = 1,
        rbf_edge_dist_cutoff: float = 4.5,
        num_rbf: int = 16,
        k_min: int = 12,
        k_max: int = 128,
        subset_to_backbone_atoms_only: bool = False,
        batch_size: int = 1,
        max_nodes_per_batch: int = 4096,
        max_residues_per_batch: int = 600,
        predict_input_dir: Optional[str] = None,
        predict_true_dir: Optional[str] = None,
        esm_cache_dir: Optional[str] = None,
        esm_device: DeviceLike = None,
        shards: Shards = Shards(),
    ):
        self.splits_dir = splits_dir
        self.af2_dir = af2_dir
        self.true_dir = true_dir
        self.cache_dir = model_data_cache_dir
        self.split_index = split_index
        self.rbf_edge_dist_cutoff = rbf_edge_dist_cutoff
        self.num_rbf = num_rbf
        self.k_min, self.k_max = k_min, k_max
        self.backbone_only = subset_to_backbone_atoms_only
        self.batch_size = batch_size
        self.max_nodes_per_batch = max_nodes_per_batch
        self.max_residues_per_batch = max_residues_per_batch
        self.predict_input_dir = predict_input_dir
        self.predict_true_dir = predict_true_dir
        self.esm_cache_dir = esm_cache_dir or (
            os.path.join(model_data_cache_dir, "esm") if model_data_cache_dir else None
        )
        self.esm_device = esm_device
        self.shards = shards
        self.splits: Dict[str, List[str]] = {}
        self._featurized: Dict[str, List[int]] = {}
        self._embedded: set = set()
        self._predict_meta: List[dict] = []
        self._window_coords: Dict[str, List[np.ndarray]] = {}

    @classmethod
    def from_data_dir(cls, data_dir: str, **kw) -> "ARDataModule":
        """The JAX datamodule config's layout under ``data_dir``:
        ``splits/``, ``AF2_model/``, ``true_model/``,
        ``model_data_cache/``."""
        return cls(
            os.path.join(data_dir, "splits"), os.path.join(data_dir, "AF2_model"),
            os.path.join(data_dir, "true_model"), os.path.join(data_dir, "model_data_cache"), **kw,
        )

    def prepare_data(self) -> None:
        """Nothing to download: AR data ship as PDB directories."""

    def setup(self, stage: Optional[str] = None) -> None:
        mapping = {
            "train": f"train{self.split_index}.lst",
            "valid": f"valid{self.split_index}.lst",
            "test": "test_ar.lst",
            "test_casp14": "test_casp14.lst",
            "test_casp14_refinement": "test_casp14_refinement.lst",
        }
        for split, fname in mapping.items():
            path = os.path.join(self.splits_dir, fname)
            if os.path.exists(path):
                with open(path) as f:
                    self.splits[split] = [line.strip() for line in f if line.strip()]
            else:
                self.splits[split] = []
        self._featurized = {}
        self._embedded = set()
        log.info("AR splits: " + ", ".join(f"{k}={len(v)}" for k, v in self.splits.items()))

    def _paths(self, name: str) -> Tuple[str, str]:
        decoy = os.path.join(self.af2_dir, name + ".pdb")
        native = os.path.join(self.true_dir, name + ".pdb")
        if not os.path.exists(decoy):
            decoy = os.path.join(self.af2_dir, name)
        if not os.path.exists(native):
            native = os.path.join(self.true_dir, name)
        return decoy, native

    def _pair(self, decoy: str, native: Optional[str], residue_range=None) -> GraphData:
        return featurize_refinement_pair(
            decoy, native, esm_cache_dir=self.esm_cache_dir, k_min=self.k_min, k_max=self.k_max,
            rbf_edge_dist_cutoff=self.rbf_edge_dist_cutoff, num_rbf=self.num_rbf, residue_range=residue_range,
            subset_to_backbone_atoms_only=self.backbone_only, esm_device=self.esm_device,
        )

    def _graph_cache(self, name: str) -> Optional[str]:
        suffix = "_bb" if self.backbone_only else ""
        return os.path.join(self.cache_dir, f"{name}{suffix}.graph.npz") if self.cache_dir else None

    @staticmethod
    def _crop_range(decoy: str, seed: int) -> Optional[Tuple[int, int]]:
        """A training crop of TRAINING_SEQUENCE_CROP_LENGTH residues from a
        start drawn by ``np.random.default_rng(seed)``; ``None`` for a
        decoy no longer than that."""
        s = parse_pdb(decoy, heavy_only=True)
        num_res = int(s.residue_index().max()) + 1 if s.atoms else 0
        if num_res <= TRAINING_SEQUENCE_CROP_LENGTH:
            return None
        lo = int(np.random.default_rng(seed).integers(0, num_res - TRAINING_SEQUENCE_CROP_LENGTH + 1))
        return lo, lo + TRAINING_SEQUENCE_CROP_LENGTH

    def prepare_embeddings(self, pieces: Sequence[Tuple[str, Optional[Tuple[int, int]]]]) -> int:
        """Embed, here and now, the sequences of the decoys' pieces
        ``(path, residue range)`` that no ESM cache holds
        (``esm.prepare``); the number embedded.  A decoy that fails to
        parse is left to the featurizer to report."""
        if not esm.source_available():
            return 0
        seqs = []
        for path, residue_range in pieces:
            try:
                seqs.append(structure_sequence(decoy_structure(path, residue_range, self.backbone_only)))
            except (ValueError, OSError):
                continue
        return esm.prepare(seqs, self.esm_cache_dir, self.esm_device)

    def _prepare_split(self, split: str, crop: bool, seed: int) -> None:
        """Before a pass: embed the split's pieces without a cached graph
        (every epoch's own crops; the uncropped decoys once)."""
        if not esm.source_available() or (not crop and split in self._embedded):
            return
        self._embedded.add(split)
        pieces = []
        for i, name in enumerate(self.splits.get(split, [])):
            decoy, _ = self._paths(name)
            cached = self._graph_cache(name)
            try:
                if crop:
                    pieces.append((decoy, self._crop_range(decoy, seed + i)))
                elif not (cached and os.path.exists(cached)):
                    pieces.append((decoy, None))
            except (ValueError, OSError):
                continue
        self.prepare_embeddings(pieces)

    def featurize(self, name: str, crop: bool = False, seed: int = 0) -> GraphData:
        """A decoy's graph.  With ``crop`` a decoy of more than
        TRAINING_SEQUENCE_CROP_LENGTH residues is cut to that many, from a
        start drawn by ``np.random.default_rng(seed)``; uncropped graphs
        come from the cache where they were made before."""
        decoy, native = self._paths(name)
        cache_path = None if crop else self._graph_cache(name)
        if cache_path:
            os.makedirs(self.cache_dir, exist_ok=True)
            if os.path.exists(cache_path):
                return _load_graph(cache_path)
        residue_range = self._crop_range(decoy, seed) if crop else None
        g = self._pair(decoy, native, residue_range)
        if cache_path:
            _save_graph(cache_path, g)
        return g

    def _graphs(self, split: str, crop: bool, seed: int, index: Optional[Sequence[int]] = None) -> Iterator[GraphData]:
        """The split's graphs in list order (or the decoys ``index`` names,
        in its order), the crop of decoy ``i`` seeded ``seed + i``,
        featurized on threads a few ahead, skipping (and logging) a decoy
        that fails (``ValueError``, ``OSError``), as the JAX module does.
        A pass over the whole split in list order records which decoys
        featurize."""
        names = self.splits.get(split, [])
        order = range(len(names)) if index is None else index
        kept = []

        def make(i):
            return self.featurize(names[i], crop=crop, seed=seed + i)

        for i, made in zip(order, made_ahead(make, order)):
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
        return Bucket(num_nodes=n, num_edges=n * (self.k_max + 2 * self.k_min), num_graphs=self.batch_size)

    def batches(self, split: str, shuffle: bool = False, seed: int = 0) -> Iterator[GraphBatch]:
        """The split's batches (this process's shard of each); the training
        split cropped, with ``seed`` (see :meth:`_graphs`); shuffled, in the
        order of ``np.random.default_rng(seed).shuffle`` of the decoys that
        featurize (the split's first pass learns which), and then an
        incomplete last group of shards is dropped, as in the JAX module."""
        crop = split == "train"
        index = None
        if shuffle:
            if split not in self._featurized:
                for _ in self._graphs(split, crop, seed):
                    pass
            kept = np.asarray(self._featurized[split], dtype=np.int64)
            index = kept[shuffled_order(len(kept), seed)].tolist()
        for batch in batches_from_dataset(
            self._graphs(split, crop, seed, index), self.bucket(), shards=self.shards, drop_last=shuffle
        ):
            yield globalize_ar_residues(batch, self.max_residues_per_batch)

    # each embeds the pass's sequences in the caller's thread before the
    # batches' generator is handed to the fit's prefetch thread
    def train_batches(self, seed: int = 0) -> Iterator[GraphBatch]:
        self._prepare_split("train", True, seed)
        return self.batches("train", shuffle=True, seed=seed)

    def val_batches(self) -> Iterator[GraphBatch]:
        self._prepare_split("valid", False, 0)
        return self.batches("valid")

    def test_batches(self) -> Iterator[GraphBatch]:
        self._prepare_split("test", False, 0)
        return self.batches("test")

    def predict_batches(self) -> Iterator[GraphBatch]:
        """One batch a window of each decoy of ``predict_input_dir`` (its
        ``.pdb`` files in name order), each with the ``overlap_keep_mask``
        of the atoms it contributes.  A window larger than the bucket
        raises a ``ValueError`` naming the decoy, the window and the bucket
        (the JAX module's generator then has no batch to give)."""
        input_dir = self.predict_input_dir
        if not input_dir or not os.path.isdir(input_dir):
            return iter(())
        windows_of = {}
        for fname in sorted(f for f in os.listdir(input_dir) if f.endswith(".pdb")):
            s = parse_pdb(os.path.join(input_dir, fname), heavy_only=True)
            windows_of[fname] = sliding_windows(int(s.residue_index().max()) + 1 if s.atoms else 0)
        self.prepare_embeddings([
            (os.path.join(input_dir, f), (lo, hi)) for f, windows in windows_of.items() for lo, hi, _, _ in windows
        ])
        return self._predict_batches(windows_of)

    def _predict_batches(self, windows_of: Dict[str, list]) -> Iterator[GraphBatch]:
        bucket = self.bucket()
        for fname, windows in windows_of.items():
            decoy = os.path.join(self.predict_input_dir, fname)
            native = os.path.join(self.predict_true_dir, fname) if self.predict_true_dir else None
            for wi, (lo, hi, keep_lo, keep_hi) in enumerate(windows):
                g = self._pair(decoy, native, (lo, hi))
                res = g.extras["atom_residue_idx"]
                g.extras["overlap_keep_mask"] = ((res >= keep_lo - lo) & (res < keep_hi - lo)).astype(np.float32)
                if g.num_nodes > bucket.num_nodes or g.num_edges > bucket.num_edges:
                    raise ValueError(
                        f"{decoy}: window {wi} (residues {lo}-{hi}) has {g.num_nodes} atoms and {g.num_edges} "
                        f"edges, more than the bucket's {bucket.num_nodes} nodes and {bucket.num_edges} edge rows "
                        "(raise max_nodes_per_batch)"
                    )
                (batch,) = batches_from_dataset([g], bucket)
                self._predict_meta.append({"decoy": decoy, "last_window": wi == len(windows) - 1})
                yield globalize_ar_residues(batch, self.max_residues_per_batch)

    def record_predictions(self, batch: GraphBatch, preds, output_dir: str) -> List[dict]:
        """Keep a window's predicted positions (its ``overlap_keep_mask``
        atoms) and, at a decoy's last window, write the stitched refined
        PDB to ``output_dir`` and return its score row: ``decoy``,
        ``refined_pdb`` and, with a native in ``predict_true_dir``,
        TM-score, GDT-TS, GDT-HA, MaxSub, RMSD over the matched Ca atoms
        and lDDT over the matched heavy atoms.  Windows come in the order
        :meth:`predict_batches` gave them."""
        meta = self._predict_meta.pop(0)
        decoy = meta["decoy"]
        mask = np.asarray(batch.node_pad_mask, dtype=bool)
        keep = np.asarray(batch.extras["overlap_keep_mask"]).astype(bool)
        self._window_coords.setdefault(decoy, []).append(np.asarray(preds, dtype=np.float32)[mask & keep])
        if not meta["last_window"]:
            return []
        coords = np.concatenate(self._window_coords.pop(decoy), axis=0)
        s = parse_pdb(decoy, heavy_only=True)
        out_path = os.path.join(output_dir, os.path.basename(decoy))
        n = min(len(s.atoms), coords.shape[0])
        write_structure(out_path, Structure(s.atoms[:n]), coords=coords[:n])
        row = {"decoy": os.path.basename(decoy), "refined_pdb": out_path}
        native = os.path.join(self.predict_true_dir, os.path.basename(decoy)) if self.predict_true_dir else None
        if native and os.path.exists(native):
            try:
                row.update(matched_structure_scores(out_path, native))
                row["lDDT"] = float(matched_lddt(out_path, native, per_residue=False))
            except Exception as exc:  # the JAX module logs and keeps the row
                log.warning(f"scoring failed for {decoy}: {exc}")
        return [row]


def globalize_ar_residues(batch: GraphBatch, max_residues: int) -> GraphBatch:
    """Per-graph residue indices made batch-global and the graphs' Ca
    positions as one ``ca_x`` table ``[max_residues, 3]`` (zero-padded),
    the JAX ``_globalize_ar_residues`` for one shard."""
    res_idx = np.asarray(batch.extras["atom_residue_idx"])
    graph_id = np.asarray(batch.graph_id)
    real = np.asarray(batch.node_pad_mask, dtype=bool)
    ca_local = np.asarray(batch.extras["ca_x_local"])
    new_idx = np.zeros_like(res_idx)
    rows_ca = []
    offset = 0
    for g in np.unique(graph_id[real]):
        rows = real & (graph_id == g)
        n_res = int(res_idx[rows].max()) + 1
        new_idx[rows] = res_idx[rows] + offset
        rows_ca.append(ca_local[offset:offset + n_res])
        offset += n_res
    if offset > max_residues:
        raise ValueError(f"a batch holds {offset} residues > budget {max_residues} (raise max_residues_per_batch)")
    ca = np.concatenate(rows_ca) if rows_ca else np.zeros((0, 3), np.float32)
    extras = dict(batch.extras)
    extras["atom_residue_idx"] = new_idx
    extras["ca_x"] = np.pad(ca, ((0, max_residues - offset), (0, 0))).astype(np.float32)
    extras.pop("ca_x_local", None)
    return batch.replace(extras=extras)
