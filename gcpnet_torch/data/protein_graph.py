"""Residue-level protein graphs for CPD (numpy, on the host).

Port of ``gcpnet_tpu/data/protein_graph.py``: a CATH backbone (N, CA, C, O
coordinates per residue) becomes a kNN graph over the CA atoms with
dihedral (6 scalars), orientation (2 vectors) and imputed C-beta (1 vector)
node features, and RBF distances with a sinusoidal sequence separation
(32 scalars) and a unit vector (1) on each edge.  Residues with
non-finite coordinates are masked: they receive no edges and are never a
neighbour.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from gcpnet_torch.data.features import normalize, orientations, rbf
from gcpnet_torch.graph import GraphData

AA_LETTER_TO_NUM = {
    "C": 4, "D": 3, "S": 15, "Q": 5, "K": 11, "I": 9, "P": 14, "T": 16,
    "F": 13, "A": 0, "G": 7, "H": 8, "E": 6, "L": 10, "R": 1, "W": 17,
    "V": 19, "N": 2, "Y": 18, "M": 12,
}
AA_NUM_TO_LETTER = {v: k for k, v in AA_LETTER_TO_NUM.items()}

DEFAULT_FEATURES_CFG = dict(
    dihedral=True, orientations=True, sidechain=True,
    relative_distance=True, relative_position=True, direction_unit=True,
)


def knn_graph(x: np.ndarray, k: int, valid: Optional[np.ndarray] = None):
    """The ``k`` nearest valid neighbours of each valid node, nearest first,
    as ``(senders = neighbour, receivers = centre)`` int32, receivers
    ascending.  Squared distances are taken in float32 as
    ``dx*dx + dy*dy + dz*dz`` and ties go to the lower index: the edges
    and their order of the JAX function's native path (``cpp/
    graph_kernels.cpp:knn_graph``), and of its numpy path wherever no two
    candidates of a node lie at the same distance."""
    n = x.shape[0]
    if valid is None:
        valid = np.ones(n, dtype=bool)
    valid = valid & np.isfinite(x).all(-1)
    pos = np.where(valid[:, None], x, 0.0).astype(np.float32)
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    d2[:, ~valid] = np.inf
    np.fill_diagonal(d2, np.inf)
    d2[~valid] = np.inf
    keep = min(k, n - 1)
    if keep <= 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    # each row's candidates: those no farther than its keep-th nearest
    # (ties included), then sorted by (distance, index) and cut to keep
    kth = np.partition(d2, keep - 1, axis=1)[:, keep - 1 : keep]
    rows, cols = np.nonzero((d2 <= kth) & np.isfinite(d2))
    order = np.lexsort((cols, d2[rows, cols], rows))
    rows, cols = rows[order], cols[order]
    starts = np.searchsorted(rows, rows, side="left")
    first = np.arange(rows.size) - starts < keep
    return cols[first].astype(np.int32), rows[first].astype(np.int32)


def dihedral_features(coords: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """The phi, psi and omega backbone dihedrals as (cos, sin): ``[R, 6]``."""
    X = coords[:, :3].reshape(-1, 3)
    U = normalize(X[1:] - X[:-1])
    u_2, u_1, u_0 = U[:-2], U[1:-1], U[2:]
    n_2 = normalize(np.cross(u_2, u_1))
    n_1 = normalize(np.cross(u_1, u_0))
    cosD = np.clip(np.sum(n_2 * n_1, -1), -1 + eps, 1 - eps)
    D = np.sign(np.sum(u_2 * n_1, -1)) * np.arccos(cosD)
    D = np.concatenate([np.zeros(1), D, np.zeros(2)]).reshape(-1, 3)
    return np.concatenate([np.cos(D), np.sin(D)], axis=1).astype(np.float32)


def positional_embeddings(senders: np.ndarray, receivers: np.ndarray, num_embeddings: int = 16) -> np.ndarray:
    """Sinusoidal embedding of each edge's sequence separation ``[E, num_embeddings]``."""
    d = (senders - receivers).astype(np.float32)
    frequency = np.exp(
        np.arange(0, num_embeddings, 2, dtype=np.float32) * -(math.log(10000.0) / num_embeddings)
    )
    angles = d[:, None] * frequency[None, :]
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def orientation_features(x_ca: np.ndarray) -> np.ndarray:
    """Forward and backward CA unit vectors per residue, ``[R, 2, 3]``."""
    return orientations(x_ca)


def sidechain_features(coords: np.ndarray) -> np.ndarray:
    """The C-beta direction imputed from N, CA and C, ``[R, 3]``."""
    n, origin, c = coords[:, 0], coords[:, 1], coords[:, 2]
    c, n = normalize(c - origin), normalize(n - origin)
    bisector = normalize(c + n)
    perp = normalize(np.cross(c, n))
    return (-bisector * math.sqrt(1 / 3) - perp * math.sqrt(2 / 3)).astype(np.float32)


def featurize_protein(
    protein: Dict[str, Any],
    features_cfg: Optional[Dict[str, bool]] = None,
    top_k: int = 30,
    num_rbf: int = 16,
    num_positional_embeddings: int = 16,
) -> GraphData:
    """One chain record ``{'seq', 'coords' [R, 4, 3], 'name'}`` -> its graph,
    with the residue ids ``extras["seq"]`` and the valid-residue
    ``node_mask``.  ``features_cfg`` switches features off (zeros)."""
    fc = dict(DEFAULT_FEATURES_CFG)
    fc.update(features_cfg or {})
    coords = np.asarray(protein["coords"], dtype=np.float32)
    seq = np.asarray([AA_LETTER_TO_NUM[a] for a in protein["seq"]], dtype=np.int32)
    mask = np.isfinite(coords.sum(axis=(1, 2)))
    safe_coords = np.where(mask[:, None, None], coords, 0.0)

    x_ca = safe_coords[:, 1]
    senders, receivers = knn_graph(x_ca, top_k, valid=mask)
    pos_emb = positional_embeddings(senders, receivers, num_positional_embeddings)
    e_vec = x_ca[senders] - x_ca[receivers]
    e_rbf = rbf(np.linalg.norm(e_vec, axis=-1), d_count=num_rbf)

    def on(name, arr):
        return arr if fc[name] else np.zeros_like(arr)

    dihedrals = on("dihedral", dihedral_features(safe_coords))
    orient = on("orientations", orientation_features(x_ca))
    side = on("sidechain", sidechain_features(safe_coords))
    e_rbf = on("relative_distance", e_rbf)
    pos_emb = on("relative_position", pos_emb)
    e_vec = on("direction_unit", e_vec)

    return GraphData(
        h=np.nan_to_num(dihedrals).astype(np.float32),
        chi=np.nan_to_num(np.concatenate([orient, side[:, None, :]], axis=1)).astype(np.float32),
        e=np.nan_to_num(np.concatenate([e_rbf, pos_emb], axis=-1)).astype(np.float32),
        xi=np.nan_to_num(normalize(e_vec)[:, None, :]).astype(np.float32),
        x=x_ca.astype(np.float32),
        senders=senders,
        receivers=receivers,
        node_mask=mask,
        extras={"seq": seq},
    )
