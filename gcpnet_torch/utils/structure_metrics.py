"""Native lDDT over matched atom sets.

The port's ``lddt`` of ``gcpnet_tpu/utils/structure_metrics.py:56-98``
(Mariani et al. 2013: inclusion radius 15 A in the native, thresholds 0.5,
1, 2 and 4 A, pairs within one residue left out), and the native
matched-atom path of ``generate_lddt_score``
(``gcpnet_tpu/utils/external_tools.py:106-129``).  The JAX function builds
four ``[N, N]`` arrays, about 340 MB each at 6,500 atoms; here the pairs
come from a ``scipy.spatial.cKDTree`` pair list, and the same numbers
follow: each pair's distances are computed as the JAX function computes
them (in the inputs' dtype) and kept where the native distance is
strictly under the radius, as its mask ``dn < inclusion_radius`` keeps
them; the scores are sums of quarters, exact in any order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gcpnet_torch.data.pdb import parse_pdb

LDDT_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
# the pair list's radius beyond the inclusion radius: the exact test is
# made on the distances computed as the JAX function computes them
_PAIR_SLACK = 1e-3


def lddt(
    pred: np.ndarray,
    native: np.ndarray,
    residue_index: Optional[np.ndarray] = None,
    inclusion_radius: float = 15.0,
    per_residue: bool = False,
):
    """lDDT of ``pred`` against ``native`` (``[N, 3]`` matched atoms; no
    superposition).  ``residue_index`` ``[N]`` (default: one atom a
    residue) leaves out pairs within a residue.  ``per_residue``: the
    score of each residue's atoms' pairs ``[R]`` (0 where it has none)."""
    from scipy.spatial import cKDTree

    n = pred.shape[0]
    if residue_index is None:
        residue_index = np.arange(n)
    residue_index = np.asarray(residue_index)
    if n:
        pairs = cKDTree(np.asarray(native, dtype=np.float64)).query_pairs(
            inclusion_radius + _PAIR_SLACK, output_type="ndarray"
        )
    else:
        pairs = np.zeros((0, 2), np.int64)
    i, j = pairs[:, 0], pairs[:, 1]
    dn = np.linalg.norm(native[i] - native[j], axis=-1)
    dp = np.linalg.norm(pred[i] - pred[j], axis=-1)
    keep = (dn < inclusion_radius) & (residue_index[i] != residue_index[j])
    i, j = i[keep], j[keep]
    delta = np.abs(dn[keep] - dp[keep])
    preserved = sum((delta < t).astype(np.float64) for t in LDDT_THRESHOLDS) / len(LDDT_THRESHOLDS)
    if per_residue:
        num_res = int(residue_index.max()) + 1 if n else 0
        rows = np.concatenate([residue_index[i], residue_index[j]])  # each pair counts from both ends
        total = np.bincount(rows, minlength=num_res)
        score = np.bincount(rows, weights=np.concatenate([preserved, preserved]), minlength=num_res)
        out = np.zeros(num_res)
        has = total > 0
        out[has] = score[has] / total[has]
        return out
    total = 2 * preserved.shape[0]
    return float(2 * preserved.sum() / total) if total else 0.0


def matched_lddt(pred_pdb: str, native_pdb: str, per_residue: bool = False):
    """lDDT of a decoy against its native over the heavy atoms both have,
    matched by (chain, residue number, insertion code, atom name), residues
    numbered in the native's order (the native path of the JAX
    ``generate_lddt_score``)."""
    pred = parse_pdb(pred_pdb, heavy_only=True)
    native = parse_pdb(native_pdb, heavy_only=True)
    pred_coords, native_coords = pred.coords, native.coords
    pred_map = {(a.chain, a.resseq, a.icode, a.name): i for i, a in enumerate(pred.atoms)}
    pc, nc, res = [], [], []
    res_ids = {}
    for i, a in enumerate(native.atoms):
        key = (a.chain, a.resseq, a.icode, a.name)
        if key in pred_map:
            pc.append(pred_coords[pred_map[key]])
            nc.append(native_coords[i])
            res.append(res_ids.setdefault((a.chain, a.resseq, a.icode), len(res_ids)))
    return lddt(np.asarray(pc), np.asarray(nc), residue_index=np.asarray(res), per_residue=per_residue)
