"""Native structure scores: lDDT over matched atom sets, and the TM-score
bundle (TM-score, GDT-TS, GDT-HA, MaxSub, RMSD) over matched Ca atoms.

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

``kabsch`` ... ``structure_scores`` are the port's copy of
``gcpnet_tpu/utils/structure_metrics.py:25-192`` (a Zhang-Skolnick style
superposition search, normalized by the native's length), and
:func:`matched_structure_scores` the native path of the JAX
``external_tools.calculate_tmscore_metrics`` (Ca atoms matched by chain,
residue number and insertion code).  The TM-score and lddt binaries are
not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gcpnet_torch.data.pdb import parse_pdb

LDDT_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
GDT_TS_THRESHOLDS = (1.0, 2.0, 4.0, 8.0)
GDT_HA_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
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


def kabsch(mobile: np.ndarray, target: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The rotation ``R`` and translation ``t`` that minimize
    ``|mobile @ R.T + t - target|``."""
    mc = mobile.mean(axis=0)
    tc = target.mean(axis=0)
    h = (mobile - mc).T @ (target - tc)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return rot, tc - rot @ mc


def superimpose(mobile: np.ndarray, target: np.ndarray) -> np.ndarray:
    rot, trans = kabsch(mobile, target)
    return mobile @ rot.T + trans


def rmsd(a: np.ndarray, b: np.ndarray, superimpose_first: bool = True) -> float:
    if superimpose_first:
        a = superimpose(a, b)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def _d0(n: int) -> float:
    return max(1.24 * np.cbrt(max(n - 15, 1)) - 1.8, 0.5)


def _superposition_pool(pred: np.ndarray, native: np.ndarray, d0: float, max_iters: int = 20):
    """Superpositions seeded from the whole chain, its halves and its
    quarters (at half-length strides), each refined on the pairs within a
    cutoff (``max(d0, 0.5)``, widened by 0.5 until 3 pairs are in) until it
    stops moving: a list of ``(rot, trans)``."""
    n = pred.shape[0]
    seeds = []
    for frag in (n, max(n // 2, 4), max(n // 4, 4)):
        for start in range(0, max(n - frag + 1, 1), max(frag // 2, 1)):
            seeds.append(slice(start, start + frag))
    pool = []
    for sl in seeds:
        if pred[sl].shape[0] < 3:
            continue
        rot, trans = kabsch(pred[sl], native[sl])
        for _ in range(max_iters):
            d = np.linalg.norm(pred @ rot.T + trans - native, axis=-1)
            cutoff = max(d0, 0.5)
            sel = d < cutoff
            while sel.sum() < 3:
                cutoff += 0.5
                sel = d < cutoff
            new_rot, new_trans = kabsch(pred[sel], native[sel])
            if np.allclose(new_rot, rot, atol=1e-7) and np.allclose(new_trans, trans, atol=1e-7):
                break
            rot, trans = new_rot, new_trans
        pool.append((rot, trans))
    return pool


def _pool_distances(pred: np.ndarray, native: np.ndarray, d0: float):
    """Each pooled superposition's per-atom distances."""
    return [np.linalg.norm(pred @ rot.T + trans - native, axis=-1) for rot, trans in _superposition_pool(pred, native, d0)]


def tm_score(pred: np.ndarray, native: np.ndarray) -> float:
    """TM-score of matched Ca sets, normalized by the native's length."""
    n = native.shape[0]
    if n < 3:
        return 0.0
    d0 = _d0(n)
    return max([float(np.mean(1.0 / (1.0 + (d / d0) ** 2))) for d in _pool_distances(pred, native, d0)] + [0.0])


def gdt(pred: np.ndarray, native: np.ndarray, thresholds) -> float:
    """The mean over ``thresholds`` of the best fraction of atoms within
    it."""
    n = native.shape[0]
    if n < 3:
        return 0.0
    dists = _pool_distances(pred, native, _d0(n))
    return float(np.mean([max([float((d < t).mean()) for d in dists] + [0.0]) for t in thresholds]))


def gdt_ts(pred: np.ndarray, native: np.ndarray) -> float:
    return gdt(pred, native, GDT_TS_THRESHOLDS)


def gdt_ha(pred: np.ndarray, native: np.ndarray) -> float:
    return gdt(pred, native, GDT_HA_THRESHOLDS)


def maxsub(pred: np.ndarray, native: np.ndarray, d: float = 3.5) -> float:
    """The largest fraction of atoms one superposition brings within
    ``d`` A."""
    if native.shape[0] < 3:
        return 0.0
    return max([float((dist < d).mean()) for dist in _pool_distances(pred, native, d)] + [0.0])


def structure_scores(pred_ca: np.ndarray, native_ca: np.ndarray) -> Dict[str, float]:
    """TM-score, GDT-TS, GDT-HA, MaxSub and RMSD of matched Ca sets."""
    return {
        "TM-score": tm_score(pred_ca, native_ca),
        "GDT-TS": gdt_ts(pred_ca, native_ca),
        "GDT-HA": gdt_ha(pred_ca, native_ca),
        "MaxSub": maxsub(pred_ca, native_ca),
        "RMSD": rmsd(pred_ca, native_ca),
    }


def matched_ca(pred, native) -> Tuple[np.ndarray, np.ndarray]:
    """The Ca positions of two structures matched by ``(chain, resseq,
    icode)``, in the native's order."""
    pred_map = {(a.chain, a.resseq, a.icode): i for i, a in enumerate(pred.atoms) if a.name == "CA"}
    pred_coords, native_coords = pred.coords, native.coords
    pc, nc = [], []
    for i, a in enumerate(native.atoms):
        key = (a.chain, a.resseq, a.icode)
        if a.name == "CA" and key in pred_map:
            pc.append(pred_coords[pred_map[key]])
            nc.append(native_coords[i])
    return np.asarray(pc), np.asarray(nc)


def matched_structure_scores(pred_pdb: str, native_pdb: str) -> Dict[str, float]:
    """:func:`structure_scores` of a model against its native over their
    matched Ca atoms (the native path of the JAX
    ``calculate_tmscore_metrics``)."""
    return structure_scores(*matched_ca(parse_pdb(pred_pdb), parse_pdb(native_pdb)))
