"""Epoch-level metrics, computed on the host in numpy.

The port's copy of ``gcpnet_tpu/train/metrics.py``: a :class:`Collector` of
masked (prediction, label) pairs per epoch, and RMSE, MAE, Pearson,
Spearman and Kendall correlations, accuracy, F1, cosine similarity and the
grouped (per-target) correlations over what it collected.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class Collector:
    """Accumulates masked (pred, label) pairs per epoch on the host."""

    def __init__(self):
        self.preds: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        self.groups: List[np.ndarray] = []

    def add(self, preds, labels, mask=None, groups=None):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        if mask is not None:
            mask = np.asarray(mask).astype(bool).reshape(-1)
            preds, labels = preds[mask], labels[mask]
            if groups is not None:
                groups = np.asarray(groups).reshape(-1)[mask]
        self.preds.append(preds)
        self.labels.append(labels)
        if groups is not None:
            self.groups.append(np.asarray(groups).reshape(-1))

    def cat(self):
        p = np.concatenate(self.preds) if self.preds else np.zeros(0)
        l = np.concatenate(self.labels) if self.labels else np.zeros(0)
        g = np.concatenate(self.groups) if self.groups else None
        return p, l, g

    def reset(self):
        self.preds, self.labels, self.groups = [], [], []


def rmse(p: np.ndarray, l: np.ndarray) -> float:
    return float(np.sqrt(np.mean((p - l) ** 2))) if p.size else float("nan")


def mae(p: np.ndarray, l: np.ndarray) -> float:
    return float(np.mean(np.abs(p - l))) if p.size else float("nan")


def pearson(p: np.ndarray, l: np.ndarray) -> float:
    if p.size < 2:
        return float("nan")
    pc = p - p.mean()
    lc = l - l.mean()
    denom = np.sqrt((pc**2).sum() * (lc**2).sum())
    return float((pc * lc).sum() / denom) if denom > 0 else float("nan")


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties handled like scipy.stats.rankdata)."""
    sorter = np.argsort(x, kind="mergesort")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(len(x))
    xs = x[sorter]
    obs = np.r_[True, xs[1:] != xs[:-1]]
    dense = obs.cumsum()[inv]
    counts = np.r_[np.nonzero(obs)[0], len(obs)]
    return 0.5 * (counts[dense] + counts[dense - 1] + 1)


def spearman(p: np.ndarray, l: np.ndarray) -> float:
    if p.size < 2:
        return float("nan")
    return pearson(_rankdata(p), _rankdata(l))


def kendall(p: np.ndarray, l: np.ndarray) -> float:
    """Kendall tau-b (O(n^2); used on small per-target test groups)."""
    n = p.size
    if n < 2:
        return float("nan")
    dp = np.sign(p[:, None] - p[None, :])
    dl = np.sign(l[:, None] - l[None, :])
    iu = np.triu_indices(n, 1)
    s = float((dp[iu] * dl[iu]).sum())
    t_p = float((dp[iu] == 0).sum())
    t_l = float((dl[iu] == 0).sum())
    n0 = n * (n - 1) / 2
    denom = np.sqrt((n0 - t_p) * (n0 - t_l))
    return s / denom if denom > 0 else float("nan")


def accuracy(p: np.ndarray, l: np.ndarray, threshold: float = 0.0) -> float:
    if p.size == 0:
        return float("nan")
    pred_cls = (p > threshold).astype(np.int64)
    return float((pred_cls == l.astype(np.int64)).mean())


def f1(p: np.ndarray, l: np.ndarray, threshold: float = 0.0) -> float:
    if p.size == 0:
        return float("nan")
    pred = (p > threshold).astype(np.int64)
    lab = l.astype(np.int64)
    tp = float(((pred == 1) & (lab == 1)).sum())
    fp = float(((pred == 1) & (lab == 0)).sum())
    fn = float(((pred == 0) & (lab == 1)).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else float("nan")


def cosine_similarity(p: np.ndarray, l: np.ndarray) -> float:
    """Mean row-wise cosine similarity on [N, d] arrays."""
    p2, l2 = np.atleast_2d(p), np.atleast_2d(l)
    num = (p2 * l2).sum(-1)
    den = np.linalg.norm(p2, axis=-1) * np.linalg.norm(l2, axis=-1)
    ok = den > 0
    return float((num[ok] / den[ok]).mean()) if ok.any() else float("nan")


def grouped_correlations(
    p: np.ndarray, l: np.ndarray, groups: np.ndarray
) -> Dict[str, float]:
    """PSR-style metrics: 'local' = mean per-target correlation, 'global' =
    correlation over everything."""
    out = {}
    per = {"pearson": [], "spearman": [], "kendall": []}
    for g in np.unique(groups):
        m = groups == g
        if m.sum() < 2:
            continue
        per["pearson"].append(pearson(p[m], l[m]))
        per["spearman"].append(spearman(p[m], l[m]))
        per["kendall"].append(kendall(p[m], l[m]))
    for k, v in per.items():
        vals = [x for x in v if np.isfinite(x)]
        out[f"local_{k}"] = float(np.mean(vals)) if vals else float("nan")
    out["global_pearson"] = pearson(p, l)
    out["global_spearman"] = spearman(p, l)
    out["global_kendall"] = kendall(p, l)
    return out


METRIC_FNS = {
    "RMSE": rmse,
    "MAE": mae,
    "PearsonCorrCoef": pearson,
    "SpearmanCorrCoef": spearman,
    "KendallTau": kendall,
    "Accuracy": accuracy,
    "F1": f1,
    "CosineSimilarity": cosine_similarity,
}

# per-task metric sets
TASK_METRICS = {
    "GCPNetLBA": ["RMSE", "PearsonCorrCoef", "SpearmanCorrCoef"],
    "GCPNetPSR": ["RMSE", "PearsonCorrCoef", "SpearmanCorrCoef"],
    "GCPNetNMS": ["RMSE", "CosineSimilarity"],
    "GCPNetRS": ["Accuracy", "F1"],
    "GCPNetEQ": ["RMSE", "PearsonCorrCoef"],
    "GCPNetAR": ["RMSE"],
    "GCPNetCPD": [],  # perplexity handled from loss
}
