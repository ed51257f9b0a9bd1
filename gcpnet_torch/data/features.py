"""Host-side featurization helpers (numpy).

The port's copy of ``gcpnet_tpu/data/features.py:15-56``: nan-safe unit
vectors, Gaussian RBF expansions, chain orientation vectors and the edge
features of an atom graph.  They run in
the host input pipeline; graphs reach the card already featurized.
"""

from __future__ import annotations

import numpy as np


def normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Unit vectors with 0 where the norm is 0 (nan-safe)."""
    norm = np.linalg.norm(x, axis=axis, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = x / norm
    return np.nan_to_num(out)


def rbf(d: np.ndarray, d_min: float = 0.0, d_max: float = 20.0, d_count: int = 16) -> np.ndarray:
    """Gaussian radial basis expansion of distances along a new last axis."""
    mu = np.linspace(d_min, d_max, d_count, dtype=np.float32)
    sigma = (d_max - d_min) / d_count
    z = (d[..., None] - mu) / sigma
    return np.exp(-(z**2)).astype(np.float32)


def orientations(x: np.ndarray) -> np.ndarray:
    """Forward/backward chain unit vectors per node -> ``[N, 2, 3]``."""
    forward = normalize(x[1:] - x[:-1])
    backward = normalize(x[:-1] - x[1:])
    forward = np.concatenate([forward, np.zeros((1, 3), x.dtype)], axis=0)
    backward = np.concatenate([np.zeros((1, 3), x.dtype), backward], axis=0)
    return np.stack([forward, backward], axis=1).astype(np.float32)


def edge_geometric_features(
    coords: np.ndarray, senders: np.ndarray, receivers: np.ndarray, d_max: float = 4.5, num_rbf: int = 16
):
    """``(RBF(|x_j - x_i|) [E, num_rbf], unit(x_j - x_i) [E, 1, 3])`` of each
    edge ``j -> i`` (senders ``j``, receivers ``i``)."""
    vec = coords[senders] - coords[receivers]
    dist = np.linalg.norm(vec, axis=-1)
    edge_s = rbf(dist, d_max=d_max, d_count=num_rbf)
    edge_v = normalize(vec)[:, None, :].astype(np.float32)
    return np.nan_to_num(edge_s), np.nan_to_num(edge_v)
