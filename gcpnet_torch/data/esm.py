"""ESM-2 residue embeddings for EQ, from a cache or as zeros.

Port of the tiers of ``gcpnet_tpu/data/esm.py:90-119`` that need no file
from outside: a cached ``<sha1(seq)>.npy`` (``[len(seq), 1280]``) under
the embedding cache directory, else a zero tensor with a one-time warning;
with ``GCPNET_REQUIRE_ESM`` set the zeros are an error instead.  The JAX
module's other tiers (the flax ESM-2 from a checkpoint, live fair-esm)
wait for a slice that ports the ESM-2 module; without a checkpoint they
find nothing, and the zeros follow, as here.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

ESM_EMBEDDING_DIM = 1280

_warned = False


def seq_key(seq: str) -> str:
    """The cache file's stem of a sequence."""
    return hashlib.sha1(seq.encode()).hexdigest()


def embed_sequence(seq: str, cache_dir: Optional[str] = None) -> np.ndarray:
    """``[len(seq), 1280]`` residue embeddings: the cached file, else zeros
    (see the module's docstring)."""
    global _warned
    if cache_dir:
        path = os.path.join(cache_dir, seq_key(seq) + ".npy")
        if os.path.exists(path):
            return np.load(path)
    if os.environ.get("GCPNET_REQUIRE_ESM"):
        raise RuntimeError(
            "GCPNET_REQUIRE_ESM is set but no ESM embedding source is available "
            f"(no cached {seq_key(seq)}.npy under {cache_dir!r}; the port reads the cache only)"
        )
    if not _warned:
        log.warning(
            "no cached ESM embedding: using zero embeddings (write <sha1(seq)>.npy files into the "
            "embedding cache directory; set GCPNET_REQUIRE_ESM=1 to forbid this degraded mode)"
        )
        _warned = True
    return np.zeros((len(seq), ESM_EMBEDDING_DIM), dtype=np.float32)
