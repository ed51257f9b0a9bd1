"""ESM-2 residue embeddings for EQ and AR.

Port of ``gcpnet_tpu/data/esm.py``: ``[len(seq), 1280]`` embeddings of a
sequence from the first of these tiers that has one:

1. a cached ``<sha1(seq)>.npy`` under the embedding cache directory (or,
   without one, this process's memo of what :func:`prepare` embedded);
2. the port's ESM-2 (``gcpnet_torch.nn.esm``) from the checkpoint that
   ``GCPNET_ESM_CHECKPOINT`` names: a fair-esm ``.pt``, an ``.npz`` of
   ``scripts/convert_esm_checkpoint.py`` or a transformers model directory,
   loaded once per path and device and run on the card unless the caller
   passes the CPU;
3. live fair-esm, where ``import esm`` succeeds;
4. zeros, with a one-time warning; with ``GCPNET_REQUIRE_ESM`` set, an
   error instead.

Tiers 2 and 3 write the cache.  One deliberate difference from the JAX
module: a checkpoint that is named but fails to load raises, where the JAX
tier logs a warning and goes on to zeros.

EQ and AR featurize on threads ahead of the training step, while the step
may be capturing a CUDA graph; so their datamodules call :func:`prepare`
from the caller's thread before a split's pass, which embeds the pass's
sequences and caches them, and the threads then only read host arrays.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from gcpnet_torch.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

ESM_EMBEDDING_DIM = 1280
CHECKPOINT_ENV = "GCPNET_ESM_CHECKPOINT"

_warned = False
_lock = threading.Lock()
_models: Dict[Tuple[str, str], object] = {}  # (checkpoint path, device) -> ESM2
_live: Dict[str, tuple] = {}  # device -> (fair-esm model, alphabet)
_memo: Dict[str, np.ndarray] = {}  # sha1 -> embedding, prepared without a cache directory


def seq_key(seq: str) -> str:
    """The cache file's stem of a sequence."""
    return hashlib.sha1(seq.encode()).hexdigest()


def checkpoint_model(device: DeviceLike = None):
    """The ESM-2 of ``GCPNET_ESM_CHECKPOINT`` on ``device`` (``None``: the
    card), loaded at the first call for that path and device; ``None``
    without the variable.  A named checkpoint that is missing or fails to
    load raises."""
    path = os.environ.get(CHECKPOINT_ENV)
    if not path:
        return None
    dev = resolve_device(device)
    key = (os.path.abspath(path), str(dev))
    if key not in _models:
        from gcpnet_torch.utils.esm_convert import build_model, load_checkpoint

        if not os.path.exists(path):
            raise FileNotFoundError(f"{CHECKPOINT_ENV}={path} does not exist")
        try:
            params, cfg = load_checkpoint(path)
        except Exception as exc:
            raise RuntimeError(f"{CHECKPOINT_ENV}={path} failed to load: {exc!r}") from exc
        _models[key] = build_model(params, cfg, dev)
        log.info(f"loaded the ESM-2 checkpoint {path} ({cfg}) on {dev}")
    return _models[key]


def _live_esm(seq: str, device: DeviceLike) -> Optional[np.ndarray]:
    """fair-esm's ESM-2 650M, where the package is installed."""
    try:
        import esm  # fair-esm
    except ImportError:
        return None
    import torch

    dev = resolve_device(device)
    if str(dev) not in _live:
        model, alphabet = esm.pretrained.esm2_t33_650M_UR50D()
        _live[str(dev)] = (model.eval().to(dev), alphabet)
    model, alphabet = _live[str(dev)]
    _, _, tokens = alphabet.get_batch_converter()([("seq", seq)])
    with torch.no_grad():
        out = model(tokens.to(dev), repr_layers=[33])
    return out["representations"][33][0, 1 : len(seq) + 1].float().cpu().numpy()


def _computed(seq: str, device: DeviceLike) -> Optional[np.ndarray]:
    """Tiers 2 and 3 (one caller at a time)."""
    with _lock:
        model = checkpoint_model(device)
        if model is not None:
            from gcpnet_torch.nn.esm import embed_sequence as run

            return run(model, seq)
        return _live_esm(seq, device)


def _write(cache_dir: str, seq: str, emb: np.ndarray) -> None:
    """Write the cache file whole (a temporary file renamed), so that
    processes writing the same sequence at once leave one good file."""
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npy.tmp")
    with os.fdopen(fd, "wb") as f:
        np.save(f, emb)
    os.replace(tmp, os.path.join(cache_dir, seq_key(seq) + ".npy"))


def _cached(seq: str, cache_dir: Optional[str]) -> Optional[np.ndarray]:
    if cache_dir:
        path = os.path.join(cache_dir, seq_key(seq) + ".npy")
        if os.path.exists(path):
            return np.load(path)
    return _memo.get(seq_key(seq))


def embed_sequence(seq: str, cache_dir: Optional[str] = None, device: DeviceLike = None) -> np.ndarray:
    """``[len(seq), 1280]`` residue embeddings from the first tier that has
    them (see the module's docstring); ``device`` is where tiers 2 and 3
    run (``None``: the card)."""
    global _warned
    emb = _cached(seq, cache_dir)
    if emb is not None:
        return emb
    emb = _computed(seq, device)
    if emb is not None:
        if cache_dir:
            _write(cache_dir, seq, emb)
        else:
            _memo[seq_key(seq)] = emb
        return emb
    if os.environ.get("GCPNET_REQUIRE_ESM"):
        raise RuntimeError(
            "GCPNET_REQUIRE_ESM is set but no ESM embedding source is available "
            f"(no cached {seq_key(seq)}.npy under {cache_dir!r}, no {CHECKPOINT_ENV}, no fair-esm)"
        )
    if not _warned:
        log.warning(
            f"no ESM source: using zero embeddings (set {CHECKPOINT_ENV} to an ESM-2 checkpoint, or write "
            "<sha1(seq)>.npy files into the embedding cache directory; set GCPNET_REQUIRE_ESM=1 to forbid "
            "this degraded mode)"
        )
        _warned = True
    return np.zeros((len(seq), ESM_EMBEDDING_DIM), dtype=np.float32)


def source_available() -> bool:
    """Whether tier 2 or 3 can embed: ``GCPNET_ESM_CHECKPOINT`` is set or
    fair-esm imports."""
    if os.environ.get(CHECKPOINT_ENV):
        return True
    try:
        import esm  # noqa: F401  (fair-esm)
    except ImportError:
        return False
    return True


def prepare(seqs: Iterable[str], cache_dir: Optional[str] = None, device: DeviceLike = None) -> int:
    """Embed each distinct sequence of ``seqs`` that no cache holds yet,
    here and now, and cache it (the cache directory, else this process's
    memo); the number embedded.  Nothing happens without a source."""
    if not source_available():
        return 0
    todo = {seq for seq in seqs if _cached(seq, cache_dir) is None}
    for seq in sorted(todo):
        embed_sequence(seq, cache_dir, device)
    return len(todo)
