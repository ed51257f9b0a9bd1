"""CPD's test-time evaluation: per-chain perplexity and sequence recovery.

Port of ``gcpnet_tpu/models/cpd_eval.py``: for each test chain the
perplexity ``exp(mean NLL over its valid residues)``, and the recovery, the
mean identity with the native sequence over ``num_samples`` sequences
sampled autoregressively at ``temperature``; the reported numbers are the
medians over the chains, for ``all`` and for each custom subset
(``short``, ``single_chain``).  The model runs in float32 on its device,
in its deterministic mode.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.graph import GraphData

log = logging.getLogger(__name__)


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def datum_perplexity(model, graph: GraphData, bucket: Bucket) -> float:
    """``exp(mean NLL over the valid residues)`` of one chain, in a batch of
    ``bucket``'s shape."""
    batch = next(batches_from_dataset([graph], bucket))
    logits = model(batch.to(_device(model)), deterministic=True)
    log_probs = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
    seq = np.asarray(batch.extras["seq"]).astype(int)
    nll = -log_probs[np.arange(log_probs.shape[0]), seq][np.asarray(batch.valid_node_mask())]
    return float(np.exp(nll.mean())) if nll.size else float("nan")


def datum_recovery(
    model, graph: GraphData, num_samples: int = 100, temperature: float = 0.1, seed: int = 0
) -> float:
    """Mean identity with the native sequence over ``num_samples`` sampled
    sequences of one chain, drawn in one batch of ``num_samples`` copies
    (its bucket exactly that many times the chain's nodes and edges, so
    that a node's position is its index modulo the chain's length)."""
    n = graph.num_nodes
    bucket = Bucket(num_nodes=n * num_samples, num_edges=graph.num_edges * num_samples, num_graphs=num_samples)
    batch = next(batches_from_dataset([graph] * num_samples, bucket))
    device = _device(model)
    generator = torch.Generator(device=device).manual_seed(seed)
    sampled = model.sample(batch.to(device), n, temperature, generator).cpu().numpy().reshape(num_samples, n)
    valid = np.asarray(graph.node_mask) if graph.node_mask is not None else np.ones(n, bool)
    if not valid.any():
        return float("nan")
    true_seq = np.asarray(graph.extras["seq"]).astype(int)
    return float((sampled[:, valid] == true_seq[valid][None, :]).mean())


def evaluate_cpd(
    model,
    graphs: Iterable[Tuple[str, GraphData]],
    custom_splits: Optional[Dict[str, set]] = None,
    num_samples: int = 100,
    temperature: float = 0.1,
    max_nodes: int = 2048,
    compute_recovery: bool = True,
    per_chain: Optional[list] = None,
) -> Dict[str, float]:
    """``test/{all,<subset>}_perplexity`` and ``_recovery``: medians over the
    chains of ``graphs`` (``(name, graph)`` pairs) and over those of each
    custom subset.  A chain whose data fails (a ``ValueError`` or the like:
    a chain over the bucket) is logged and left out, as in the JAX
    function; a ``RuntimeError`` (a failed launch, a CUDA error, memory)
    ends the evaluation, since every later chain would fail with it.
    ``per_chain``, when given, receives each
    evaluated chain's ``(name, perplexity, recovery, seconds)``."""
    custom_splits = custom_splits or {}
    bucket = Bucket(num_nodes=max_nodes, num_edges=max_nodes * 32, num_graphs=2)
    per_chain = [] if per_chain is None else per_chain
    for name, graph in graphs:
        try:
            t0 = time.perf_counter()
            ppl = datum_perplexity(model, graph, bucket)
            rec = datum_recovery(model, graph, num_samples, temperature) if compute_recovery else None
            per_chain.append((name, ppl, rec, time.perf_counter() - t0))
        except RuntimeError:
            raise
        except Exception as exc:  # as the JAX function: one chain's bad data ends nothing
            log.warning(f"CPD eval failed for {name}: {exc}")

    def agg(names: Optional[set], key: str) -> Dict[str, float]:
        rows = [r for r in per_chain if names is None or r[0] in names]
        ppls = [r[1] for r in rows if np.isfinite(r[1])]
        recs = [r[2] for r in rows if r[2] is not None and np.isfinite(r[2])]
        out = {}
        if ppls:
            out[f"test/{key}_perplexity"] = float(np.median(ppls))
        if recs:
            out[f"test/{key}_recovery"] = float(np.median(recs))
        return out

    metrics = agg(None, "all")
    for key, names in custom_splits.items():
        metrics.update(agg(set(names), key))
    return metrics
