"""Weight bridge from the JAX package's flax parameters to the port.

The port keeps flax's parameter names and layouts, so the bridge only
renames: the flax path ``params/encoder/interaction_0/interaction/
message_fusion_3/vector_down/kernel`` is the state-dict key
``encoder.interaction_0.interaction.message_fusion_3.vector_down.kernel``.
Every task model keeps its JAX module names, so the same renaming serves
each: CPD's ``gcp_embedding``, ``encoder_{i}``, ``seq_embedding``,
``decoder_{i}`` (or the MLP head's ``decoder/readout_{i}``) and
``invariant_node_projection`` included, and EQ's ``atom_embedding``,
``encoder/interaction_{i}`` (``GCPInteractions2``: ``interaction/
message_fusion_{j}``, ``interaction/scalar_message_attention``,
``gcp_norm_0``, ``feedforward_0/scalar_out_0`` and ``scalar_out_1``),
``projection_norm``, ``invariant_node_projection``, ``dense_0`` and
``dense_1``; AR's ``encoder/interaction_{i}`` with its position update
``node_position_update_gcp``.
Layouts, identical on both sides (no transposes):

- ``Dense`` / ``VecDense`` ``kernel``: ``[in, out]`` (the port computes
  ``x @ kernel``, not torch's ``[out, in]`` ``nn.Linear`` layout);
  ``bias``: ``[out]``;
- ``LayerNorm``: ``scale`` and ``bias``, ``[features]``;
- ``Embed``: ``embedding``, ``[num_embeddings, features]``.

A gradient tree of the flax parameters (``jax.grad`` of a loss over the
variables) has the same paths, so :func:`from_jax_params` also brings JAX
gradients into the port's parameter names, as the parity tests do.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Union

import numpy as np
import torch

Tree = Union[Mapping, str, os.PathLike]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def from_jax_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a flax parameter tree given as nested
    dicts of arrays (with or without the top-level ``"params"`` key), or
    from an ``.npz`` file whose keys are the ``/``-joined flax paths."""
    if isinstance(tree, Mapping):
        flat = _flatten(tree)
    else:
        with np.load(tree) as npz:
            flat = {k: npz[k] for k in npz.files}
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        state[".".join(parts)] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def to_jax_params(state_dict: Mapping) -> Dict[str, dict]:
    """Inverse of :func:`from_jax_params`: ``{"params": nested dicts of
    float32 numpy arrays}``."""
    params: Dict[str, dict] = {}
    for key, value in state_dict.items():
        node = params
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().float().cpu().numpy()
    return {"params": params}


def save_npz(state_dict: Mapping, path: Union[str, os.PathLike]) -> None:
    """Write a state dict as an ``.npz`` of ``/``-joined flax paths, the
    format :func:`from_jax_params` reads."""
    np.savez(path, **_flatten(to_jax_params(state_dict)))
