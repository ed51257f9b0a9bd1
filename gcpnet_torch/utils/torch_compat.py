"""Translate the reference's PyTorch state dicts into the port's parameter
names.

The port's copy of ``gcpnet_tpu/utils/torch_compat.py``.  The reference
stores weights under torch module paths such as
``interaction.message_fusion.3.vector_down.weight`` with ``nn.Linear``'s
``[out, in]`` layout; the port's modules keep the flax names and the
``[in, out]`` kernel layout (``gcpnet_torch.weights``), so
:func:`translate_state_dict` folds ModuleList indices into the name
(``message_fusion_3``), transposes each linear weight into a ``kernel``,
and gives the nested parameter tree that ``weights.from_jax_params``
takes.  Every GCP of the family keeps its attribute names across: GCP2's
``vector_out_scale_frames`` and ``vector_up_frames``, GCP3's
``scalar_out`` Sequential (``scalar_out_0``, ``scalar_out_1``), GCP v1's
``scalar_out_frames``, ``vector_out_scale_sigma_frames``,
``vector_out_scale_frames`` and ``vector_up_frames``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# torch attribute name -> the port's module name (applied after index folding)
_RENAMES = {
    "feedforward_network": "feedforward",
    "node_position_update_network": "node_position_update",
}

# Sequential wrappers whose single parametrized child keeps the parent name
_SEQUENTIAL_COLLAPSE = {"scalar_message_attention"}

# nn.Embedding tables: the weight is the table ``embedding``, untransposed
_EMBED_MODULES = {"atom_embedding", "lig_flag_embedding", "sequence_embedding"}


def _fold_indices(tokens):
    """Fold ModuleList/Sequential numeric path elements into their parent
    name: ``["message_fusion", "3"] -> ["message_fusion_3"]``."""
    out = []
    for tok in tokens:
        if tok.isdigit() and out:
            out[-1] = f"{out[-1]}_{tok}"
        else:
            out.append(_RENAMES.get(tok, tok))
    return out


def _translate_module_path(tokens):
    result = []
    for tok in _fold_indices(tokens):
        base, _, idx = tok.rpartition("_")
        if base in _SEQUENTIAL_COLLAPSE and idx.isdigit():
            result.append(base)
        elif base == "scalar_out" and idx.isdigit():
            # GCP3's feedforward_out Sequential(Linear, act, Linear): torch
            # indices 0 and 2 -> scalar_out_0 / scalar_out_1
            result.append(f"scalar_out_{int(idx) // 2}")
        else:
            result.append(tok)
    return result


def translate_state_dict(state_dict: Mapping[str, np.ndarray]) -> Dict:
    """A reference ``state_dict`` (name -> array) as a nested parameter
    tree of the port's (flax) names: ``weights.from_jax_params`` of it is
    the port module's ``state_dict``."""
    params: Dict = {}
    for name, value in state_dict.items():
        value = np.asarray(value)
        tokens = name.split(".")
        leaf = tokens[-1]
        path = _translate_module_path(tokens[:-1])

        if len(path) >= 2 and path[-2:] == ["phi_force_ij", "1"]:
            # nn.Sequential(act, Linear(bias=False)) -> one module parameter
            path = path[:-2]
            leaf_name, leaf_value = "phi_force_ij_kernel", value.T
        elif path and path[-1] == "phi_force_ij_1":
            path = path[:-1]
            leaf_name, leaf_value = "phi_force_ij_kernel", value.T
        elif path and path[-1] in _EMBED_MODULES and leaf == "weight":
            leaf_name, leaf_value = "embedding", value
        elif leaf == "weight" and value.ndim == 2:
            leaf_name, leaf_value = "kernel", value.T
        elif leaf == "weight" and value.ndim == 1:
            # LayerNorm's affine weight
            leaf_name, leaf_value = "scale", value
        elif leaf == "bias":
            leaf_name, leaf_value = "bias", value
        else:
            raise ValueError(f"cannot translate state-dict entry {name!r}")

        node = params
        for tok in path:
            node = node.setdefault(tok, {})
        node[leaf_name] = leaf_value
    return params
