"""ESM-2 checkpoints into the port's ESM-2 (``gcpnet_torch.nn.esm``).

Port of ``gcpnet_tpu/utils/esm_convert.py``.  The converters give the same
flax-shaped tree as the JAX package's (``{"params": nested dicts}``,
kernels ``[in, out]``), which ``weights.from_jax_params`` turns into the
port's state dict:

- fair-esm ``.pt`` checkpoints (``from_fairesm_state_dict``: the
  ``encoder.`` and ``sentence_encoder.`` prefixes),
- state dicts of the transformers library's ``EsmModel`` and its model
  directories (``from_hf_state_dict``: the ``esm.`` prefix), read from
  their ``.bin``/``.pt`` file as the JAX loader reads them,
- the ``.npz`` of ``scripts/convert_esm_checkpoint.py`` (``save_npz``,
  ``load_checkpoint``): ``/``-joined flax paths and a ``__cfg__`` row
  ``[layers, dim, heads, vocab]``, so one file loads in both packages.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from gcpnet_torch.nn.esm import ESM2, ESM2Config
from gcpnet_torch.weights import from_jax_params


def _array(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _set(params: Dict, path, leaf, value):
    node = params
    for tok in path:
        node = node.setdefault(tok, {})
    node[leaf] = value


def _linear(params, path, name, w, b):
    _set(params, path + [name], "kernel", _array(w).T)
    if b is not None:
        _set(params, path + [name], "bias", _array(b))


def _ln(params, path, name, w, b):
    _set(params, path + [name], "scale", _array(w))
    _set(params, path + [name], "bias", _array(b))


def from_fairesm_state_dict(sd: Mapping) -> Tuple[Dict, ESM2Config]:
    """A fair-esm ESM2 module's state dict -> (flax-shaped params, config)."""
    sd = {k.removeprefix("encoder.").removeprefix("sentence_encoder."): v for k, v in sd.items()}
    embed = _array(sd["embed_tokens.weight"])
    layer_ids = sorted({int(m.group(1)) for k in sd if (m := re.match(r"layers\.(\d+)\.", k))})
    # every published size has 20 heads
    cfg = ESM2Config(num_layers=len(layer_ids), embed_dim=embed.shape[1], num_heads=20, vocab_size=embed.shape[0])
    params: Dict = {}
    _set(params, ["embed_tokens"], "embedding", embed)
    for i in layer_ids:
        p, lp = f"layers.{i}.", [f"layers_{i}"]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(params, lp + ["self_attn"], proj, sd[p + f"self_attn.{proj}.weight"],
                    sd.get(p + f"self_attn.{proj}.bias"))
        _ln(params, lp, "self_attn_layer_norm", sd[p + "self_attn_layer_norm.weight"],
            sd[p + "self_attn_layer_norm.bias"])
        _linear(params, lp, "fc1", sd[p + "fc1.weight"], sd[p + "fc1.bias"])
        _linear(params, lp, "fc2", sd[p + "fc2.weight"], sd[p + "fc2.bias"])
        _ln(params, lp, "final_layer_norm", sd[p + "final_layer_norm.weight"], sd[p + "final_layer_norm.bias"])
    _ln(params, [], "emb_layer_norm_after", sd["emb_layer_norm_after.weight"], sd["emb_layer_norm_after.bias"])
    return {"params": params}, cfg


def from_hf_state_dict(sd: Mapping, num_heads: int = 20) -> Tuple[Dict, ESM2Config]:
    """A transformers ``EsmModel`` state dict -> (flax-shaped params, config)."""
    sd = {k.removeprefix("esm."): v for k, v in sd.items()}
    embed = _array(sd["embeddings.word_embeddings.weight"])
    layer_ids = sorted({int(m.group(1)) for k in sd if (m := re.match(r"encoder\.layer\.(\d+)\.", k))})
    cfg = ESM2Config(num_layers=len(layer_ids), embed_dim=embed.shape[1], num_heads=num_heads,
                     vocab_size=embed.shape[0])
    params: Dict = {}
    _set(params, ["embed_tokens"], "embedding", embed)
    for i in layer_ids:
        p, lp = f"encoder.layer.{i}.", [f"layers_{i}"]
        for proj, hf in (("q_proj", "attention.self.query"), ("k_proj", "attention.self.key"),
                         ("v_proj", "attention.self.value"), ("out_proj", "attention.output.dense")):
            _linear(params, lp + ["self_attn"], proj, sd[p + hf + ".weight"], sd.get(p + hf + ".bias"))
        _ln(params, lp, "self_attn_layer_norm", sd[p + "attention.LayerNorm.weight"],
            sd[p + "attention.LayerNorm.bias"])
        _linear(params, lp, "fc1", sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"])
        _linear(params, lp, "fc2", sd[p + "output.dense.weight"], sd[p + "output.dense.bias"])
        _ln(params, lp, "final_layer_norm", sd[p + "LayerNorm.weight"], sd[p + "LayerNorm.bias"])
    _ln(params, [], "emb_layer_norm_after", sd["encoder.emb_layer_norm_after.weight"],
        sd["encoder.emb_layer_norm_after.bias"])
    return {"params": params}, cfg


def _torch_load(path: str):
    """``torch.load`` on the CPU with ``weights_only`` kept on.  A fair-esm
    checkpoint pickles its training arguments as an ``argparse.Namespace``
    under ``args``; that one class is allowed through as a safe global
    rather than loading the user's file with ``weights_only=False``."""
    torch.serialization.add_safe_globals([argparse.Namespace])
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str) -> Tuple[Dict, ESM2Config]:
    """ESM-2 weights from a fair-esm ``.pt``, an ``.npz`` written by
    :func:`save_npz` (or the JAX package's), or a transformers model
    directory (its first ``.bin``/``.pt`` file)."""
    if path.endswith(".npz"):
        return _load_npz(path)
    if os.path.isdir(path):
        bins = sorted(f for f in os.listdir(path) if f.endswith((".bin", ".pt")))
        if not bins:
            raise FileNotFoundError(f"no torch weights (.bin or .pt) in {path}")
        return from_hf_state_dict(_torch_load(os.path.join(path, bins[0])))
    ckpt = _torch_load(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return from_fairesm_state_dict({k: v for k, v in sd.items() if isinstance(v, (torch.Tensor, np.ndarray))})


def build_model(params: Dict, cfg: ESM2Config, device=None) -> ESM2:
    """The port's ESM-2 with the weights of a flax-shaped ``params`` tree,
    in float32 on ``device`` (the CPU when ``None``), in eval mode."""
    model = ESM2(cfg, device="meta")
    model.load_state_dict(from_jax_params(params), assign=True)
    return model.to(torch.device("cpu" if device is None else device)).eval()


def save_npz(path: str, params: Dict, cfg: ESM2Config) -> None:
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = _array(v)

    walk(params["params"], "")
    flat["__cfg__"] = np.asarray([cfg.num_layers, cfg.embed_dim, cfg.num_heads, cfg.vocab_size], dtype=np.int64)
    np.savez(path, **flat)


def _load_npz(path: str) -> Tuple[Dict, ESM2Config]:
    with np.load(path) as z:
        meta = z["__cfg__"]
        cfg = ESM2Config(num_layers=int(meta[0]), embed_dim=int(meta[1]), num_heads=int(meta[2]),
                         vocab_size=int(meta[3]))
        params: Dict = {}
        for key in z.files:
            if key != "__cfg__":
                toks = key.split("/")
                _set(params, toks[:-1], toks[-1], z[key])
    return {"params": params}, cfg
