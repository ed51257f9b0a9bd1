"""ESM-2, the protein language model whose residue embeddings are EQ's and
AR's node inputs.

Port of ``gcpnet_tpu/nn/esm.py``: the pre-LN transformer encoder of ESM-2
(Lin et al. 2023) with rotary position embeddings on the queries and keys
(the whole head), exact-erf GELU, queries scaled before the rotation,
mask-token "token dropout" rescaling and a final layer norm.  Module and
parameter names are the flax module's (``embed_tokens.embedding``,
``layers_{i}.self_attn.{q,k,v,out}_proj.{kernel,bias}``,
``self_attn_layer_norm``, ``fc1``, ``fc2``, ``final_layer_norm``,
``emb_layer_norm_after``) and kernels keep flax's ``[in, out]`` layout, so
``weights.from_jax_params`` carries a flax tree across unchanged.

Plain PyTorch in float32: the JAX package runs this model outside any
Pallas kernel.  Attention is written out (no ``scaled_dot_product_attention``,
which masks with ``-inf`` where this model masks with the dtype's smallest
finite value, so a query whose keys are all padding still sees a uniform
softmax and not NaN).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from gcpnet_torch.nn.primitives import LayerNorm

# the fair-esm alphabet, in its order
ESM_TOKENS = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
    "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O",
    ".", "-", "<null_1>", "<mask>",
]
TOKEN_TO_ID = {t: i for i, t in enumerate(ESM_TOKENS)}
CLS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
MASK_ID = TOKEN_TO_ID["<mask>"]
MASK_RATIO_TRAIN = 0.15 * 0.8


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    num_layers: int = 33
    embed_dim: int = 1280
    num_heads: int = 20
    vocab_size: int = 33
    token_dropout: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @classmethod
    def t6_8M(cls):
        return cls(num_layers=6, embed_dim=320, num_heads=20)

    @classmethod
    def t12_35M(cls):
        return cls(num_layers=12, embed_dim=480, num_heads=20)

    @classmethod
    def t30_150M(cls):
        return cls(num_layers=30, embed_dim=640, num_heads=20)

    @classmethod
    def t33_650M(cls):
        return cls(num_layers=33, embed_dim=1280, num_heads=20)


def tokenize(seq: str) -> np.ndarray:
    """``<cls> seq <eos>`` token ids (an unknown residue is ``X``)."""
    ids = [CLS_ID]
    for ch in seq:
        ids.append(TOKEN_TO_ID.get(ch.upper(), TOKEN_TO_ID["X"]))
    ids.append(EOS_ID)
    return np.asarray(ids, dtype=np.int32)


def rope_tables(seq_len: int, head_dim: int, dtype: torch.dtype, device) -> Tuple[Tensor, Tensor]:
    """``cos`` and ``sin`` ``[T, head_dim]``, built in float32, then cast."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: Tensor) -> Tensor:
    """The halves rotated, ``[-x2, x1]`` (not interleaved pairs)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class Linear(nn.Module):
    """``x @ kernel + bias`` with ``kernel`` ``[in, out]``, initialised as
    the ESM-2 releases of the transformers library are: normal with std
    0.02, zero bias."""

    def __init__(self, in_features: int, features: int, *, generator: torch.Generator, device):
        super().__init__()
        w = torch.empty((in_features, features), device=device)
        self.kernel = nn.Parameter(w.normal_(0.0, 0.02, generator=generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.kernel + self.bias


class SelfAttention(nn.Module):
    def __init__(self, cfg: ESM2Config, *, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Linear(d, d, generator=generator, device=device) for _ in range(4)
        )

    def forward(self, x: Tensor, pad_mask: Tensor) -> Tensor:
        B, T, D = x.shape
        H, hd = self.cfg.num_heads, self.cfg.head_dim

        def heads(proj):
            return proj(x).reshape(B, T, H, hd).transpose(1, 2)

        # the query is scaled before the rotation (the order matters with
        # rotary embeddings)
        q = heads(self.q_proj) * (1.0 / math.sqrt(hd))
        k = heads(self.k_proj)
        v = heads(self.v_proj)
        cos, sin = rope_tables(T, hd, x.dtype, x.device)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin

        logits = q @ k.transpose(-1, -2)
        neg = torch.finfo(x.dtype).min
        logits = logits.masked_fill(~pad_mask[:, None, None, :], neg)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: ESM2Config, *, generator: torch.Generator, device):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.self_attn_layer_norm = LayerNorm(d, device=device, eps=eps)
        self.self_attn = SelfAttention(cfg, generator=generator, device=device)
        self.final_layer_norm = LayerNorm(d, device=device, eps=eps)
        self.fc1 = Linear(d, 4 * d, generator=generator, device=device)
        self.fc2 = Linear(4 * d, d, generator=generator, device=device)

    def forward(self, x: Tensor, pad_mask: Tensor) -> Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), pad_mask)
        y = F.gelu(self.fc1(self.final_layer_norm(x)), approximate="none")
        return x + self.fc2(y)


class Embedding(nn.Module):
    """Token table ``embedding`` ``[vocab, dim]``: normal with std 0.02, the
    ``<pad>`` row zero."""

    def __init__(self, vocab: int, dim: int, *, generator: torch.Generator, device):
        super().__init__()
        w = torch.empty((vocab, dim), device=device).normal_(0.0, 0.02, generator=generator)
        w[PAD_ID] = 0.0
        self.embedding = nn.Parameter(w)

    def forward(self, tokens: Tensor) -> Tensor:
        return F.embedding(tokens, self.embedding)


class ESM2(nn.Module):
    """Final-layer representations ``[B, T, D]`` of token ids ``[B, T]``.

    Random weights come from ``generator`` (seeded, on ``device``; a fresh
    one from seed 0 when ``None``); on the ``meta`` device nothing is drawn,
    for weights assigned afterwards."""

    def __init__(self, cfg: ESM2Config, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = torch.device("cpu" if device is None else device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.embed_dim, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", TransformerLayer(cfg, **kw))
        self.emb_layer_norm_after = LayerNorm(cfg.embed_dim, device=device, eps=cfg.layer_norm_eps)

    def forward(self, tokens: Tensor) -> Tensor:
        cfg = self.cfg
        pad_mask = tokens != PAD_ID
        x = self.embed_tokens(tokens)
        if cfg.token_dropout:
            # mask-token dropout compensation (fair-esm's esm2.py), applied
            # at inference too; <cls> and <eos> count in the length
            is_mask = (tokens == MASK_ID)[..., None]
            x = x.masked_fill(is_mask, 0.0)
            src_len = pad_mask.sum(-1)
            observed = (tokens == MASK_ID).sum(-1) / src_len.clamp(min=1)
            x = x * ((1.0 - MASK_RATIO_TRAIN) / (1.0 - observed))[:, None, None].to(x.dtype)
        x = x * pad_mask[..., None].to(x.dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, pad_mask)
        return self.emb_layer_norm_after(x)


@torch.no_grad()
def embed_sequence(model: ESM2, seq: str) -> np.ndarray:
    """``[len(seq), D]`` float32 numpy residue embeddings of one sequence
    (``<cls>``/``<eos>`` stripped), run alone on the model's device, as the
    JAX package's ``embed_sequence_jax`` runs it."""
    device = next(model.parameters()).device
    tokens = torch.from_numpy(tokenize(seq)[None]).long().to(device)
    return model(tokens)[0, 1 : len(seq) + 1].float().cpu().numpy()
