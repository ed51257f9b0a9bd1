"""The port's ESM-2 (``gcpnet_torch.nn.esm``), its checkpoint converters
(``gcpnet_torch.utils.esm_convert``) and the embedding tiers
(``gcpnet_torch.data.esm``) against the JAX package's, on the CPU:

- the model against the flax ``ESM2`` at a tiny config (2 layers, 64 wide,
  4 heads; flax-initialised weights carried by ``weights.from_jax_params``)
  on a padded batch of two sequences with ``<mask>`` tokens: fp32 atol 1e-5;
- random fair-esm- and transformers-shaped state dicts converted by both
  packages: equal trees and equal outputs; a JAX ``save_npz`` file loaded
  by the port;
- the tiers: a cache hit; the checkpoint tier from an ``.npz``, a fair-esm
  ``.pt`` holding its ``args`` Namespace, and a transformers directory;
  ``GCPNET_REQUIRE_ESM``; a named checkpoint that fails to load raises;
- EQ's node features of a synthetic decoy with a tiny checkpoint equal to
  the JAX featurizer's (atol 1e-5), embedded lazily or ahead of the pass.
"""

import argparse
import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

from gcpnet_tpu.data import eq as jeq
from gcpnet_tpu.data import esm as jesm
from gcpnet_tpu.nn import esm as jnn
from gcpnet_tpu.utils import esm_convert as jconvert
from gcpnet_torch.data import eq, esm
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.nn import esm as nn_esm
from gcpnet_torch.utils import esm_convert
from gcpnet_torch.weights import from_jax_params

ATOL = 1e-5
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "GAVLIFWXB"]
# converted files take 20 heads (the fair-esm converter's, every published size's)
FILE_CFG = dict(layers=2, dim=80)


def _tokens(mask_at=((0, 3), (0, 9), (1, 2))) -> np.ndarray:
    rows = [nn_esm.tokenize(s) for s in SEQS]
    out = np.full((len(rows), max(len(r) for r in rows)), nn_esm.PAD_ID, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    for i, j in mask_at:
        out[i, j] = nn_esm.MASK_ID
    return out


def _port(params, cfg) -> nn_esm.ESM2:
    model = nn_esm.ESM2(nn_esm.ESM2Config(**cfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return model.eval()


def _port_out(model, tokens) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(tokens).long()).numpy()


def _jax_out(params, cfg, tokens) -> np.ndarray:
    return np.asarray(jnn.ESM2(jnn.ESM2Config(**cfg)).apply(params, tokens))


def test_esm2_matches_flax():
    cfg = dict(num_layers=2, embed_dim=64, num_heads=4)
    tokens = _tokens()
    params = jnn.ESM2(jnn.ESM2Config(**cfg)).init(jax.random.key(0), tokens)
    want = _jax_out(params, cfg, tokens)
    got = _port_out(_port(params, cfg), tokens)
    valid = tokens != nn_esm.PAD_ID
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)
    assert np.isfinite(got).all()  # pad rows too: their keys are masked with the smallest float, not -inf


def test_alphabet_and_sizes_match_jax():
    assert nn_esm.ESM_TOKENS == jnn.ESM_TOKENS and nn_esm.MASK_RATIO_TRAIN == jnn.MASK_RATIO_TRAIN
    for size in ("t6_8M", "t12_35M", "t30_150M", "t33_650M"):
        assert vars(getattr(nn_esm.ESM2Config, size)()) == vars(getattr(jnn.ESM2Config, size)())
    np.testing.assert_array_equal(nn_esm.tokenize("acdZ*"), jnn.tokenize("acdZ*"))


def _fairesm_state(rng, layers=FILE_CFG["layers"], dim=FILE_CFG["dim"]) -> dict:
    def w(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    sd = {"encoder.embed_tokens.weight": w(33, dim), "encoder.emb_layer_norm_after.weight": 1 + w(dim),
          "encoder.emb_layer_norm_after.bias": w(dim), "encoder.lm_head.weight": w(33, dim)}
    for i in range(layers):
        p = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{proj}.weight"], sd[p + f"self_attn.{proj}.bias"] = w(dim, dim), w(dim)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[p + f"{ln}.weight"], sd[p + f"{ln}.bias"] = 1 + w(dim), w(dim)
        sd[p + "fc1.weight"], sd[p + "fc1.bias"] = w(4 * dim, dim), w(4 * dim)
        sd[p + "fc2.weight"], sd[p + "fc2.bias"] = w(dim, 4 * dim), w(dim)
    return sd


def _hf_state(rng, layers=FILE_CFG["layers"], dim=FILE_CFG["dim"]) -> dict:
    def w(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    sd = {"esm.embeddings.word_embeddings.weight": w(33, dim), "esm.encoder.emb_layer_norm_after.weight": 1 + w(dim),
          "esm.encoder.emb_layer_norm_after.bias": w(dim)}
    for i in range(layers):
        p = f"esm.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(dim, dim), w(dim)
        for ln in ("attention.LayerNorm", "LayerNorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + w(dim), w(dim)
        sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"] = w(4 * dim, dim), w(4 * dim)
        sd[p + "output.dense.weight"], sd[p + "output.dense.bias"] = w(dim, 4 * dim), w(dim)
    return sd


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("kind", ["fairesm", "hf"])
def test_converters_match_jax(kind, tmp_path):
    sd = (_fairesm_state if kind == "fairesm" else _hf_state)(np.random.default_rng(1))
    convert = "from_fairesm_state_dict" if kind == "fairesm" else "from_hf_state_dict"
    params, cfg = getattr(esm_convert, convert)(sd)
    jparams, jcfg = getattr(jconvert, convert)(sd)
    _assert_trees_equal(params, jparams)
    assert vars(cfg) == vars(jcfg)
    cfg = dict(num_layers=cfg.num_layers, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads)
    tokens = _tokens()
    valid = tokens != nn_esm.PAD_ID
    np.testing.assert_allclose(_port_out(_port(params, cfg), tokens)[valid],
                               _jax_out(jparams, cfg, tokens)[valid], atol=ATOL)
    # the JAX package's .npz loads in the port as the same tree
    path = str(tmp_path / "esm.npz")
    jconvert.save_npz(path, jparams, jcfg)
    loaded, lcfg = esm_convert.load_checkpoint(path)
    _assert_trees_equal(loaded, jparams)
    assert vars(lcfg) == vars(jcfg)


# --- the tiers of data.esm -----------------------------------------------------


@pytest.fixture
def clean_tiers(monkeypatch):
    for var in ("GCPNET_ESM_CHECKPOINT", "GCPNET_REQUIRE_ESM"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(esm, "_models", {})
    monkeypatch.setattr(esm, "_memo", {})
    monkeypatch.setattr(esm, "_warned", False)
    monkeypatch.setattr(jesm, "_jax_esm", None)
    return monkeypatch


def _checkpoints(root) -> dict:
    """One random checkpoint in each format the tier reads."""
    sd = _fairesm_state(np.random.default_rng(2))
    params, cfg = esm_convert.from_fairesm_state_dict(sd)
    npz = os.path.join(root, "esm.npz")
    esm_convert.save_npz(npz, params, cfg)
    pt = os.path.join(root, "esm.pt")
    torch.save({"args": argparse.Namespace(arch="ESM-1b", layers=cfg.num_layers),
                "model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pt)
    hf_dir = os.path.join(root, "hf")
    os.makedirs(hf_dir)
    hf = {}  # the same weights under the transformers library's names
    for k, v in sd.items():
        k = k.removeprefix("encoder.")
        k = (k.replace("embed_tokens", "embeddings.word_embeddings").replace("layers.", "encoder.layer.")
             .replace("self_attn.q_proj", "attention.self.query").replace("self_attn.k_proj", "attention.self.key")
             .replace("self_attn.v_proj", "attention.self.value")
             .replace("self_attn.out_proj", "attention.output.dense")
             .replace("self_attn_layer_norm", "attention.LayerNorm").replace("fc1", "intermediate.dense")
             .replace("fc2", "output.dense").replace("final_layer_norm", "LayerNorm")
             .replace("emb_layer_norm_after", "encoder.emb_layer_norm_after"))
        hf["esm." + k] = torch.from_numpy(v)
    torch.save(hf, os.path.join(hf_dir, "pytorch_model.bin"))
    return {"npz": npz, "pt": pt, "hf": hf_dir, "params": params, "cfg": cfg}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return _checkpoints(str(tmp_path_factory.mktemp("esm_ckpt")))


def test_cache_hit_comes_first(clean_tiers, tmp_path):
    cached = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    np.save(tmp_path / f"{esm.seq_key('ACDEF')}.npy", cached)
    clean_tiers.setenv("GCPNET_ESM_CHECKPOINT", str(tmp_path / "never_read.pt"))
    np.testing.assert_array_equal(esm.embed_sequence("ACDEF", cache_dir=str(tmp_path), device="cpu"), cached)


@pytest.mark.parametrize("kind", ["npz", "pt", "hf"])
def test_checkpoint_tier(kind, checkpoints, clean_tiers, tmp_path):
    clean_tiers.setenv("GCPNET_ESM_CHECKPOINT", checkpoints[kind])
    clean_tiers.setenv("GCPNET_REQUIRE_ESM", "1")
    seq = SEQS[0]
    got = esm.embed_sequence(seq, cache_dir=str(tmp_path), device="cpu")
    cfg = checkpoints["cfg"]
    want = jnn.embed_sequence_jax(checkpoints["params"], cfg, seq)
    assert got.shape == (len(seq), cfg.embed_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(np.load(tmp_path / f"{esm.seq_key(seq)}.npy"), got)  # written to the cache
    assert len(esm._models) == 1
    esm.embed_sequence(SEQS[1], device="cpu")
    assert len(esm._models) == 1  # loaded once per path and device


def test_require_esm_and_zeros(clean_tiers, tmp_path):
    zeros = esm.embed_sequence("GHIK", cache_dir=str(tmp_path))
    assert zeros.shape == (4, esm.ESM_EMBEDDING_DIM) and not zeros.any()
    clean_tiers.setenv("GCPNET_REQUIRE_ESM", "1")
    with pytest.raises(RuntimeError, match="GCPNET_REQUIRE_ESM"):
        esm.embed_sequence("GHIK", cache_dir=str(tmp_path))


def test_failing_checkpoint_raises(clean_tiers, tmp_path):
    """Where the JAX tier logs a warning and gives zeros, the port raises."""
    bad = tmp_path / "broken.pt"
    bad.write_bytes(b"not a checkpoint")
    clean_tiers.setenv("GCPNET_ESM_CHECKPOINT", str(bad))
    with pytest.raises(RuntimeError, match="failed to load"):
        esm.embed_sequence("GHIK", device="cpu")
    assert not jesm.embed_sequence("GHIK").any()
    clean_tiers.setenv("GCPNET_ESM_CHECKPOINT", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError):
        esm.embed_sequence("GHIK", device="cpu")


# --- EQ's features on the checkpoint's embeddings ------------------------------


def test_eq_features_match_jax_lazy_and_ahead(checkpoints, clean_tiers, tmp_path):
    root = str(tmp_path / "eq")
    write_eq_decoys(root, seed=4, targets={"train": 2, "valid": 1, "test": 1}, decoys=1, residues=(12, 20))
    clean_tiers.setenv("GCPNET_ESM_CHECKPOINT", checkpoints["npz"])
    clean_tiers.setenv("GCPNET_REQUIRE_ESM", "1")
    names = [line.strip() for line in open(os.path.join(root, "splits", "train.lst")) if line.strip()]
    # ahead: the datamodule embeds the split's sequences before its pass
    ahead_dm = eq.EQDataModule.from_data_dir(root, esm_cache_dir=str(tmp_path / "ahead"), esm_device="cpu",
                                            max_nodes_per_batch=512, max_residues_per_batch=64)
    ahead_dm.setup()
    ahead_dm.cache_dir = None  # no graph cache: featurize from the PDBs
    next(iter(ahead_dm.train_batches(seed=0)))
    assert len(os.listdir(tmp_path / "ahead")) == len(names)
    for name in names:
        decoy, native = ahead_dm._decoy_path(name), ahead_dm._native_path(name)
        lazy = eq.featurize_decoy(decoy, native, esm_cache_dir=str(tmp_path / "lazy"), esm_device="cpu")
        ahead = eq.featurize_decoy(decoy, native, esm_cache_dir=str(tmp_path / "ahead"), esm_device="cpu")
        want = jeq.featurize_decoy(decoy, native, esm_cache_dir=str(tmp_path / "jax"))
        assert lazy.h.shape == (lazy.num_nodes, FILE_CFG["dim"] + 1) and lazy.h[:, :-1].any()
        np.testing.assert_array_equal(lazy.h, ahead.h)
        np.testing.assert_allclose(lazy.h, want.h, atol=ATOL)
