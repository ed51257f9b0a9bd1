"""Synthetic AR decoy and native pairs in the directory layout ``data.ar``
reads.

Real AF2 decoys, their natives and the AR split lists are on neither
machine; :func:`write_ar_pairs` writes a seeded stand-in of the JAX
datamodule's layout under a root: ``splits/train1.lst``, ``valid1.lst``
and ``test_ar.lst``, ``true_model/<name>.pdb``, ``AF2_model/<name>.pdb``
and ``model_data_cache/esm/<sha1(seq)>.npy``.  A native is a chain of
``data.eq_synthetic``'s heavy atoms (about 8.5 a residue) on an ideal
backbone; its decoy is the native with coordinate noise, a scale drawn
log-uniform in ``NOISE`` (A) that a smooth profile along the chain
modulates, under the same name.  Validation and test chains keep under
``EVAL_RESIDUES[1]`` residues, so that every one fits the 4,096-node bucket
(the JAX batcher drops a larger graph without a word).  Each sequence gets
a seeded random ``[L, 1280]`` ESM cache file.

    python -c "from gcpnet_torch.data.ar_synthetic import write_ar_pairs; print(write_ar_pairs('D'))"
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gcpnet_torch.data.cath_synthetic import synthetic_backbones
from gcpnet_torch.data.eq_synthetic import ONE_LETTER, _native, _smooth_profile
from gcpnet_torch.data.esm import ESM_EMBEDDING_DIM, seq_key
from gcpnet_torch.data.pdb import write_pdb

PAIRS = {"train": 64, "valid": 8, "test": 8}
TRAIN_RESIDUES = (150, 700)  # a training chain's, log-uniform: most are cropped to 250
EVAL_RESIDUES = (100, 380)  # a validation or test chain's: under 4,096 heavy atoms
NOISE = (0.5, 3.0)  # a decoy's noise scale (A), log-uniform
LIST_NAMES = {"train": "train1.lst", "valid": "valid1.lst", "test": "test_ar.lst"}


def write_pair(root: str, name: str, rng: np.random.Generator, residues: int, esm: bool = True) -> int:
    """One native of ``residues`` residues and its decoy, both named
    ``name`` (``true_model/`` and ``AF2_model/`` under ``root``), and its
    ESM cache file; returns the heavy atoms."""
    for d in ("AF2_model", "true_model", "model_data_cache/esm"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    (backbone, _), = synthetic_backbones(rng, [residues])
    coords, atom_names, resnames, resseqs = _native(rng, backbone)
    chains = ["A"] * len(atom_names)
    write_pdb(os.path.join(root, "true_model", f"{name}.pdb"), coords, atom_names, resnames, chains, resseqs)
    seq = "".join(ONE_LETTER[resnames[i]] for i in np.unique(np.asarray(resseqs), return_index=True)[1])
    if esm:
        np.save(os.path.join(root, "model_data_cache/esm", seq_key(seq) + ".npy"),
                rng.normal(size=(len(seq), ESM_EMBEDDING_DIM)).astype(np.float32))
    per_res = np.exp(rng.uniform(*np.log(NOISE))) * _smooth_profile(rng, len(seq))
    res_of_atom = np.asarray(resseqs) - 1
    moved = coords + per_res[res_of_atom, None] * rng.normal(size=coords.shape) / np.sqrt(3.0)
    write_pdb(os.path.join(root, "AF2_model", f"{name}.pdb"), moved, atom_names, resnames, chains, resseqs)
    return len(atom_names)


def write_ar_pairs(
    root: str,
    seed: int = 0,
    pairs: Optional[dict] = None,
    train_residues=TRAIN_RESIDUES,
    eval_residues=EVAL_RESIDUES,
) -> dict:
    """Synthetic AR pairs under ``root`` (see the module's docstring):
    ``pairs`` decoys per split (default PAIRS).  Returns the decoys per
    split and the atoms' mean and range."""
    rng = np.random.default_rng(seed)
    pairs = pairs or PAIRS
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)
    written, atoms = {}, []
    for split, count in pairs.items():
        span = train_residues if split == "train" else eval_residues
        lengths = np.exp(rng.uniform(*np.log(span), size=count)).astype(int)
        names = [f"{split[:2]}{i:03d}" for i in range(count)]
        for name, n_res in zip(names, lengths):
            atoms.append(write_pair(root, name, rng, int(n_res)))
        with open(os.path.join(root, "splits", LIST_NAMES[split]), "w") as f:
            f.write("".join(name + "\n" for name in names))
        written[split] = count
    return {"decoys": written, "atoms": {"mean": float(np.mean(atoms)), "min": int(np.min(atoms)),
                                         "max": int(np.max(atoms))}}
