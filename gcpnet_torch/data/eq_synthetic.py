"""Synthetic EQ data in the directory layout ``data.eq`` reads.

Real EQ decoys and natives are on neither machine; :func:`write_eq_decoys`
writes a seeded stand-in of the JAX datamodule's layout under a root:
``splits/{train,valid,test}.lst``, ``true_model/<target>.pdb``,
``decoy_model/<target>_d<k>.pdb`` and ``model_data_cache/esm/
<sha1(seq)>.npy``.  A native is a chain of ``data.cath_synthetic``'s
ideal backbones with side-chain heavy atoms named from
``data.eq.EQ_ATOM_TYPES`` (``SIDE_CHAINS``, about 8.5 heavy atoms a
residue).  A decoy is its native with coordinate noise: a scale drawn
log-uniform in ``NOISE`` (A), which a smooth profile along the chain
modulates, so that its per-residue lDDT varies; its b-factor column holds
a plDDT that follows the noise.  Each sequence gets a seeded random
``[L, 1280]`` ESM cache file, so a fit never reads all-zero embeddings.

    python -c "from gcpnet_torch.data.eq_synthetic import write_eq_decoys; print(write_eq_decoys('D'))"
"""

from __future__ import annotations

import os

import numpy as np

from gcpnet_torch.data.cath_synthetic import _place, synthetic_backbones
from gcpnet_torch.data.esm import ESM_EMBEDDING_DIM, seq_key
from gcpnet_torch.data.pdb import write_pdb

TARGETS = {"train": 48, "valid": 8, "test": 8}
DECOYS = 8  # a target's
RESIDUES = (100, 700)  # a native's, log-uniform
NOISE = (0.3, 4.0)  # a decoy's noise scale (A), log-uniform

SIDE_CHAINS = {
    "GLY": (), "ALA": ("CB",), "SER": ("CB", "OG"), "CYS": ("CB", "SG"),
    "VAL": ("CB", "CG1", "CG2"), "THR": ("CB", "OG1", "CG2"), "PRO": ("CB", "CG", "CD"),
    "ILE": ("CB", "CG1", "CG2", "CD1"), "LEU": ("CB", "CG", "CD1", "CD2"),
    "ASP": ("CB", "CG", "OD1", "OD2"), "ASN": ("CB", "CG", "OD1", "ND2"),
    "GLU": ("CB", "CG", "CD", "OE1", "OE2"), "GLN": ("CB", "CG", "CD", "OE1", "NE2"),
    "LYS": ("CB", "CG", "CD", "CE", "NZ"), "MET": ("CB", "CG", "SD", "CE"),
    "HIS": ("CB", "CG", "ND1", "CD2", "CE1", "NE2"),
    "PHE": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "TYR": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
    "TRP": ("CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
    "ARG": ("CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"),
}
RESNAMES = sorted(SIDE_CHAINS)
ONE_LETTER = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q", "GLU": "E", "GLY": "G",
    "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P", "SER": "S",
    "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}


def _native(rng: np.random.Generator, backbone: np.ndarray):
    """A chain's heavy atoms from its backbone ``[n, 4, 3]``: per atom its
    coordinates, name, residue name and residue number.  Side-chain atoms
    continue the chain N-CA-CB-... at 1.52 A and 111 degrees, with
    staggered torsions."""
    coords, names, resnames, resseqs = [], [], [], []
    for r, (n_, ca, c, o) in enumerate(backbone.astype(np.float64)):
        resname = RESNAMES[int(rng.integers(len(RESNAMES)))]
        chain = [c, n_, ca]
        atoms = [("N", n_), ("CA", ca), ("C", c), ("O", o)]
        for name in SIDE_CHAINS[resname]:
            torsion = np.radians(rng.choice([60.0, 180.0, 300.0]) + rng.normal(0.0, 10.0))
            pos = _place(chain[-3][None], chain[-2][None], chain[-1][None], 1.52, np.radians(111.0),
                         np.asarray([torsion]))[0]
            chain.append(pos)
            atoms.append((name, pos))
        for name, pos in atoms:
            coords.append(pos)
            names.append(name)
            resnames.append(resname)
            resseqs.append(r + 1)
    return np.asarray(coords, np.float32), names, resnames, resseqs


def _smooth_profile(rng: np.random.Generator, n: int) -> np.ndarray:
    """A positive profile along ``n`` residues, mean about 1: a random walk
    smoothed over ~20 residues, exponentiated."""
    walk = np.convolve(rng.normal(size=n + 40), np.ones(21) / 21.0, mode="same")[20:20 + n]
    return np.exp(2.0 * walk)


def write_eq_decoys(root: str, seed: int = 0, targets=None, decoys: int = DECOYS, residues=RESIDUES) -> dict:
    """Synthetic EQ data under ``root`` (see the module's docstring):
    ``targets`` natives per split (default TARGETS), ``decoys`` decoys
    each.  Returns the decoys per split, the atoms' and residues' mean and
    range."""
    rng = np.random.default_rng(seed)
    targets = targets or TARGETS
    dirs = {k: os.path.join(root, k) for k in ("splits", "decoy_model", "true_model", "model_data_cache/esm")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    written, atoms, lengths = {}, [], []
    for split, count in targets.items():
        n_res = np.exp(rng.uniform(*np.log(residues), size=count)).astype(int)
        names = []
        for t, backbone in enumerate(b for b, _ in synthetic_backbones(rng, n_res)):
            target = f"{split[:2]}{t:03d}"
            coords, atom_names, resnames, resseqs = _native(rng, backbone)
            chains = ["A"] * len(atom_names)
            write_pdb(os.path.join(dirs["true_model"], f"{target}.pdb"), coords, atom_names, resnames, chains,
                      resseqs)
            seq = "".join(ONE_LETTER[resnames[i]] for i in np.unique(np.asarray(resseqs), return_index=True)[1])
            np.save(os.path.join(dirs["model_data_cache/esm"], seq_key(seq) + ".npy"),
                    rng.normal(size=(len(seq), ESM_EMBEDDING_DIM)).astype(np.float32))
            res_of_atom = np.asarray(resseqs) - 1
            for k in range(decoys):
                scale = np.exp(rng.uniform(*np.log(NOISE)))
                per_res = scale * _smooth_profile(rng, len(seq))
                moved = coords + per_res[res_of_atom, None] * rng.normal(size=coords.shape) / np.sqrt(3.0)
                plddt = np.clip(100.0 * np.exp(-per_res / 2.0) + rng.normal(0.0, 5.0, size=len(seq)), 0.0, 100.0)
                name = f"{target}_d{k:02d}"
                write_pdb(os.path.join(dirs["decoy_model"], f"{name}.pdb"), moved, atom_names, resnames, chains,
                          resseqs, bfactors=plddt[res_of_atom])
                names.append(name)
            atoms.append(len(atom_names))
            lengths.append(len(seq))
        with open(os.path.join(dirs["splits"], f"{split}.lst"), "w") as f:
            f.write("".join(name + "\n" for name in names))
        written[split] = len(names)
    return {
        "decoys": written,
        "atoms": {"mean": float(np.mean(atoms)), "min": int(np.min(atoms)), "max": int(np.max(atoms))},
        "residues": {"mean": float(np.mean(lengths)), "min": int(np.min(lengths)), "max": int(np.max(lengths))},
    }
