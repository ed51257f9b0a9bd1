"""Synthetic chains in the CATH 4.2 files that ``data.cath`` reads.

CATH 4.2 is fetched by the JAX datamodule and by nothing in this package;
where it is absent, :func:`write_cath_chains` writes chains of the same
format and size range: ``chain_set.jsonl`` (name, seq, coords keyed by
atom name), ``chain_set_splits.json`` and the two test subsets.  The
backbones have ideal bond geometry, built from (phi, psi) in helix, strand
and coil segments, and each residue is drawn from a distribution that
depends on its backbone region and its burial, so a model can recover more
than the 1 in 20 of chance.

    python -c "from gcpnet_torch.data.cath_synthetic import write_cath_chains; print(write_cath_chains('D'))"
"""

from __future__ import annotations

import json
import os

import numpy as np

CHAINS = {"train": 1000, "validation": 100, "test": 100}
CHAIN_LENGTHS = (40, 500)  # residues, log-uniform; CATH 4.2 caps chains at 500

# residue preferences of the synthetic chains: by backbone region (helix,
# strand, coil, and coil residues of positive phi) and by burial
REGIONS = {  # (phi, psi) mean, spread (degrees); segment lengths
    "helix": ((-57.0, -47.0), 7.0, (6, 18)),
    "strand": ((-120.0, 130.0), 12.0, (4, 10)),
    "coil": ((-75.0, 145.0), 25.0, (2, 8)),
}
LEFT_TURN = ((60.0, 40.0), 10.0)  # a coil residue's left-handed turn, 1 in 10
PREFERS = {"helix": "AELMQKR", "strand": "VIYFWT", "coil": "PNDSG", "left": "G"}
BURIED, EXPOSED = "AVILMFWC", "DEKRNQSTH"
AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"


def _residue_table() -> np.ndarray:
    """p(residue | region, buried) ``[4, 2, 20]``: 1 + 6 for a residue the
    region prefers (40 for glycine in a left-handed turn) + 3 for one its
    burial prefers, normalized."""
    table = np.ones((4, 2, 20))
    for r, region in enumerate(("helix", "strand", "coil", "left")):
        for aa in PREFERS[region]:
            table[r, :, AA_ORDER.index(aa)] += 40.0 if region == "left" else 6.0
        for b, prefers in enumerate((EXPOSED, BURIED)):
            for aa in prefers:
                table[r, b, AA_ORDER.index(aa)] += 3.0
    return table / table.sum(-1, keepdims=True)


def _place(a, b, c, bond: float, angle: float, torsion):
    """The atom d bonded to c at ``bond`` A, with the angle b-c-d ``angle``
    and the dihedral a-b-c-d ``torsion`` (radians), for every chain at once."""
    bc = c - b
    bc /= np.linalg.norm(bc, axis=-1, keepdims=True)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    m = np.cross(n, bc)
    return c + (-bond * np.cos(angle)) * bc + (bond * np.sin(angle) * np.cos(torsion))[:, None] * m + (
        bond * np.sin(angle) * np.sin(torsion)
    )[:, None] * n


def synthetic_backbones(rng: np.random.Generator, lengths) -> list:
    """Backbones of ideal bond geometry (N-CA 1.458, CA-C 1.525, C-N 1.329,
    C=O 1.231 A; angles 111.2, 116.2, 121.7, 120.5 degrees; omega 180) built
    from (phi, psi) in segments of helix, strand and coil (REGIONS, a
    coil residue turning left-handed 1 in 10), all chains at once.  Each
    chain: its coords ``[n, 4, 3]`` (N, CA, C, O) and region codes ``[n]``
    (0 helix, 1 strand, 2 coil, 3 left-handed)."""
    lengths = np.asarray(lengths)
    count, top = len(lengths), int(lengths.max())
    regions = np.zeros((count, top), np.int64)
    for k in range(count):
        i = 0
        while i < top:
            r = int(rng.choice(3, p=[0.4, 0.25, 0.35]))
            lo, hi = REGIONS[("helix", "strand", "coil")[r]][2]
            span = int(rng.integers(lo, hi + 1))
            regions[k, i:i + span] = r
            i += span
    regions[(regions == 2) & (rng.random(regions.shape) < 0.1)] = 3
    means = np.asarray([REGIONS[r][0] for r in ("helix", "strand", "coil")] + [LEFT_TURN[0]])
    spread = np.asarray([REGIONS[r][1] for r in ("helix", "strand", "coil")] + [LEFT_TURN[1]])
    angles = np.radians(means[regions] + spread[regions][..., None] * rng.normal(size=(count, top, 2)))
    phi, psi = angles[..., 0], angles[..., 1]
    deg = np.radians
    atoms = np.zeros((count, top, 4, 3))
    atoms[:, 0, 1] = [1.458, 0.0, 0.0]
    atoms[:, 0, 2] = atoms[:, 0, 1] + 1.525 * np.asarray([-np.cos(deg(111.2)), np.sin(deg(111.2)), 0.0])
    for i in range(top - 1):
        n_, ca, c = atoms[:, i, 0], atoms[:, i, 1], atoms[:, i, 2]
        atoms[:, i + 1, 0] = _place(n_, ca, c, 1.329, deg(116.2), psi[:, i])
        atoms[:, i + 1, 1] = _place(ca, c, atoms[:, i + 1, 0], 1.458, deg(121.7), np.full(count, np.pi))
        atoms[:, i + 1, 2] = _place(c, atoms[:, i + 1, 0], atoms[:, i + 1, 1], 1.525, deg(111.2), phi[:, i + 1])
    for i in range(top):
        atoms[:, i, 3] = _place(atoms[:, i, 0], atoms[:, i, 1], atoms[:, i, 2], 1.231, deg(120.5), psi[:, i] + np.pi)
    return [(atoms[k, :n].astype(np.float32), regions[k, :n]) for k, n in enumerate(lengths)]


def write_cath_chains(root: str, seed: int = 0, chains=None, lengths=CHAIN_LENGTHS) -> dict:
    """Synthetic CATH chains under ``root`` in the files CATHDataModule reads:
    ``chain_set.jsonl`` (name, seq, coords keyed by atom name), the splits
    (``chains``: per split, default CHAINS) and the test subsets
    (``short``: test chains of at most 100 residues; ``single_chain``: every
    other test chain).  Chains of log-uniform length in ``lengths``
    (synthetic_backbones), each residue drawn from _residue_table by its
    region and burial (more C-alpha atoms within 10 A than its chain's
    median).  Returns the chains per split and the mean length."""
    rng = np.random.default_rng(seed)
    chains = chains or CHAINS
    table = _residue_table()
    os.makedirs(root, exist_ok=True)
    names, length_of = {}, {}
    with open(os.path.join(root, "chain_set.jsonl"), "w") as f:
        for split, count in chains.items():
            n = np.exp(rng.uniform(*np.log(lengths), size=count)).astype(int)
            names[split] = []
            for k, (coords, regions) in enumerate(synthetic_backbones(rng, n)):
                ca = coords[:, 1].astype(np.float64)
                near = (np.linalg.norm(ca[:, None] - ca[None], axis=-1) < 10.0).sum(1) - 1
                buried = (near > np.median(near)).astype(int)
                p = table[regions, buried]
                seq = "".join(AA_ORDER[i] for i in (p.cumsum(-1) > rng.random((len(p), 1))).argmax(-1))
                name = f"{split}{k:04d}.A"
                names[split].append(name)
                length_of[name] = len(seq)
                coords_by_atom = {a: np.round(coords[:, i], 3).tolist() for i, a in enumerate(("N", "CA", "C", "O"))}
                f.write(json.dumps({"name": name, "seq": seq, "coords": coords_by_atom}) + "\n")
    with open(os.path.join(root, "chain_set_splits.json"), "w") as f:
        json.dump(names, f)
    test = names.get("test", [])
    with open(os.path.join(root, "test_split_L100.json"), "w") as f:
        json.dump({"test": [c for c in test if length_of[c] <= 100]}, f)
    with open(os.path.join(root, "test_split_sc.json"), "w") as f:
        json.dump({"test": test[::2]}, f)
    return {"chains": {k: len(v) for k, v in names.items()}, "mean_length": float(np.mean(list(length_of.values())))}
