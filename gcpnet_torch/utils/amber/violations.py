"""Structural-violation metrics (no force-field dependency).

Port of ``gcpnet_tpu/utils/amber/violations.py``, over the port's
``data.pdb`` structures (the published protocol of Jumper et al. 2021,
Suppl. 1.9.11, eq. 44-46):

* between-residue peptide-bond length + angle violations at 12 sigma of
  the PDB distributions (with the proline C-N special case),
* extreme CA-CA distance violations (> 1.5 A beyond the 3.8 A ideal),
* between-residue steric clashes by van-der-Waals overlap (1.5 A
  tolerance), exempting the bonded peptide C(i)-N(i+1) pair (same chain,
  directed) and disulfide SG-SG,
* per-residue violation masks driving the iterative restrained-relax loop.

The bond and CA-CA checks are numpy, as in the JAX module.  The clash
check is the JAX arithmetic (float64 distances, the same bounds and
exemptions) in torch on an explicit device, the card by default, in
blocks of ``CLASH_BLOCK_ROWS`` atoms against all: the JAX function builds
dense ``[n_atoms, n_atoms]`` float64 arrays (1.5 GB each at 13,600 atoms),
this one never more than a block's rows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch

from gcpnet_torch.data.pdb import Structure
from gcpnet_torch.device import DeviceLike, resolve_device

# PDB-statistics constants (Jumper et al. 2021; reference
# residue_constants.py:29,392-397)
CA_CA = 3.80209737096
C_N_LENGTH = (1.329, 1.341)  # (general, pre-proline)
C_N_STDDEV = (0.014, 0.016)
COS_CA_C_N = (-0.5203, 0.0353)
COS_C_N_CA = (-0.4473, 0.0311)
TOLERANCE_FACTOR = 12.0
CA_CA_TOLERANCE = 1.5

VDW_RADII = {"C": 1.7, "N": 1.55, "O": 1.52, "S": 1.8, "P": 1.8, "H": 1.2}
CLASH_OVERLAP_TOL = 1.5


def _backbone_table(s: Structure):
    """Per-residue indices of N/CA/C atoms plus residue names and gap info."""
    res_idx = s.residue_index()
    num_res = int(res_idx.max()) + 1 if len(s.atoms) else 0
    table = {name: np.full(num_res, -1, dtype=np.int64) for name in ("N", "CA", "C")}
    resnames = [""] * num_res
    resseqs = np.zeros(num_res, dtype=np.int64)
    chains = [""] * num_res
    for i, atom in enumerate(s.atoms):
        r = int(res_idx[i])
        resnames[r] = atom.resname
        resseqs[r] = atom.resseq
        chains[r] = atom.chain
        if atom.name in table and table[atom.name][r] < 0:
            table[atom.name][r] = i
    return res_idx, num_res, table, resnames, resseqs, chains


def _consecutive_mask(resseqs, chains) -> np.ndarray:
    """True where residue i+1 directly follows residue i on the same chain."""
    if len(resseqs) < 2:
        return np.zeros(0, dtype=bool)
    same_chain = np.asarray(
        [chains[i] == chains[i + 1] for i in range(len(chains) - 1)]
    )
    return same_chain & (np.diff(resseqs) == 1)


def between_residue_bond_violations(s: Structure) -> Dict[str, np.ndarray]:
    """Peptide-bond length + angle hard violations at 12 sigma (eq. 44-45)."""
    coords = s.coords.astype(np.float64)
    _, num_res, bb, resnames, resseqs, chains = _backbone_table(s)
    per_res = np.zeros(num_res, dtype=bool)
    if num_res < 2:
        return {"per_residue_violation_mask": per_res}

    consec = _consecutive_mask(resseqs, chains)
    this_ca, this_c = bb["CA"][:-1], bb["C"][:-1]
    next_n, next_ca = bb["N"][1:], bb["CA"][1:]
    have = (this_c >= 0) & (next_n >= 0) & consec

    pair_viol = np.zeros(num_res - 1, dtype=bool)
    idx = np.where(have)[0]
    if idx.size:
        c_pos = coords[this_c[idx]]
        n_pos = coords[next_n[idx]]
        d_cn = np.linalg.norm(c_pos - n_pos, axis=-1)
        next_is_pro = np.asarray(
            [resnames[i + 1] == "PRO" for i in idx], dtype=bool
        )
        gt = np.where(next_is_pro, C_N_LENGTH[1], C_N_LENGTH[0])
        sd = np.where(next_is_pro, C_N_STDDEV[1], C_N_STDDEV[0])
        pair_viol[idx] |= np.abs(d_cn - gt) > TOLERANCE_FACTOR * sd

        # CA-C-N angle (around C)
        ok = this_ca[idx] >= 0
        if ok.any():
            sub = idx[ok]
            ca_pos = coords[bb["CA"][sub]]
            c_pos2 = coords[bb["C"][sub]]
            n_pos2 = coords[bb["N"][sub + 1]]
            v1 = ca_pos - c_pos2
            v2 = n_pos2 - c_pos2
            cos = np.sum(v1 * v2, axis=-1) / (
                np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9
            )
            pair_viol[sub] |= (
                np.abs(cos - COS_CA_C_N[0]) > TOLERANCE_FACTOR * COS_CA_C_N[1]
            )
        # C-N-CA angle (around N)
        ok = next_ca[idx] >= 0
        if ok.any():
            sub = idx[ok]
            c_pos2 = coords[bb["C"][sub]]
            n_pos2 = coords[bb["N"][sub + 1]]
            ca_pos2 = coords[bb["CA"][sub + 1]]
            v1 = c_pos2 - n_pos2
            v2 = ca_pos2 - n_pos2
            cos = np.sum(v1 * v2, axis=-1) / (
                np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9
            )
            pair_viol[sub] |= (
                np.abs(cos - COS_C_N_CA[0]) > TOLERANCE_FACTOR * COS_C_N_CA[1]
            )

    # a pair violation marks both participating residues
    per_res[:-1] |= pair_viol
    per_res[1:] |= pair_viol
    return {"per_residue_violation_mask": per_res}


def extreme_ca_ca_fraction(s: Structure) -> float:
    """Fraction of consecutive CA-CA pairs > 1.5 A beyond the 3.8 A ideal."""
    coords = s.coords.astype(np.float64)
    _, num_res, bb, _, resseqs, chains = _backbone_table(s)
    if num_res < 2:
        return 0.0
    consec = _consecutive_mask(resseqs, chains)
    have = (bb["CA"][:-1] >= 0) & (bb["CA"][1:] >= 0) & consec
    if not have.any():
        return 0.0
    d = np.linalg.norm(
        coords[bb["CA"][:-1][have]] - coords[bb["CA"][1:][have]], axis=-1
    )
    return float(np.mean((d - CA_CA) > CA_CA_TOLERANCE))


# rows of atoms a block of the clash check holds against every atom
CLASH_BLOCK_ROWS = 1024


def clash_operands(s: Structure) -> Dict[str, np.ndarray]:
    """Per-atom arrays of the clash check: float64 positions, vdW radii,
    dense residue ids, residue numbers, chain ids and the C, N and
    cysteine-SG flags."""
    names = [a.name for a in s.atoms]
    chain_ids = {c: k for k, c in enumerate({a.chain for a in s.atoms})}
    return {
        "coords": s.coords.astype(np.float64),
        "radii": np.asarray([VDW_RADII.get(e, 1.7) for e in s.elements], dtype=np.float64),
        "res_idx": s.residue_index().astype(np.int64),
        "resseq": np.asarray([a.resseq for a in s.atoms], dtype=np.int64),
        "chain": np.asarray([chain_ids[a.chain] for a in s.atoms], dtype=np.int64),
        "is_c": np.asarray([n == "C" for n in names]),
        "is_n": np.asarray([n == "N" for n in names]),
        "is_sg": np.asarray([a.name == "SG" and a.resname == "CYS" for a in s.atoms]),
    }


def between_residue_clashes(
    s: Structure, device: DeviceLike = None, block_rows: int = CLASH_BLOCK_ROWS
) -> Dict[str, np.ndarray]:
    """Van-der-Waals overlap clashes between atoms of different residues,
    on ``device`` (the card by default), ``block_rows`` atoms at a time.

    Bonded inter-residue pairs are exempt: the peptide C(i)-N(i+1) bond
    (directed, sequence-consecutive, same chain: C(i) against N(i-1), or a
    C/N contact across chains at adjacent residue numbers, is a clash) and
    cysteine SG-SG disulfides.
    """
    n_atoms = len(s.atoms)
    clash_atom = np.zeros(n_atoms, dtype=bool)
    if n_atoms < 2:
        return {"per_atom_clash_mask": clash_atom}
    dev = resolve_device(device)
    t = {k: torch.as_tensor(v, device=dev) for k, v in clash_operands(s).items()}
    x, y, z = t["coords"].unbind(-1)
    out = torch.empty(n_atoms, dtype=torch.bool, device=dev)
    for lo in range(0, n_atoms, block_rows):
        hi = min(lo + block_rows, n_atoms)
        rows = slice(lo, hi)
        dx = x[rows, None] - x[None, :]
        dy = y[rows, None] - y[None, :]
        dz = z[rows, None] - z[None, :]
        # the JAX sum over the last axis of three, in its order
        d2 = dx * dx
        d2 = d2 + dy * dy
        d2 = d2 + dz * dz
        dist = torch.sqrt(d2 + 1e-12)
        lower_bound = t["radii"][rows, None] + t["radii"][None, :] - CLASH_OVERLAP_TOL
        different_res = t["res_idx"][rows, None] != t["res_idx"][None, :]
        same_chain = t["chain"][rows, None] == t["chain"][None, :]
        c_to_n = t["is_c"][rows, None] & t["is_n"][None, :] & (t["resseq"][None, :] == t["resseq"][rows, None] + 1)
        n_to_c = t["is_n"][rows, None] & t["is_c"][None, :] & (t["resseq"][rows, None] == t["resseq"][None, :] + 1)
        peptide = (c_to_n | n_to_c) & same_chain
        disulfide = t["is_sg"][rows, None] & t["is_sg"][None, :]
        clash = (dist < lower_bound) & different_res & ~peptide & ~disulfide
        clash[torch.arange(hi - lo, device=dev), torch.arange(lo, hi, device=dev)] = False
        out[rows] = clash.any(dim=1)
    return {"per_atom_clash_mask": out.cpu().numpy()}


def find_violations(s: Structure, device: DeviceLike = None) -> Dict[str, object]:
    """All violation families + the per-residue mask driving relax
    exclusions; the clash check on ``device`` (the card by default)."""
    res_idx = s.residue_index()
    num_res = int(res_idx.max()) + 1 if len(s.atoms) else 0

    bond = between_residue_bond_violations(s)
    clash = between_residue_clashes(s, device)

    res_clash = np.zeros(num_res, dtype=bool)
    for i, r in enumerate(res_idx):
        if clash["per_atom_clash_mask"][i]:
            res_clash[int(r)] = True

    total_mask = bond["per_residue_violation_mask"] | res_clash
    residue_violations: List[int] = [int(i) for i in np.where(total_mask)[0]]

    return {
        "violations_extreme_ca_ca_distance": extreme_ca_ca_fraction(s),
        "violations_between_residue_bond": (
            float(bond["per_residue_violation_mask"].mean()) if num_res else 0.0
        ),
        "violations_between_residue_clash": (
            float(res_clash.mean()) if num_res else 0.0
        ),
        "violations_per_residue": (
            float(total_mask.mean()) if num_res else 0.0
        ),
        "num_residue_violations": float(total_mask.sum()),
        "residue_violations": residue_violations,
        "per_residue_violation_mask": total_mask,
        "per_atom_clash_mask": clash["per_atom_clash_mask"],
    }


def structural_violations(s: Structure, device: DeviceLike = None) -> Dict[str, float]:
    """Summary metrics (scalar-only view of :func:`find_violations`)."""
    v = find_violations(s, device)
    return {
        k: float(val)
        for k, val in v.items()
        if isinstance(val, (int, float, np.floating))
    }
