"""PDB cleanup before relaxation.

Port of ``gcpnet_tpu/utils/amber/cleanup.py``, numpy over the port's
``data.pdb`` structures: nonstandard-residue replacement, heterogen
removal, Se->S in MET, single-residue-chain removal, with an
``alterations_info`` record, done natively; missing heavy atoms are
detected against the standard residue tables and backbone carbonyl
oxygens rebuilt from ideal geometry.  ``clean_pdb`` hands the whole
protocol to pdbfixer where it imports, as the JAX function does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from gcpnet_torch.data.pdb import AtomRecord, Structure, parse_pdb, write_structure

# standard heavy atoms per residue (PDB chemical component dictionary)
RESIDUE_HEAVY_ATOMS: Dict[str, List[str]] = {
    "ALA": ["N", "CA", "C", "O", "CB"],
    "ARG": ["N", "CA", "C", "O", "CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "ASN": ["N", "CA", "C", "O", "CB", "CG", "OD1", "ND2"],
    "ASP": ["N", "CA", "C", "O", "CB", "CG", "OD1", "OD2"],
    "CYS": ["N", "CA", "C", "O", "CB", "SG"],
    "GLN": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "NE2"],
    "GLU": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "OE2"],
    "GLY": ["N", "CA", "C", "O"],
    "HIS": ["N", "CA", "C", "O", "CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["N", "CA", "C", "O", "CB", "CG1", "CG2", "CD1"],
    "LEU": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2"],
    "LYS": ["N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ"],
    "MET": ["N", "CA", "C", "O", "CB", "CG", "SD", "CE"],
    "PHE": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "PRO": ["N", "CA", "C", "O", "CB", "CG", "CD"],
    "SER": ["N", "CA", "C", "O", "CB", "OG"],
    "THR": ["N", "CA", "C", "O", "CB", "OG1", "CG2"],
    "TRP": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "NE1", "CE2",
            "CE3", "CZ2", "CZ3", "CH2"],
    "TYR": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2",
            "CZ", "OH"],
    "VAL": ["N", "CA", "C", "O", "CB", "CG1", "CG2"],
}

# nonstandard -> standard residue substitutions (pdbfixer's common subset;
# atom renames applied where the substituted atom differs)
NONSTANDARD_RESIDUES: Dict[str, str] = {
    "MSE": "MET",  # selenomethionine (SE -> SD)
    "SEC": "CYS",  # selenocysteine (SE -> SG)
    "HID": "HIS", "HIE": "HIS", "HIP": "HIS", "HSD": "HIS", "HSE": "HIS",
    "CSO": "CYS", "CME": "CYS", "CMT": "CYS",
    "MLY": "LYS", "KCX": "LYS",
    "SEP": "SER", "TPO": "THR", "PTR": "TYR",
    "PCA": "GLU", "GLX": "GLU", "ASX": "ASP",
}
_NONSTANDARD_ATOM_RENAMES = {
    ("MSE", "SE"): "SD",
    ("SEC", "SE"): "SG",
}


def clean_structure(
    s: Structure, alterations_info: Optional[dict] = None
) -> Structure:
    """Native analog of the reference's fix_pdb + clean_structure protocol
    (minus template-based atom addition): nonstandard-residue replacement,
    heterogen removal, Se->S in MET, single-residue-chain removal.
    Mutates ``alterations_info`` with the reference's keys."""
    info = alterations_info if alterations_info is not None else {}

    # 1) replace nonstandard residues (fix_pdb step 1)
    nonstandard = []
    atoms: List[AtomRecord] = []
    for a in s.atoms:
        a = AtomRecord(**vars(a))
        if a.resname in NONSTANDARD_RESIDUES:
            nonstandard.append((a.chain, a.resseq, a.resname))
            new_name = _NONSTANDARD_ATOM_RENAMES.get((a.resname, a.name))
            if new_name is not None:
                a.name = new_name
                a.element = new_name[0]
            a.resname = NONSTANDARD_RESIDUES[a.resname]
        atoms.append(a)
    info["nonstandard_residues"] = sorted(set(nonstandard))

    # 2) remove heterogens: any residue not in the standard table after
    # substitution (waters included) — fix_pdb step 2
    before = {a.resname for a in atoms}
    atoms = [a for a in atoms if a.resname in RESIDUE_HEAVY_ATOMS]
    info["removed_heterogens"] = sorted(
        before - {a.resname for a in atoms}
    )

    # 3) Se -> S in MET residues that slipped through unmarked
    # (clean_structure._replace_met_se)
    se_in_met = []
    for a in atoms:
        if a.resname == "MET" and a.name == "SD" and a.element.upper() == "SE":
            a.element = "S"
            se_in_met.append(a.resseq)
    info["Se_in_MET"] = se_in_met

    # 4) drop chains with a single residue (no N+C-terminus force template,
    # clean_structure._remove_chains_of_length_one)
    res_per_chain: Dict[str, set] = {}
    for a in atoms:
        res_per_chain.setdefault(a.chain, set()).add((a.resseq, a.icode))
    removed = sorted(c for c, r in res_per_chain.items() if len(r) <= 1)
    atoms = [a for a in atoms if a.chain not in removed]
    info["removed_chains"] = {0: removed}

    return Structure(atoms=atoms)


def find_missing_heavy_atoms(s: Structure) -> Dict[tuple, List[str]]:
    """Missing heavy atoms per residue vs the standard tables (the
    detection half of pdbfixer's findMissingAtoms).  Terminal OXT is not
    required."""
    present: Dict[tuple, set] = {}
    resname: Dict[tuple, str] = {}
    for a in s.atoms:
        rid = (a.chain, a.resseq, a.icode)
        present.setdefault(rid, set()).add(a.name)
        resname[rid] = a.resname
    missing = {}
    for rid, names in present.items():
        want = RESIDUE_HEAVY_ATOMS.get(resname[rid])
        if want is None:
            continue
        m = [n for n in want if n not in names]
        if m:
            missing[rid] = m
    return missing


def rebuild_backbone_oxygens(s: Structure) -> Tuple[Structure, List[tuple]]:
    """Add missing backbone carbonyl O atoms from ideal sp2 geometry:
    O lies in the CA-C-N(next) plane, 1.229 A from C, bisecting the
    angle opposite to CA and N(next).  (The most common heavy-atom gap in
    decoys; sidechain completion needs pdbfixer's rotamer templates.)"""
    res_idx = s.residue_index()
    num_res = int(res_idx.max()) + 1 if len(s.atoms) else 0
    table = {n: np.full(num_res, -1, dtype=np.int64) for n in ("N", "CA", "C", "O")}
    chain = [""] * num_res
    last_atom_of_res = np.zeros(num_res, dtype=np.int64)
    for i, a in enumerate(s.atoms):
        r = int(res_idx[i])
        chain[r] = a.chain
        last_atom_of_res[r] = i
        if a.name in table and table[a.name][r] < 0:
            table[a.name][r] = i

    coords = s.coords.astype(np.float64)
    added = []
    new_atoms = list(s.atoms)
    inserts: List[Tuple[int, AtomRecord]] = []
    for r in range(num_res - 1):
        if table["O"][r] >= 0:
            continue
        c_i, ca_i, n_next = table["C"][r], table["CA"][r], table["N"][r + 1]
        if c_i < 0 or ca_i < 0 or n_next < 0 or chain[r] != chain[r + 1]:
            continue
        c, ca, n = coords[c_i], coords[ca_i], coords[n_next]
        u = (c - ca) / (np.linalg.norm(c - ca) + 1e-9)
        v = (c - n) / (np.linalg.norm(c - n) + 1e-9)
        d = u + v
        d = d / (np.linalg.norm(d) + 1e-9)
        o = c + 1.229 * d
        proto = s.atoms[c_i]
        rec = AtomRecord(
            serial=0, name="O", altloc="", resname=proto.resname,
            chain=proto.chain, resseq=proto.resseq, icode=proto.icode,
            x=float(o[0]), y=float(o[1]), z=float(o[2]),
            occupancy=1.0, bfactor=proto.bfactor, element="O",
        )
        inserts.append((int(last_atom_of_res[r]), rec))
        added.append((proto.chain, proto.resseq))
    for pos, rec in sorted(inserts, key=lambda t: -t[0]):
        new_atoms.insert(pos + 1, rec)
    for i, a in enumerate(new_atoms):
        a.serial = i + 1
    return Structure(atoms=new_atoms), added


def clean_pdb(
    in_path: str, out_path: str, alterations_info: Optional[dict] = None
) -> str:
    """Full cleanup entry: pdbfixer (template atom completion + hydrogens)
    when importable, else the native protocol above."""
    info = alterations_info if alterations_info is not None else {}
    try:
        import pdbfixer  # noqa: F401
        from openmm.app import PDBFile

        fixer = pdbfixer.PDBFixer(filename=in_path)
        fixer.findNonstandardResidues()
        info["nonstandard_residues"] = fixer.nonstandardResidues
        fixer.replaceNonstandardResidues()
        fixer.removeHeterogens(keepWater=False)
        fixer.findMissingResidues()
        info["missing_residues"] = fixer.missingResidues
        fixer.findMissingAtoms()
        info["missing_heavy_atoms"] = fixer.missingAtoms
        fixer.addMissingAtoms(seed=0)
        fixer.addMissingHydrogens()
        with open(out_path, "w") as f:
            PDBFile.writeFile(fixer.topology, fixer.positions, f, keepIds=True)
        return out_path
    except ImportError:
        pass

    s = parse_pdb(in_path, heavy_only=True, skip_altloc=True)
    s = clean_structure(s, info)
    s, added_o = rebuild_backbone_oxygens(s)
    info["rebuilt_backbone_oxygens"] = added_o
    info["missing_heavy_atoms"] = find_missing_heavy_atoms(s)
    write_structure(out_path, s)
    return out_path
