"""Pure-Python PDB parsing and writing.

The port's copy of ``gcpnet_tpu/data/pdb.py``: the fixed-column PDB
format read and written directly (EQ's decoys and natives, and the
b-factor annotation writer of EQ's predictions), with no structure
library.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class AtomRecord:
    serial: int
    name: str
    altloc: str
    resname: str
    chain: str
    resseq: int
    icode: str
    x: float
    y: float
    z: float
    occupancy: float
    bfactor: float
    element: str


@dataclasses.dataclass
class Structure:
    atoms: List[AtomRecord]

    @property
    def coords(self) -> np.ndarray:
        return np.asarray(
            [[a.x, a.y, a.z] for a in self.atoms], dtype=np.float32
        )

    @property
    def elements(self) -> List[str]:
        return [a.element for a in self.atoms]

    def residue_ids(self) -> List[tuple]:
        """(chain, resseq, icode) per atom."""
        return [(a.chain, a.resseq, a.icode) for a in self.atoms]

    def residue_index(self) -> np.ndarray:
        """Dense 0-based residue index per atom (order of first appearance)."""
        seen: Dict[tuple, int] = {}
        out = np.empty(len(self.atoms), dtype=np.int32)
        for i, rid in enumerate(self.residue_ids()):
            if rid not in seen:
                seen[rid] = len(seen)
            out[i] = seen[rid]
        return out

    def ca_indices(self) -> np.ndarray:
        return np.asarray(
            [i for i, a in enumerate(self.atoms) if a.name == "CA"],
            dtype=np.int32,
        )


def _parse_atom_line(line: str, serial_fallback: int) -> Optional[AtomRecord]:
    try:
        name = line[12:16].strip()
        element = line[76:78].strip() if len(line) >= 78 else ""
        if not element:
            element = "".join(c for c in name if c.isalpha())[:1]
        return AtomRecord(
            serial=int(line[6:11]) if line[6:11].strip() else serial_fallback,
            name=name,
            altloc=line[16].strip(),
            resname=line[17:20].strip(),
            chain=line[21].strip() or "A",
            resseq=int(line[22:26]) if line[22:26].strip() else 0,
            icode=line[26].strip(),
            x=float(line[30:38]),
            y=float(line[38:46]),
            z=float(line[46:54]),
            occupancy=float(line[54:60]) if line[54:60].strip() else 1.0,
            bfactor=float(line[60:66]) if line[60:66].strip() else 0.0,
            element=element.capitalize(),
        )
    except (ValueError, IndexError):
        return None


def parse_pdb(
    path: str,
    model: int = 1,
    heavy_only: bool = False,
    skip_altloc: bool = True,
) -> Structure:
    """Parse ATOM records from a PDB file (first model by default)."""
    opener = gzip.open if path.endswith(".gz") else open
    atoms: List[AtomRecord] = []
    # model selection is by ordinal (1 = first MODEL record encountered),
    # since PDBs in the wild number models from 0 or 1
    model_ordinal = 1
    with opener(path, "rt") as f:
        for i, line in enumerate(f):
            if line.startswith("MODEL"):
                if atoms:  # new model after we already collected the target
                    break
                continue
            if line.startswith("ENDMDL"):
                if model_ordinal >= model and atoms:
                    break
                model_ordinal += 1
                continue
            if model_ordinal != model:
                continue
            if not line.startswith("ATOM"):
                continue
            rec = _parse_atom_line(line, len(atoms) + 1)
            if rec is None:
                continue
            if skip_altloc and rec.altloc not in ("", "A"):
                continue
            if heavy_only and rec.element == "H":
                continue
            atoms.append(rec)
    return Structure(atoms)


def write_pdb(
    path: str,
    coords: np.ndarray,
    atom_names: Sequence[str],
    resnames: Sequence[str],
    chains: Sequence[str],
    resseqs: Sequence[int],
    elements: Optional[Sequence[str]] = None,
    bfactors: Optional[np.ndarray] = None,
):
    """Write one-model PDB ATOM records (reference
    write_residue_atom_positions_as_pdb, src/models/__init__.py:202-218)."""
    coords = np.asarray(coords)
    n = coords.shape[0]
    bfactors = (
        np.zeros(n) if bfactors is None else np.asarray(bfactors, dtype=float)
    )
    elements = elements or [
        "".join(c for c in name if c.isalpha())[:1] for name in atom_names
    ]
    with open(path, "w") as f:
        for i in range(n):
            name = atom_names[i]
            pad_name = f" {name:<3s}" if len(name) < 4 else name
            f.write(
                f"ATOM  {i + 1:5d} {pad_name:<4s}{'':1s}{resnames[i]:<3s} "
                f"{chains[i]:1s}{resseqs[i]:4d}{'':1s}   "
                f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}{coords[i, 2]:8.3f}"
                f"{1.0:6.2f}{bfactors[i]:6.2f}          "
                f"{elements[i].upper():>2s}\n"
            )
        f.write("END\n")


def write_structure(path: str, s: Structure, bfactors=None, coords=None):
    write_pdb(
        path,
        s.coords if coords is None else coords,
        [a.name for a in s.atoms],
        [a.resname for a in s.atoms],
        [a.chain for a in s.atoms],
        [a.resseq for a in s.atoms],
        elements=[a.element for a in s.atoms],
        bfactors=bfactors,
    )


def annotate_pdb_bfactor_column(
    in_path: str, out_path: str, per_residue_values: Dict[tuple, float]
):
    """Rewrite a PDB with per-residue b-factor values (reference
    annotate_pdb_with_new_column_values, src/models/__init__.py:222-236)."""
    s = parse_pdb(in_path)
    bf = np.asarray(
        [
            per_residue_values.get((a.chain, a.resseq, a.icode), a.bfactor)
            for a in s.atoms
        ]
    )
    write_structure(out_path, s, bfactors=bf)
