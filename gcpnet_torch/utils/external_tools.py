"""Subprocess wrappers for external scoring binaries.

Port of ``gcpnet_tpu/utils/external_tools.py``: TM-score, lddt and
MolProbity run as subprocesses when their executables are configured
(``configs/paths/default.yaml``, EQ's ``lddt_exec_path``), and their output
is parsed with the JAX package's patterns.  Without a configured path the
TM-score and lDDT functions give the native scores
(``utils.structure_metrics``: ``matched_structure_scores``,
``matched_lddt``) and MolProbity gives nothing.

One deliberate difference: a configured executable that is missing, or
that prints nothing the parser reads, raises (``FileNotFoundError``,
``RuntimeError``), where the JAX functions fall back to the native scores
(or ``{}``) with a warning at most.  A label or a score from another
scorer than the one configured would pass unnoticed.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, Optional

import numpy as np

from gcpnet_torch.utils.pylogger import get_pylogger
from gcpnet_torch.utils.structure_metrics import matched_lddt, matched_structure_scores

log = get_pylogger(__name__)

TMSCORE_PATTERNS = {
    "TM-score": r"TM-score\s*=\s*([\d.]+)",
    "GDT-TS": r"GDT-TS-score\s*=\s*([\d.]+)",
    "GDT-HA": r"GDT-HA-score\s*=\s*([\d.]+)",
    "MaxSub": r"MaxSub-score\s*=\s*([\d.]+)",
    "RMSD": r"RMSD of\s+the common residues\s*=\s*([\d.]+)",
}


def configured_executable(path: Optional[str], what: str) -> Optional[str]:
    """``path`` with ``~`` expanded, ``None`` where no path is configured;
    a configured path that does not exist raises."""
    if not path:
        return None
    full = os.path.expanduser(path)
    if not os.path.exists(full):
        raise FileNotFoundError(f"{what}: the configured executable {path!r} does not exist")
    return full


def _run(args, timeout: int) -> str:
    return subprocess.run(args, capture_output=True, text=True, timeout=timeout).stdout


def parse_tmscore(out: str) -> Dict[str, float]:
    """The TM-score binary's metrics found in its output."""
    metrics = {}
    for key, pat in TMSCORE_PATTERNS.items():
        m = re.search(pat, out)
        if m:
            metrics[key] = float(m.group(1))
    return metrics


def parse_lddt(out: str) -> list:
    """The lddt binary's per-residue scores: the fifth column of each line
    of five or more fields after the first line that starts with
    ``Chain``; an unreadable score counts 0."""
    scores = []
    in_table = False
    for line in out.splitlines():
        if line.startswith("Chain"):
            in_table = True
            continue
        if in_table:
            parts = line.split()
            if len(parts) >= 5:
                try:
                    scores.append(float(parts[4]))
                except ValueError:
                    scores.append(0.0)
    return scores


def calculate_tmscore_metrics(
    pred_pdb: str, native_pdb: str, tmscore_exec_path: Optional[str] = None
) -> Dict[str, float]:
    """TM-score, GDT-TS, GDT-HA, MaxSub and RMSD of ``pred_pdb`` against
    ``native_pdb``: from the TM-score binary where one is configured, else
    native over the matched Ca atoms."""
    exe = configured_executable(tmscore_exec_path, "TM-score")
    if exe is None:
        return matched_structure_scores(pred_pdb, native_pdb)
    metrics = parse_tmscore(_run([exe, pred_pdb, native_pdb], 300))
    if not metrics:
        raise RuntimeError(f"TM-score: {tmscore_exec_path!r} printed no parseable output for {pred_pdb}")
    return metrics


def generate_lddt_score(
    pred_pdb: str, native_pdb: str, lddt_exec_path: Optional[str] = None, per_residue: bool = True,
):
    """Per-residue lDDT (or its mean with ``per_residue=False``): from the
    lddt binary where one is configured, else native over the heavy atoms
    both structures have."""
    exe = configured_executable(lddt_exec_path, "lddt")
    if exe is None:
        return matched_lddt(pred_pdb, native_pdb, per_residue=per_residue)
    scores = parse_lddt(_run([exe, pred_pdb, native_pdb], 300))
    if not scores:
        raise RuntimeError(f"lddt: {lddt_exec_path!r} printed no parseable output for {pred_pdb}")
    return np.asarray(scores) if per_residue else float(np.mean(scores))


def calculate_molprobity_metrics(pdb_path: str, molprobity_exec_path: Optional[str] = None) -> Dict[str, float]:
    """MolProbity's one-line analysis of ``pdb_path``'s directory: fields
    8, 17, 20 and 45 of the ``:``-split line that names the file.  No
    native fallback: ``{}`` where no executable is configured."""
    exe = configured_executable(molprobity_exec_path, "MolProbity")
    if exe is None:
        return {}
    out = _run([exe, os.path.dirname(pdb_path)], 600)
    stem = os.path.basename(pdb_path).split(".")[0]
    for line in out.splitlines():
        if stem in line:
            parts = line.split(":")
            try:
                return {
                    "clash_score": float(parts[8]),
                    "rotamer_outliers": float(parts[17]),
                    "ramachandran_outliers": float(parts[20]),
                    "molprobity_score": float(parts[45]),
                }
            except (IndexError, ValueError):
                continue
    raise RuntimeError(f"MolProbity: {molprobity_exec_path!r} printed no parseable line for {pdb_path}")


def amber_relax(pdb_path: str, output_path: str, **kwargs) -> bool:
    """AMBER relaxation (``utils.amber.relax.AmberRelaxation``); ``False``,
    with a warning, where OpenMM is not installed."""
    from gcpnet_torch.utils.amber.relax import AmberRelaxation

    relaxer = AmberRelaxation(**kwargs)
    try:
        return relaxer.relax_pdb(pdb_path, output_path)
    except ImportError:
        log.warning("OpenMM not available — AMBER relax skipped")
        return False
