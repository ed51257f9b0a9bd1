"""AMBER relaxation (OpenMM-gated).

Port of ``gcpnet_tpu/utils/amber/relax.py``: restrained L-BFGS
minimization under amber99sb with iterative violation checks, run when
OpenMM is importable (it is imported inside ``_minimize_once``); without
it ``relax_pdb`` raises ImportError after the cleanup, so that callers
(``utils.external_tools.amber_relax``) can skip.  Violation metrics are
native either way (``utils.amber.violations``), their clash check on
``device`` (the card by default).
"""

from __future__ import annotations

import os
from typing import Dict

from gcpnet_torch.data.pdb import parse_pdb
from gcpnet_torch.device import DeviceLike
from gcpnet_torch.utils.amber.cleanup import clean_pdb
from gcpnet_torch.utils.amber.violations import find_violations, structural_violations
from gcpnet_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)

# reference relax constants (src/models/__init__.py:31-35)
MAX_ITERATIONS = 0  # 0 = unlimited L-BFGS iterations
TOLERANCE = 2.39  # kcal/mol
STIFFNESS = 10.0  # kcal/mol A^2 restraint on heavy atoms
MAX_OUTER_ITERATIONS = 3


class AmberRelaxation:
    def __init__(
        self,
        max_iterations: int = MAX_ITERATIONS,
        tolerance: float = TOLERANCE,
        stiffness: float = STIFFNESS,
        max_outer_iterations: int = MAX_OUTER_ITERATIONS,
        device: DeviceLike = None,
    ):
        self.max_iterations = max_iterations
        self.device = device
        self.tolerance = tolerance
        self.stiffness = stiffness
        self.max_outer_iterations = max_outer_iterations

    def _minimize_once(
        self, pdb_path: str, output_path: str, exclude_residues
    ) -> dict:
        """One restrained L-BFGS minimization (reference _openmm_minimize,
        amber_minimize.py:75-111): harmonic restraints on every heavy atom
        except those of ``exclude_residues`` (0-based dense residue ids)."""
        import openmm
        from openmm import app, unit

        pdb = app.PDBFile(pdb_path)
        forcefield = app.ForceField("amber99sb.xml")
        modeller = app.Modeller(pdb.topology, pdb.positions)
        modeller.addHydrogens(forcefield)
        system = forcefield.createSystem(
            modeller.topology, constraints=app.HBonds
        )

        force = openmm.CustomExternalForce(
            "0.5 * k * ((x-x0)^2 + (y-y0)^2 + (z-z0)^2)"
        )
        force.addGlobalParameter(
            "k",
            self.stiffness
            * unit.kilocalories_per_mole
            / (unit.angstroms**2),
        )
        for p in ("x0", "y0", "z0"):
            force.addPerParticleParameter(p)
        residue_order: dict = {}
        for atom in modeller.topology.atoms():
            rid = (atom.residue.chain.id, atom.residue.id)
            residue_order.setdefault(rid, len(residue_order))
        for i, atom in enumerate(modeller.topology.atoms()):
            rid = residue_order[(atom.residue.chain.id, atom.residue.id)]
            if atom.element.name != "hydrogen" and rid not in exclude_residues:
                force.addParticle(i, modeller.positions[i])
        system.addForce(force)

        integrator = openmm.LangevinIntegrator(0, 0.01, 0.0)
        simulation = app.Simulation(modeller.topology, system, integrator)
        simulation.context.setPositions(modeller.positions)
        einit = simulation.context.getState(
            getEnergy=True
        ).getPotentialEnergy().value_in_unit(unit.kilocalories_per_mole)
        simulation.minimizeEnergy(
            maxIterations=self.max_iterations,
            tolerance=self.tolerance
            * unit.kilocalories_per_mole
            / unit.nanometer,
        )
        state = simulation.context.getState(
            getPositions=True, getEnergy=True
        )
        efinal = state.getPotentialEnergy().value_in_unit(
            unit.kilocalories_per_mole
        )
        with open(output_path, "w") as f:
            app.PDBFile.writeFile(simulation.topology, state.getPositions(), f)
        return {"einit": float(einit), "efinal": float(efinal)}

    def relax_pdb(self, pdb_path: str, output_path: str) -> bool:
        """Iterative violation-driven restrained relaxation (reference
        run_pipeline, amber_minimize.py:923-1002): each iteration minimizes
        with restraints excluding residues that participated in violations
        so far, then recomputes violations; stops early once clean."""
        tmp_clean = output_path + ".clean.pdb"
        clean_pdb(pdb_path, tmp_clean)

        exclude: set = set()
        current = tmp_clean
        info: dict = {}
        for iteration in range(self.max_outer_iterations):
            info = self._minimize_once(current, output_path, exclude)
            violations = find_violations(
                parse_pdb(output_path, heavy_only=True), self.device
            )
            info.update(
                iteration=iteration,
                num_exclusions=len(exclude),
                **{
                    k: v
                    for k, v in violations.items()
                    if not hasattr(v, "shape") or getattr(v, "ndim", 1) == 0
                },
            )
            log.info(
                "relax iteration %d: Einit %.2f Efinal %.2f, "
                "%d residue violations, %d exclusions",
                iteration, info["einit"], info["efinal"],
                int(violations["num_residue_violations"]), len(exclude),
            )
            exclude |= set(violations["residue_violations"])
            current = output_path
            if not violations["residue_violations"]:
                break
        os.remove(tmp_clean)
        self.last_info = info
        return True

    @staticmethod
    def violation_metrics(pdb_path: str, device: DeviceLike = None) -> Dict[str, float]:
        return structural_violations(parse_pdb(pdb_path, heavy_only=True), device)
