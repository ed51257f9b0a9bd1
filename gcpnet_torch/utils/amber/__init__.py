"""AMBER cleanup, structural violations and the OpenMM relaxation: the
port of ``gcpnet_tpu/utils/amber/``."""

from gcpnet_torch.utils.amber.relax import AmberRelaxation
from gcpnet_torch.utils.amber.violations import structural_violations

__all__ = ["AmberRelaxation", "structural_violations"]
