"""Task model registry: the port's copy of ``gcpnet_tpu/models/__init__.py``.

``MODEL_REGISTRY`` maps the registry names and the reference's
``_target_`` strings of ``configs/model/gcpnet_*.yaml`` to the port's model
classes; ``LOSS_REGISTRY`` maps a registry name to its loss.
"""

from gcpnet_torch.models.ar import GCPNetAR, ar_loss
from gcpnet_torch.models.cpd import GCPNetCPD, cpd_loss
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.models.lba import GCPNetLBA, GCPNetPSR, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS, nms_loss
from gcpnet_torch.models.rs import GCPNetRS, rs_loss

MODEL_REGISTRY = {
    "GCPNetLBA": GCPNetLBA,
    "GCPNetPSR": GCPNetPSR,
    "GCPNetCPD": GCPNetCPD,
    "GCPNetNMS": GCPNetNMS,
    "GCPNetRS": GCPNetRS,
    "GCPNetEQ": GCPNetEQ,
    "GCPNetAR": GCPNetAR,
    # the reference's _target_ strings
    "src.models.gcpnet_lba_module.GCPNetLBALitModule": GCPNetLBA,
    "src.models.gcpnet_psr_module.GCPNetPSRLitModule": GCPNetPSR,
    "src.models.gcpnet_cpd_module.GCPNetCPDLitModule": GCPNetCPD,
    "src.models.gcpnet_nms_module.GCPNetNMSLitModule": GCPNetNMS,
    "src.models.gcpnet_rs_module.GCPNetRSLitModule": GCPNetRS,
    "src.models.gcpnet_eq_module.GCPNetEQLitModule": GCPNetEQ,
    "src.models.gcpnet_ar_module.GCPNetARLitModule": GCPNetAR,
}

LOSS_REGISTRY = {
    "GCPNetLBA": graph_regression_loss,
    "GCPNetPSR": graph_regression_loss,
    "GCPNetCPD": cpd_loss,
    "GCPNetNMS": nms_loss,
    "GCPNetRS": rs_loss,
    "GCPNetEQ": eq_loss,
    "GCPNetAR": ar_loss,
}

__all__ = [
    "GCPNetAR", "GCPNetCPD", "GCPNetEQ", "GCPNetLBA", "GCPNetNMS", "GCPNetPSR", "GCPNetRS", "LOSS_REGISTRY",
    "MODEL_REGISTRY", "ar_loss", "cpd_loss", "eq_loss", "graph_regression_loss", "nms_loss", "rs_loss",
]
