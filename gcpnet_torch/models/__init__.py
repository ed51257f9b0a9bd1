from gcpnet_torch.models.ar import GCPNetAR, ar_loss
from gcpnet_torch.models.cpd import GCPNetCPD
from gcpnet_torch.models.eq import GCPNetEQ, eq_loss
from gcpnet_torch.models.lba import GCPNetLBA, GCPNetPSR, graph_regression_loss
from gcpnet_torch.models.nms import GCPNetNMS
from gcpnet_torch.models.rs import GCPNetRS

__all__ = ["GCPNetAR", "GCPNetCPD", "GCPNetEQ", "GCPNetLBA", "GCPNetNMS", "GCPNetPSR", "GCPNetRS", "ar_loss", "eq_loss", "graph_regression_loss"]
