from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.models.nms import GCPNetNMS

__all__ = ["GCPNetLBA", "GCPNetNMS"]
