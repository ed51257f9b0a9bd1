from gcpnet_torch.models.lba import GCPNetLBA
from gcpnet_torch.models.nms import GCPNetNMS
from gcpnet_torch.models.rs import GCPNetRS

__all__ = ["GCPNetLBA", "GCPNetNMS", "GCPNetRS"]
