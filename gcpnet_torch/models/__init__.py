from gcpnet_torch.models.lba import GCPNetLBA

__all__ = ["GCPNetLBA"]
