from gcpnet_torch.data.batching import Bucket, collate_shards, sort_edges_by_receiver

__all__ = ["Bucket", "collate_shards", "sort_edges_by_receiver"]
