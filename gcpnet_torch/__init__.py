"""PyTorch/CUDA port of gcpnet_tpu for NVIDIA Hopper.

The JAX package ``gcpnet_tpu`` stays the reference; this package mirrors
its layout module for module and never imports it (nor jax or flax).  The
LBA model's prediction and training step run through three hand-written
CUDA kernels (``gcpnet_torch.ops.edge_map``, forward and backward, and
``gcpnet_torch.ops.segment_sorted``); every other op is plain PyTorch.
"""

from gcpnet_torch.device import resolve_device

__all__ = ["resolve_device"]
