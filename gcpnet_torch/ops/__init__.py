"""Segment reductions and the three CUDA kernels: ``segment_sorted`` (K1),
``edge_map`` (K2, and its backward K3, behind autograd)."""
