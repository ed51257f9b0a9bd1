"""Segment reductions and the two CUDA kernels of the forward path:
``segment_sorted`` (K1) and ``edge_map`` (K2)."""
