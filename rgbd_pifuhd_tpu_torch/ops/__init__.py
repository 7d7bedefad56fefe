"""Geometry, resize, and the fused field query (CUDA kernel + plain
PyTorch version)."""
