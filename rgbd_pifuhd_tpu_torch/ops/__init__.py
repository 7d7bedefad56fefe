"""Geometry, resize, losses, and the fused field query and point MLP
(CUDA kernels + plain PyTorch versions)."""
