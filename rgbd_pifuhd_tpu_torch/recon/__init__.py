"""Octree grid evaluation, marching, mesh IO and the reconstruction
pipeline."""

from .pipeline import CoarseReconstructor, Reconstructor

__all__ = ["CoarseReconstructor", "Reconstructor"]
