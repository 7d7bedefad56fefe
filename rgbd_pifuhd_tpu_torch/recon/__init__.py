"""Octree grid evaluation, marching, mesh IO and the reconstruction
pipeline."""
