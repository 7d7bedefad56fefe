"""Watertight point-in-mesh test (port of ``data/containment.py``).

+z ray casting with a 2D
(x, y) uniform-grid acceleration structure — triangles are binned by their
xy bounding boxes; each query point only intersects triangles in its bin.
Crossing-parity (odd = inside) is robust for watertight meshes.  The bins
are built as the JAX package builds them; the per-point parity loop, which
the JAX package runs in NumPy, runs in ``native/containment.cc`` (the same
float64 operations, so the same answers, tens of times faster).
"""

from __future__ import annotations

import numpy as np


class MeshContainmentTester:
    """Build once per mesh; query many point batches."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 grid_res: int = 64):
        self.v = np.asarray(verts, dtype=np.float64)
        self.f = np.asarray(faces, dtype=np.int64)
        tri = self.v[self.f]                      # [F, 3, 3]
        self.tri = tri
        self.lo = tri[:, :, :2].min(axis=1)       # [F, 2]
        self.hi = tri[:, :, :2].max(axis=1)
        self.bb_min = self.v.min(axis=0)
        self.bb_max = self.v.max(axis=0)
        self.grid_res = grid_res
        span = np.maximum(self.bb_max[:2] - self.bb_min[:2], 1e-9)
        self.cell = span / grid_res

        # bin triangle ids by covered cells
        lo_c = np.clip(((self.lo - self.bb_min[:2]) / self.cell).astype(int),
                       0, grid_res - 1)
        hi_c = np.clip(((self.hi - self.bb_min[:2]) / self.cell).astype(int),
                       0, grid_res - 1)
        bins: list[list[int]] = [[] for _ in range(grid_res * grid_res)]
        for t in range(len(self.f)):
            for cx in range(lo_c[t, 0], hi_c[t, 0] + 1):
                for cy in range(lo_c[t, 1], hi_c[t, 1] + 1):
                    bins[cx * grid_res + cy].append(t)
        self.bins = [np.asarray(b, dtype=np.int64) for b in bins]
        self._ids = None

    def contains(self, points: np.ndarray) -> np.ndarray:
        """[N, 3] -> bool[N]: odd +z-ray crossing parity
        (``native/containment.cc``)."""
        import ctypes

        from ..native import load_containment

        lib = load_containment()
        if self._ids is None:           # the bins, flattened once
            self._start = np.zeros(len(self.bins) + 1, np.int64)
            self._start[1:] = np.cumsum([len(b) for b in self.bins])
            self._ids = np.ascontiguousarray(np.concatenate(
                self.bins + [np.zeros(0, np.int64)]), np.int64)
            self._tri = np.ascontiguousarray(self.tri, np.float64)
        pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
        out = np.zeros(len(pts), np.uint8)
        dp = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        box = [np.ascontiguousarray(x, np.float64)
               for x in (self.bb_min, self.bb_max, self.cell)]
        rc = lib.contains_points(
            pts.ctypes.data_as(dp), len(pts), self._tri.ctypes.data_as(dp),
            self._start.ctypes.data_as(i64p), self._ids.ctypes.data_as(i64p),
            *[x.ctypes.data_as(dp) for x in box], self.grid_res,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0)
        if rc != 0:
            raise RuntimeError(f"contains_points failed (rc={rc})")
        return out.astype(bool)


def points_in_mesh(points: np.ndarray, verts: np.ndarray,
                   faces: np.ndarray) -> np.ndarray:
    """One-shot convenience wrapper."""
    return MeshContainmentTester(verts, faces).contains(points)
