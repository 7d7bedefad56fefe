"""Watertight point-in-mesh test (a NumPy copy of the JAX package's
``data/containment.py``).

+z ray casting with a 2D
(x, y) uniform-grid acceleration structure — triangles are binned by their
xy bounding boxes; each query point only intersects triangles in its bin.
Crossing-parity (odd = inside) is robust for watertight meshes.
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

    def contains(self, points: np.ndarray) -> np.ndarray:
        """[N, 3] -> bool[N]: odd +z-ray crossing parity."""
        pts = np.asarray(points, dtype=np.float64)
        out = np.zeros(len(pts), dtype=bool)
        inside_bb = np.all((pts >= self.bb_min) & (pts <= self.bb_max), axis=1)
        idx = np.nonzero(inside_bb)[0]
        if idx.size == 0:
            return out

        g = self.grid_res
        cells = np.clip(((pts[idx, :2] - self.bb_min[:2]) / self.cell)
                        .astype(int), 0, g - 1)
        cell_key = cells[:, 0] * g + cells[:, 1]
        order = np.argsort(cell_key)
        idx, cell_key = idx[order], cell_key[order]

        starts = np.searchsorted(cell_key, np.arange(g * g))
        ends = np.searchsorted(cell_key, np.arange(g * g), side="right")
        for key in np.unique(cell_key):
            tris = self.bins[key]
            if tris.size == 0:
                continue
            p = pts[idx[starts[key]:ends[key]]]     # [n, 3]
            out[idx[starts[key]:ends[key]]] = _parity(
                p, self.tri[tris]
            )
        return out


def _parity(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Crossing parity of +z rays from points ``p`` against ``tri``.

    2D point-in-triangle (xy) with the crossing z above the point.
    Uses the half-open edge rule (top-left style via strict/nonstrict mix)
    so shared edges are counted once.
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]     # [F, 3]
    n = len(p)
    out = np.zeros(n, dtype=bool)
    # chunk points to bound memory: [n, F] temporaries
    chunk = max(1, int(4e6 // max(len(tri), 1)))
    for s in range(0, n, chunk):
        q = p[s:s + chunk]                         # [m, 3]
        m = len(q)
        ax, ay = a[None, :, 0], a[None, :, 1]
        bx, by = b[None, :, 0], b[None, :, 1]
        cx, cy = c[None, :, 0], c[None, :, 1]
        px, py = q[:, None, 0], q[:, None, 1]
        d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        d = np.where(np.abs(d) < 1e-15, 1e-15, d)
        w0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / d
        w1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / d
        w2 = 1.0 - w0 - w1
        hit2d = (w0 >= 0) & (w1 >= 0) & (w2 > 0)   # mixed rule on one edge
        zhit = (w0 * a[None, :, 2] + w1 * b[None, :, 2]
                + w2 * c[None, :, 2])
        above = zhit > q[:, None, 2]
        out[s:s + chunk] = ((hit2d & above).sum(axis=1) % 2).astype(bool)
    return out


def points_in_mesh(points: np.ndarray, verts: np.ndarray,
                   faces: np.ndarray) -> np.ndarray:
    """One-shot convenience wrapper."""
    return MeshContainmentTester(verts, faces).contains(points)
