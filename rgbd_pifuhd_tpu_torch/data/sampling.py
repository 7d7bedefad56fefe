"""Occupancy point sampling for training (a NumPy copy of the JAX
package's ``data/sampling.py``: the same draws from the same generator):

- 4*N surface samples (area-weighted) + N(0, sigma) jitter
- N/4 uniform samples in the dataset bounding box
- inside/outside labels via containment, then balance to at most N/2
  inside and fill to N total with outside points.
"""

from __future__ import annotations

import numpy as np

from .containment import MeshContainmentTester


def sample_surface_points(verts: np.ndarray, faces: np.ndarray, n: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform samples on the surface. [n, 3]."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / max(areas.sum(), 1e-12)
    tri = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri]
            + r1 * r2 * v2[tri])


def sample_occupancy_points(
    verts: np.ndarray,
    faces: np.ndarray,
    num_sample_inout: int,
    b_min,
    b_max,
    rng: np.random.Generator,
    sigma: float = 1.0,
    tester: MeshContainmentTester | None = None,
):
    """-> (samples [N, 3] float32, labels [N, 1] float32 — 1 inside)."""
    n = num_sample_inout
    surf = sample_surface_points(verts, faces, 4 * n, rng)
    surf = surf + rng.normal(scale=sigma, size=surf.shape)

    length = np.asarray(b_max, np.float64) - np.asarray(b_min, np.float64)
    uniform = rng.uniform(size=(n // 4, 3)) * length + b_min
    pts = np.concatenate([surf, uniform], axis=0)
    rng.shuffle(pts)

    tester = tester or MeshContainmentTester(verts, faces)
    inside = tester.contains(pts)
    inside_pts = pts[inside]
    outside_pts = pts[~inside]

    nin = len(inside_pts)
    if nin > n // 2:
        inside_pts = inside_pts[: n // 2]
        outside_pts = outside_pts[: n // 2]
    else:
        outside_pts = outside_pts[: n - nin]

    samples = np.concatenate([inside_pts, outside_pts], axis=0)
    labels = np.concatenate(
        [np.ones((len(inside_pts), 1)), np.zeros((len(outside_pts), 1))],
        axis=0,
    )
    return samples.astype(np.float32), labels.astype(np.float32)
