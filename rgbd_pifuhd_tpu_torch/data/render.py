"""Spherical-harmonics lighting and precomputed radiance transfer (PRT) of
offline data generation (a NumPy copy of the JAX package's
``data/render.py``, with the same arithmetic and draw order, so the arrays
are equal): the real SH basis by associated Legendre recurrence, stratified
sphere directions, the SH rotation matrix by a least-squares projection,
ray occlusion on ``data/containment``'s binned triangle test, and
Monte-Carlo per-vertex transport.  Host code: it feeds the orthographic
rasteriser of ``data/synthetic.py``.

SH convention: real spherical harmonics, band order ``order`` (default 2 =
9 coefficients), indexed l*(l+1)+m.

``ray_any_hit`` builds a ``MeshContainmentTester`` (a Python loop over the
triangles) once per direction; ``compute_prt`` calls it once per
direction, which is the slow part of generation at 100k faces.
"""

from __future__ import annotations

import numpy as np

from .containment import MeshContainmentTester


# ------------------------------------------------------------------ SH basis
def _factorial_ratio(l: int, m: int) -> float:
    """(l-m)! / (l+m)!"""
    out = 1.0
    for k in range(l - m + 1, l + m + 1):
        out /= k
    return out


def _assoc_legendre(l: int, m: int, x: np.ndarray) -> np.ndarray:
    """Associated Legendre P_l^m(x) by stable recurrence."""
    pmm = np.ones_like(x)
    if m > 0:
        somx2 = np.sqrt(np.maximum(1.0 - x * x, 0.0))
        fact = 1.0
        for _ in range(m):
            pmm = pmm * (-fact) * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2.0 * m + 1.0) * pmm
    if l == m + 1:
        return pmmp1
    pll = pmmp1
    for ll in range(m + 2, l + 1):
        pll = ((2.0 * ll - 1.0) * x * pmmp1 - (ll + m - 1.0) * pmm) / (ll - m)
        pmm, pmmp1 = pmmp1, pll
    return pll


def sh_basis(dirs: np.ndarray, order: int = 2) -> np.ndarray:
    """Real SH basis values for unit directions [N, 3] -> [N, (order+1)^2]."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    theta_cos = z
    phi = np.arctan2(y, x)
    out = np.zeros((len(dirs), (order + 1) ** 2))
    for l in range(order + 1):
        for m in range(-l, l + 1):
            idx = l * (l + 1) + m
            am = abs(m)
            norm = np.sqrt(
                (2 * l + 1) / (4 * np.pi) * _factorial_ratio(l, am)
            )
            P = _assoc_legendre(l, am, theta_cos)
            if m > 0:
                out[:, idx] = np.sqrt(2.0) * norm * np.cos(m * phi) * P
            elif m < 0:
                out[:, idx] = np.sqrt(2.0) * norm * np.sin(am * phi) * P
            else:
                out[:, idx] = norm * P
    return out


def sample_sphere_directions(n: int, rng: np.random.Generator) -> np.ndarray:
    """Stratified uniform directions on the sphere, [n*n, 3]."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    u = (i.reshape(-1) + rng.uniform(size=n * n)) / n
    v = (j.reshape(-1) + rng.uniform(size=n * n)) / n
    z = 1.0 - 2.0 * u
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * np.pi * v
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


# ----------------------------------------------------------------- SH rotate
def sh_rotation_matrix(R: np.ndarray, order: int = 2,
                       rng_seed: int = 0) -> np.ndarray:
    """[(order+1)^2]^2 SH rotation matrix via least-squares projection.

    Replaces the reference's hand-rolled band-2 rotation (rotateBand2):
    sample unit directions, evaluate basis before/after rotating, solve for
    the block matrix.  Exact for band-limited functions given enough
    samples; block-diagonal by band.
    """
    n = (order + 1) ** 2
    rng = np.random.default_rng(rng_seed)
    dirs = sample_sphere_directions(16, rng)
    A = sh_basis(dirs, order)                 # [N, n]
    B = sh_basis(dirs @ R.T, order)           # rotated directions
    # rotated_coeffs = M @ coeffs with B @ M == A  (f(R^-1 d) expansion)
    M, *_ = np.linalg.lstsq(A, B, rcond=None)
    out = M.T
    # zero out tiny cross-band leakage
    out[np.abs(out) < 1e-10] = 0.0
    return out


def rotate_sh_coeffs(coeffs: np.ndarray, R: np.ndarray,
                     order: int = 2) -> np.ndarray:
    """coeffs [..., (order+1)^2] rotated by 3x3 R."""
    M = sh_rotation_matrix(R, order)
    return coeffs @ M.T


# --------------------------------------------------------------------- PRT
def ray_any_hit(origins: np.ndarray, direction: np.ndarray,
                verts: np.ndarray, faces: np.ndarray,
                eps: float = 1e-4) -> np.ndarray:
    """bool[N]: does a ray from each origin along ``direction`` hit the mesh?

    Implemented by rotating the scene so the direction becomes +z and
    counting crossings above the (offset) origin with the containment
    parity kernel's triangle test.
    """
    d = direction / np.linalg.norm(direction)
    # build rotation taking d -> +z
    up = np.array([0.0, 0.0, 1.0])
    v = np.cross(d, up)
    c = float(d @ up)
    if np.linalg.norm(v) < 1e-9:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx / (1.0 + c)
    rv = verts @ R.T
    ro = (origins + eps * d) @ R.T

    tester = MeshContainmentTester(rv, faces)
    g = tester.grid_res
    out = np.zeros(len(ro), dtype=bool)
    in_xy = np.all(
        (ro[:, :2] >= tester.bb_min[:2]) & (ro[:, :2] <= tester.bb_max[:2]),
        axis=1,
    )
    idx = np.nonzero(in_xy)[0]
    if idx.size == 0:
        return out
    cells = np.clip(((ro[idx, :2] - tester.bb_min[:2]) / tester.cell)
                    .astype(int), 0, g - 1)
    key = cells[:, 0] * g + cells[:, 1]
    order_ = np.argsort(key)
    idx, key = idx[order_], key[order_]
    starts = np.searchsorted(key, np.arange(g * g))
    ends = np.searchsorted(key, np.arange(g * g), side="right")
    for kk in np.unique(key):
        tris = tester.bins[kk]
        if tris.size == 0:
            continue
        sel = idx[starts[kk]:ends[kk]]
        # "hit" = ANY crossing above; parity==1 implies >=1, but even counts
        # can also mean hits.  Count directly with the same barycentric test.
        p = ro[sel]
        tri = tester.tri[tris]
        a, b_, c_ = tri[:, 0], tri[:, 1], tri[:, 2]
        ax, ay = a[None, :, 0], a[None, :, 1]
        bx, by = b_[None, :, 0], b_[None, :, 1]
        cx, cy = c_[None, :, 0], c_[None, :, 1]
        px, py = p[:, None, 0], p[:, None, 1]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        den = np.where(np.abs(den) < 1e-15, 1e-15, den)
        w0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / den
        w1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / den
        w2 = 1.0 - w0 - w1
        hit2d = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        zhit = w0 * a[None, :, 2] + w1 * b_[None, :, 2] + w2 * c_[None, :, 2]
        out[sel] = (hit2d & (zhit > p[:, None, 2])).any(axis=1)
    return out


def compute_prt(verts: np.ndarray, faces: np.ndarray, normals: np.ndarray,
                order: int = 2, n_dirs: int = 10, seed: int = 0):
    """Per-vertex PRT coefficients [V, (order+1)^2] (prt_util.computePRT).

    Monte-Carlo over stratified sphere directions: transport =
    mean(SH(d) * max(n.d, 0) * visibility(d)) * 4pi.
    """
    rng = np.random.default_rng(seed)
    dirs = sample_sphere_directions(n_dirs, rng)     # [D, 3]
    basis = sh_basis(dirs, order)                    # [D, K]
    V = len(verts)
    K = basis.shape[1]
    prt = np.zeros((V, K))
    for di in range(len(dirs)):
        d = dirs[di]
        cos = normals @ d
        front = cos > 0.0
        if not front.any():
            continue
        occluded = np.zeros(V, dtype=bool)
        occluded[front] = ray_any_hit(verts[front], d, verts, faces)
        w = np.where(front & ~occluded, np.maximum(cos, 0.0), 0.0)
        prt += w[:, None] * basis[di][None, :]
    prt *= 4.0 * np.pi / len(dirs)
    return prt


def sh_shade(prt: np.ndarray, sh_env: np.ndarray) -> np.ndarray:
    """Shaded intensity per vertex: dot(prt, env coeffs [K or K,3])."""
    return prt @ sh_env
