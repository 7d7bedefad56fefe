"""Projection and pixel-aligned sampling (port of ``ops/geometry.py``).

Layouts follow the JAX package: feature maps ``[B, H, W, C]``, points
``[B, N, 3]``, uv ``[B, N, 2]`` in [-1, 1], calib ``[B, 3|4, 4]``.
"""

from __future__ import annotations

import torch


def grid_sample_bilinear(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling, zeros padding, ``align_corners=True``.

    ``feat [B, H, W, C]``, ``uv [B, N, 2]`` (x = width axis) -> ``[B, N, C]``
    in the promoted dtype of ``feat`` and ``uv`` (as jnp does).
    """
    B, H, W, C = feat.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1
    flat = feat.reshape(B, H * W, C)
    out_dtype = torch.promote_types(feat.dtype, uv.dtype)

    def gather(ix, iy):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        idx = (iyc * W + ixc)[..., None].expand(-1, -1, C)
        g = torch.gather(flat, 1, idx)
        return (g * valid[..., None].to(feat.dtype)).to(out_dtype)

    return (gather(x0, y0) * (wx0 * wy0)[..., None]
            + gather(x1, y0) * (wx1 * wy0)[..., None]
            + gather(x0, y1) * (wx0 * wy1)[..., None]
            + gather(x1, y1) * (wx1 * wy1)[..., None])


index = grid_sample_bilinear


def orthogonal(points: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """``rot @ p + trans`` with rot = calib[..., :3, :3]."""
    rot = calib[..., :3, :3]
    trans = calib[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", rot, points) + trans[..., None, :]


def perspective(points: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    homo = orthogonal(points, calib)
    xy = homo[..., :2] / homo[..., 2:3]
    return torch.cat([xy, homo[..., 2:3]], dim=-1)


PROJECTIONS = {"orthogonal": orthogonal, "perspective": perspective}


def in_bounds_mask(xyz: torch.Tensor, dims: int = 3) -> torch.Tensor:
    """``[..., N, 1]`` float mask of the [-1, 1] box over ``dims`` coords."""
    c = xyz[..., :dims]
    inside = ((c >= -1.0) & (c <= 1.0)).all(dim=-1)
    return inside[..., None].to(xyz.dtype)


def depth_normalize(xyz: torch.Tensor, load_size: int = 1024,
                    z_size: float = 200.0) -> torch.Tensor:
    """``z * (load_size // 2) / z_size`` as ``[..., N, 1]``."""
    return xyz[..., 2:3] * (load_size // 2) / z_size
