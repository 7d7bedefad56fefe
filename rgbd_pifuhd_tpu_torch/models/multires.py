"""MultiResPIFu — the two-level model (port of ``models/multires.py``).

The coarse model is the submodule ``netG``; the fine level has its own
``image_filter`` and ``mlp``.  Every field evaluation goes through the
fused query twice: the coarse level (for ``phi``) and the fine level.

Layouts: local images ``[B1, B2, H, W, C]``, points ``[B1, B2, N, 3]``,
calib_local ``[B1, B2, 4, 4]``, calib_global ``[B1, 4, 4]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..ops import geometry as geom
from ..ops.resize import resize_bilinear_align_corners
from ..utils.device import resolve_device
from ..utils.options import PIFuLevelConfig
from .blocks import HGFilter
from .coarse import CoarseFeatures, CoarsePIFu, level_dtype, query_mlp
from .mlp import PointMLP


class FineFeatures(NamedTuple):
    im_feats: torch.Tensor   # [S, B1*B2, h, w, C_local]
    normx: torch.Tensor
    n_window: int


class FineQueryOut(NamedTuple):
    preds: torch.Tensor         # [B1*B2, N, 1]
    preds_interm: torch.Tensor  # [S, B1*B2, N, 1]
    preds_low: torch.Tensor     # [S_g, B1*B2, N, 1]
    mask: torch.Tensor          # [B1*B2, N, 1]


class MultiResPIFu(nn.Module):
    def __init__(self, cfg: PIFuLevelConfig, cfg_global: PIFuLevelConfig,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.cfg_global = cfg, cfg_global
        self.netG = CoarsePIFu(cfg_global, device=dev)
        dt = level_dtype(cfg)
        in_ch = 3 * (int(cfg.use_rgb) + int(cfg.use_depth)
                     + int(cfg_global.use_front_normal)
                     + int(cfg_global.use_back_normal))
        self.image_filter = HGFilter(
            cfg.num_stack, cfg.hg_depth, cfg.hg_dim, in_ch, cfg.norm,
            "no_down", dtype=dt, device=dev)
        self.mlp = PointMLP(cfg.mlp_dim, -1, cfg.mlp_res_layers,
                            cfg.mlp_norm, "sigmoid", dtype=dt, device=dev)

    def filter_global(self, images, last_only: bool = False):
        return self.netG.filter(images, last_only=last_only)

    def filter_local(self, images: torch.Tensor, g_feats: CoarseFeatures,
                     last_only: bool = False) -> FineFeatures:
        """Full-frame windows: the coarse normal maps are resized to the
        local resolution and concatenated per window."""
        B1, B2, H, W, _ = images.shape
        nmls = [n for n in (g_feats.nml_front, g_feats.nml_back)
                if n is not None]
        if nmls:
            nml = resize_bilinear_align_corners(torch.cat(nmls, dim=-1),
                                                (H, W))
            nml_win = nml[:, None].expand((B1, B2) + tuple(nml.shape[1:]))
            images = torch.cat([images, nml_win], dim=-1)
        flat = images.reshape((B1 * B2, H, W, images.shape[-1]))
        outs, normx = self.image_filter(flat)
        if last_only:
            outs = outs[-1:]
        return FineFeatures(torch.stack(outs), normx, B2)

    def _coarse(self, g_feats, pts, calib_local, calib_global):
        """Coarse query (for ``phi``) and local projection of ``pts
        [B1, B2, N, 3]``: ``(coarse out, z_feat [B1*B2, N, C], xyz)``."""
        B1, B2, N, _ = pts.shape
        xyz = geom.PROJECTIONS[self.cfg.projection_mode](pts, calib_local)
        coarse = self.netG.query(g_feats, pts.reshape(B1, B2 * N, 3),
                                 calib_global)
        return coarse, coarse.phi.reshape(B1 * B2, N, -1), xyz

    def query(self, l_feats: FineFeatures, g_feats: CoarseFeatures,
              points: torch.Tensor, calib_local: torch.Tensor,
              calib_global: torch.Tensor) -> FineQueryOut:
        B1, B2, N, _ = points.shape
        if l_feats.im_feats.shape[1] != B1 * B2:
            raise ValueError("window mismatch between features and points")
        coarse, z_feat, xyz = self._coarse(g_feats, points, calib_local,
                                           calib_global)
        mask = geom.in_bounds_mask(xyz, dims=2).reshape(B1 * B2, N, 1)
        xy = xyz[..., :2].reshape(B1 * B2, N, 2)
        preds_interm = torch.stack([
            mask * query_mlp(self.mlp, l_feats.im_feats[s], xy, z_feat,
                             -1)[0]
            for s in range(l_feats.im_feats.shape[0])])
        S_g = coarse.preds.shape[0]
        return FineQueryOut(preds_interm[-1], preds_interm,
                            coarse.preds.reshape(S_g, B1 * B2, N, 1), mask)

    def field_last(self, l_feats: FineFeatures, g_feats: CoarseFeatures,
                   points: torch.Tensor, calib_local: torch.Tensor,
                   calib_global: torch.Tensor) -> torch.Tensor:
        """Fine occupancy ``[B1*B2, N, 1]`` of the last local stack, with
        the coarse ``phi`` left differentiable: the field whose negative
        gradient ``normal_mode='grad'`` colours with (the quantity the fd
        taps of ``calc_normal`` sample)."""
        B1, B2, N, _ = points.shape
        _, z_feat, xyz = self._coarse(g_feats, points, calib_local,
                                      calib_global)
        return query_mlp(self.mlp, l_feats.im_feats[-1],
                         xyz[..., :2].reshape(B1 * B2, N, 2), z_feat, -1)[0]

    def calc_normal(self, l_feats: FineFeatures, g_feats: CoarseFeatures,
                    points: torch.Tensor, calib_local: torch.Tensor,
                    calib_global: torch.Tensor,
                    delta: float = 1e-3) -> torch.Tensor:
        """Finite-difference unit normals of the fine field,
        ``[B1*B2, N, 3]``: taps p, p+dx, p+dy, p+dz of the last stack."""
        B1, B2, N, _ = points.shape
        # built on the device: a host->device copy would wait for the queue
        offsets = torch.cat([
            torch.zeros(1, 3, dtype=points.dtype, device=points.device),
            torch.eye(3, dtype=points.dtype, device=points.device) * delta])
        pts_all = (points[:, :, :, None, :] + offsets).reshape(
            B1, B2, N * 4, 3)
        _, z_feat, xyz = self._coarse(g_feats, pts_all, calib_local,
                                      calib_global)
        pred, _ = query_mlp(self.mlp, l_feats.im_feats[-1],
                            xyz[..., :2].reshape(B1 * B2, N * 4, 2), z_feat,
                            -1)
        pred = pred.reshape(B1 * B2, N, 4)
        nml = -(pred[..., 1:] - pred[..., :1])
        norm = torch.linalg.norm(nml, dim=-1, keepdim=True)
        return nml / torch.clamp(norm, min=1e-8)
