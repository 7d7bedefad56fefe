"""CoarsePIFu — coarse (global) pixel-aligned model (port of
``models/coarse.py``): ``filter`` encodes, ``query`` evaluates occupancy
through the fused field query, one call per image and hourglass stack.

Layouts: images ``[B, H, W, C]``, points ``[B, N, 3]``, calib
``[B, 3|4, 4]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..ops import geometry as geom
from ..ops.fused_query import fused_gather_mlp
from ..utils.device import resolve_device, torch_dtype
from ..utils.options import PIFuLevelConfig
from .blocks import HGFilter
from .mlp import PointMLP
from .pix2pix import GlobalGenerator


class CoarseFeatures(NamedTuple):
    im_feats: torch.Tensor            # [S, B, h, w, C]
    normx: torch.Tensor               # [B, h, w, 128]
    nml_front: torch.Tensor | None    # [B, H, W, 3]
    nml_back: torch.Tensor | None


class CoarseQueryOut(NamedTuple):
    preds: torch.Tensor   # [S, B, N, 1]
    phi: torch.Tensor     # [B, N, C_phi] of the last stack
    mask: torch.Tensor    # [B, N, 1]


def level_dtype(cfg: PIFuLevelConfig) -> torch.dtype | None:
    return None if cfg.compute_dtype == "float32" else torch_dtype(
        cfg.compute_dtype)


def query_mlp(mlp: PointMLP, feat: torch.Tensor, uv: torch.Tensor,
              extra: torch.Tensor, merge_layer: int):
    """Fused gather + MLP per batch item: ``feat [B, h, w, C]``, ``uv
    [B, N, 2]``, ``extra [B, N, E]`` -> ``(pred [B, N, 1], phi or None)``.
    GroupNorm pools over each call's N points, as flax does per batch
    item inside the JAX main path."""
    packed = mlp.packed()
    preds, phis = [], []
    for b in range(feat.shape[0]):
        pred, phi = fused_gather_mlp(
            feat[b].to(packed.compute_dtype).contiguous(),
            uv[b].float().contiguous(), extra[b].float().contiguous(),
            packed, res_layers=mlp.res_layers, merge_layer=merge_layer)
        preds.append(pred)
        phis.append(phi)
    phi = None if phis[0] is None else torch.stack(phis)
    return torch.stack(preds), phi


class CoarsePIFu(nn.Module):
    def __init__(self, cfg: PIFuLevelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        c = self.cfg = cfg
        dt = level_dtype(c)
        self.image_filter = HGFilter(
            c.num_stack, c.hg_depth, c.hg_dim, c.in_channels, c.norm,
            c.hg_down, dtype=dt, device=dev)
        self.mlp = PointMLP(c.mlp_dim, c.merge_layer, c.mlp_res_layers,
                            c.mlp_norm, "sigmoid", dtype=dt, device=dev)
        nin = c.normal_input_channels
        if c.use_front_normal:
            self.netF = GlobalGenerator(nin, 3, c.nml_ngf,
                                        c.nml_n_downsampling,
                                        c.nml_n_blocks, device=dev)
        if c.use_back_normal:
            self.netB = GlobalGenerator(nin, 3, c.nml_ngf,
                                        c.nml_n_downsampling,
                                        c.nml_n_blocks, device=dev)

    def filter(self, images: torch.Tensor,
               last_only: bool = False) -> CoarseFeatures:
        c = self.cfg
        nmls = []
        nml_front = nml_back = None
        if c.use_front_normal:
            nml_front = self.netF(images)
            nmls.append(nml_front)
        if c.use_back_normal:
            nml_back = self.netB(images)
            nmls.append(nml_back)
        if nmls:
            images = torch.cat([images] + nmls, dim=-1)
        outs, normx = self.image_filter(images)
        if last_only:
            outs = outs[-1:]
        return CoarseFeatures(torch.stack(outs), normx, nml_front, nml_back)

    def query(self, feats: CoarseFeatures, points: torch.Tensor,
              calibs: torch.Tensor) -> CoarseQueryOut:
        c = self.cfg
        xyz = geom.PROJECTIONS[c.projection_mode](points, calibs)
        mask = geom.in_bounds_mask(xyz, dims=3)
        sp_feat = geom.depth_normalize(xyz, c.load_size, c.z_size)
        xy = xyz[..., :2]
        preds = []
        phi = None
        for s in range(feats.im_feats.shape[0]):
            pred, phi = query_mlp(self.mlp, feats.im_feats[s], xy, sp_feat,
                                  self.mlp.merge)
            preds.append(mask * pred)
        return CoarseQueryOut(torch.stack(preds), phi, mask)
