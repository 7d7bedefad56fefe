"""MultiResPIFu — the two-level model (port of ``models/multires.py``).

The coarse model is the submodule ``netG``; the fine level has its own
``image_filter`` and ``mlp``.  Every field evaluation goes through the
fused query twice: the coarse level (for ``phi``) and the fine level.

Training (``train=True``; the objective in ``forward``) queries both levels
through the torch modules (``geom.index`` + ``PointMLP.forward``), as the
JAX trainers differentiate their XLA ``PointMLP``.  Unless
``train_full_pifu``, netG is frozen: its features and ``phi`` carry no
gradient and its encoder runs with ``train=False`` (its batch-norm
statistics stay), while its MLP's query runs with ``train`` as the JAX
package's does.  The fine loss is taken on the fine intermediate
predictions, with ``w = N / sum(mask)`` and ``gamma = 1 - sum(label) /
sum(mask)`` per window.

Layouts: local images ``[B1, B2, H, W, C]``, points ``[B1, B2, N, 3]``,
calib_local ``[B1, B2, 4, 4]``, calib_global ``[B1, 4, 4]``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn as nn

from ..ops import geometry as geom
from ..ops.losses import custom_bce
from ..ops.resize import resize_bilinear_align_corners
from ..utils.device import resolve_device
from ..utils.options import PIFuLevelConfig
from .blocks import HGFilter
from .coarse import (CoarseFeatures, CoarsePIFu, level_dtype, query_mlp,
                     query_plain)
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
    labels: torch.Tensor | None = None   # masked labels [B1*B2, N, 1]
    w: torch.Tensor | None = None        # [B1*B2]
    gamma: torch.Tensor | None = None    # [B1*B2]


class MultiResPIFu(nn.Module):
    def __init__(self, cfg: PIFuLevelConfig, cfg_global: PIFuLevelConfig,
                 train_full_pifu: bool = False, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.cfg_global = cfg, cfg_global
        self.train_full_pifu = train_full_pifu
        self.netG = CoarsePIFu(cfg_global, device=dev)
        dt = level_dtype(cfg)
        in_ch = 3 * (int(cfg.use_rgb) + int(cfg.use_depth)
                     + int(cfg_global.use_front_normal)
                     + int(cfg_global.use_back_normal))
        self.image_filter = HGFilter(
            cfg.num_stack, cfg.hg_depth, cfg.hg_dim, in_ch, cfg.norm,
            "no_down", dtype=dt, remat=cfg.remat, device=dev)
        self.mlp = PointMLP(cfg.mlp_dim, -1, cfg.mlp_res_layers,
                            cfg.mlp_norm, "sigmoid", dtype=dt, device=dev)

    def filter_global(self, images, train: bool = False,
                      last_only: bool = False):
        """Coarse encoding; unless ``train_full_pifu`` without gradient and
        with netG's encoder in ``train=False``."""
        if self.train_full_pifu:
            return self.netG.filter(images, train=train, last_only=last_only)
        with torch.no_grad():
            return self.netG.filter(images, train=False, last_only=last_only)

    def filter_local(self, images: torch.Tensor, g_feats: CoarseFeatures,
                     rects: torch.Tensor | None = None, train: bool = False,
                     last_only: bool = False) -> FineFeatures:
        """Fine encoding of ``[B1, B2, H, W, C]`` windows, each with the
        coarse normal maps concatenated: resized to the window (full-frame
        windows), or with ``rects [B1, B2, 4]`` (x1, y1, ...) cropped at
        ``(y1, x1)`` out of the maps resized to ``load_size`` (the start
        clamped so the window fits, as ``lax.dynamic_slice``)."""
        B1, B2, H, W, _ = images.shape
        nmls = [n for n in (g_feats.nml_front, g_feats.nml_back)
                if n is not None]
        if nmls:
            nml = torch.cat(nmls, dim=-1)
            if rects is None:
                nml = resize_bilinear_align_corners(nml, (H, W))
                nml_win = nml[:, None].expand((B1, B2) + tuple(nml.shape[1:]))
            else:
                big = self.cfg.load_size
                nml = resize_bilinear_align_corners(nml, (big, big))
                r = rects.long().tolist()
                nml_win = torch.stack([torch.stack([
                    nml[b, min(max(y, 0), big - H):min(max(y, 0), big - H) + H,
                        min(max(x, 0), big - W):min(max(x, 0), big - W) + W]
                    for x, y, *_ in r[b]]) for b in range(B1)])
            images = torch.cat([images, nml_win], dim=-1)
        flat = images.reshape((B1 * B2, H, W, images.shape[-1]))
        outs, normx = self.image_filter(flat, train)
        if last_only:
            outs = outs[-1:]
        return FineFeatures(torch.stack(outs), normx, B2)

    def _coarse(self, g_feats, pts, calib_local, calib_global,
                train: bool = False):
        """Coarse query (for ``phi``) and local projection of ``pts
        [B1, B2, N, 3]``: ``(coarse out, z_feat [B1*B2, N, C], xyz)``."""
        B1, B2, N, _ = pts.shape
        xyz = geom.PROJECTIONS[self.cfg.projection_mode](pts, calib_local)
        coarse = self.netG.query(g_feats, pts.reshape(B1, B2 * N, 3),
                                 calib_global, train=train)
        return coarse, coarse.phi.reshape(B1 * B2, N, -1), xyz

    def query(self, l_feats: FineFeatures, g_feats: CoarseFeatures,
              points: torch.Tensor, calib_local: torch.Tensor,
              calib_global: torch.Tensor, labels: torch.Tensor | None = None,
              train: bool = False) -> FineQueryOut:
        """Fine occupancy of ``points [B1, B2, N, 3]`` (masked to the local
        [-1, 1]^2 box), with the masked ``labels [B1, B2, N, 1]`` and their
        loss weights when given.  ``train`` queries through the torch
        modules (netG's ``phi`` without gradient unless
        ``train_full_pifu``), otherwise through the kernels."""
        B1, B2, N, _ = points.shape
        if l_feats.im_feats.shape[1] != B1 * B2:
            raise ValueError("window mismatch between features and points")
        frozen = train and not self.train_full_pifu
        with torch.no_grad() if frozen else contextlib.nullcontext():
            coarse, z_feat, xyz = self._coarse(g_feats, points, calib_local,
                                               calib_global, train)
        mask = geom.in_bounds_mask(xyz, dims=2).reshape(B1 * B2, N, 1)
        xy = xyz[..., :2].reshape(B1 * B2, N, 2)
        preds_interm = torch.stack([
            mask * (query_plain(self.mlp, l_feats.im_feats[s], xy, z_feat,
                                True)[0] if train else
                    query_mlp(self.mlp, l_feats.im_feats[s], xy, z_feat,
                              -1)[0])
            for s in range(l_feats.im_feats.shape[0])])
        S_g = coarse.preds.shape[0]
        new_labels = w = gamma = None
        if labels is not None:
            new_labels = mask * labels.reshape(B1 * B2, N, 1)
            denom = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
            w = N / denom
            gamma = 1.0 - new_labels.sum(dim=(1, 2)) / denom
        return FineQueryOut(preds_interm[-1], preds_interm,
                            coarse.preds.reshape(S_g, B1 * B2, N, 1), mask,
                            new_labels, w, gamma)

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

    def get_error(self, out: FineQueryOut,
                  no_intermediate_loss: bool = False) -> dict:
        """``{"occ_fine": mean over the fine stacks of custom_bce}``, plus
        ``"occ"`` over the coarse stacks with ``train_full_pifu``."""
        errors = {}
        if self.train_full_pifu and not no_intermediate_loss:
            e = 0.0
            for s in range(out.preds_low.shape[0]):
                e = e + custom_bce(out.preds_low[s], out.labels, out.gamma,
                                   out.w)
            errors["occ"] = e / out.preds_low.shape[0]
        e = 0.0
        for s in range(out.preds_interm.shape[0]):
            e = e + custom_bce(out.preds_interm[s], out.labels, out.gamma,
                               out.w)
        errors["occ_fine"] = e / out.preds_interm.shape[0]
        return errors

    def forward(self, images_local, images_global, points, calib_local,
                calib_global, labels, rects=None, train: bool = True):
        """filter_global -> filter_local -> query -> loss (fine training);
        returns ``(errors, query out)``."""
        g_feats = self.filter_global(images_global, train=train)
        l_feats = self.filter_local(images_local, g_feats, rects,
                                    train=train)
        out = self.query(l_feats, g_feats, points, calib_local, calib_global,
                         labels=labels, train=train)
        return self.get_error(out), out
