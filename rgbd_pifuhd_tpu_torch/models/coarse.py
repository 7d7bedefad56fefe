"""CoarsePIFu — coarse (global) pixel-aligned model (port of
``models/coarse.py``): ``filter`` encodes, ``query`` evaluates occupancy
through the fused field query, one call per image and hourglass stack.

Training (``train=True``, the objective in ``forward``) queries through the
port's torch modules instead — ``geom.index`` and ``PointMLP.forward`` on
the tensors' own device — which is what the JAX trainers differentiate
(their XLA ``PointMLP``; no Pallas kernel is on the training path).  The
normal nets run without gradient (``stop_gradient`` in the JAX package).

Layouts: images ``[B, H, W, C]``, points ``[B, N, 3]``, calib
``[B, 3|4, 4]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..ops import geometry as geom
from ..ops.fused_mlp import fused_point_mlp
from ..ops.losses import custom_bce, mse
from ..ops.fused_query import fused_gather_mlp, gather_concat
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


def _level_kernels(mlp: PointMLP, f: torch.Tensor, u: torch.Tensor,
                   e: torch.Tensor, merge_layer: int):
    """One batch item through the kernels: ``(pred [N, 1], phi or None)``.

    A norm-free MLP that owes no ``phi`` (the fine level) takes the gather
    and then ``fused_point_mlp``, the whole chain in one launch.  Every
    other case takes ``fused_gather_mlp``: GroupNorm pools over each call's
    N points, as flax does per batch item inside the JAX main path."""
    packed = mlp.packed()
    if mlp.norm != "group" and merge_layer < 0:
        return fused_point_mlp(gather_concat(f, u, e), packed,
                               res_layers=mlp.res_layers,
                               last_op=mlp.last_op), None
    return fused_gather_mlp(f, u, e, packed, res_layers=mlp.res_layers,
                            merge_layer=merge_layer)


def query_plain(mlp: PointMLP, feat: torch.Tensor, uv: torch.Tensor,
                extra: torch.Tensor, train: bool = False):
    """Gather + MLP through the port's torch modules (``geom.index`` and
    ``PointMLP.forward``, flax's steps) over a whole batch: the training
    query (batch norm over all ``B * N`` points, as flax) and the
    backward's recomputation."""
    return mlp(torch.cat([geom.index(feat, uv), extra], dim=-1), train)


def _level_plain(mlp: PointMLP, f: torch.Tensor, u: torch.Tensor,
                 e: torch.Tensor):
    """One batch item of ``query_plain``: ``(pred [N, 1], phi)``."""
    pred, phi = query_plain(mlp, f[None], u[None], e[None])
    return pred[0], None if phi is None else phi[0]


class _QueryLevel(torch.autograd.Function):
    """One batch item of ``query_mlp`` with a gradient for the points.

    Forward: the kernels (``_level_kernels``).  Backward: the level again
    through the port's torch modules under autograd, which is what
    ``jax.grad`` differentiates in the JAX package (its XLA ``PointMLP``,
    not a Pallas kernel); it returns the gradients of ``uv`` and ``extra``,
    the two inputs that carry the points (the coarse level's depth feature,
    the fine level's ``phi``), with ``pred``'s and ``phi``'s incoming
    gradients.  Gradients of the feature map or the MLP weights are
    refused: training queries with ``train=True``, through the torch
    modules."""

    @staticmethod
    def forward(ctx, feat, uv, extra, mlp, merge_layer):
        ctx.set_materialize_grads(False)
        ctx.mlp = mlp
        ctx.save_for_backward(feat, uv, extra)
        return _level_kernels(mlp, feat, uv, extra, merge_layer)

    @staticmethod
    def backward(ctx, g_pred, g_phi):
        mlp = ctx.mlp
        if ctx.needs_input_grad[0] or any(p.requires_grad
                                          for p in mlp.parameters()):
            raise RuntimeError(
                "query_mlp: gradients of the feature map or the MLP weights "
                "are training's, which queries with train=True (the torch "
                "modules, not the kernels); here only the points' gradient "
                "is computed (freeze the weights: "
                "model.requires_grad_(False))")
        feat, uv, extra = ctx.saved_tensors
        with torch.enable_grad():
            u = uv.detach().requires_grad_()
            e = extra.detach().requires_grad_()
            pred, phi = _level_plain(mlp, feat.detach(), u, e)
            outs = [(o, g) for o, g in ((pred, g_pred), (phi, g_phi))
                    if g is not None and o is not None]
            if not outs:
                return None, None, None, None, None
            gu, ge = torch.autograd.grad([o for o, _ in outs],
                                         [u, e], [g for _, g in outs],
                                         allow_unused=True)
        return None, gu, ge, None, None


def query_mlp(mlp: PointMLP, feat: torch.Tensor, uv: torch.Tensor,
              extra: torch.Tensor, merge_layer: int):
    """Gather + MLP per batch item: ``feat [B, h, w, C]``, ``uv
    [B, N, 2]``, ``extra [B, N, E]`` -> ``(pred [B, N, 1], phi or None)``.
    Each batch item is one ``_QueryLevel``: the kernels forward, the points'
    gradient backward (``normal_mode='grad'``)."""
    cd = mlp.packed().compute_dtype
    preds, phis = [], []
    for b in range(feat.shape[0]):
        pred, phi = _QueryLevel.apply(
            feat[b].to(cd).contiguous(), uv[b].float().contiguous(),
            extra[b].float().contiguous(), mlp, merge_layer)
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
            c.hg_down, dtype=dt, remat=c.remat, device=dev)
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

    def filter(self, images: torch.Tensor, train: bool = False,
               last_only: bool = False) -> CoarseFeatures:
        c = self.cfg
        nmls = []
        nml_front = nml_back = None
        with torch.no_grad():       # the normal nets get no gradient
            if c.use_front_normal:
                nml_front = self.netF(images)
                nmls.append(nml_front)
            if c.use_back_normal:
                nml_back = self.netB(images)
                nmls.append(nml_back)
        if nmls:
            images = torch.cat([images] + nmls, dim=-1)
        outs, normx = self.image_filter(images, train)
        if last_only:
            outs = outs[-1:]
        return CoarseFeatures(torch.stack(outs), normx, nml_front, nml_back)

    def query(self, feats: CoarseFeatures, points: torch.Tensor,
              calibs: torch.Tensor, train: bool = False) -> CoarseQueryOut:
        """Occupancy of every stack (masked to the [-1, 1]^3 box) and the
        last stack's ``phi``; ``train`` takes the torch modules (batch
        statistics for batch norm), otherwise the kernels."""
        c = self.cfg
        xyz = geom.PROJECTIONS[c.projection_mode](points, calibs)
        mask = geom.in_bounds_mask(xyz, dims=3)
        sp_feat = geom.depth_normalize(xyz, c.load_size, c.z_size)
        xy = xyz[..., :2]
        preds = []
        phi = None
        for s in range(feats.im_feats.shape[0]):
            if train:
                pred, phi = query_plain(self.mlp, feats.im_feats[s], xy,
                                        sp_feat, True)
            else:
                pred, phi = query_mlp(self.mlp, feats.im_feats[s], xy,
                                      sp_feat, self.mlp.merge)
            preds.append(mask * pred)
        return CoarseQueryOut(torch.stack(preds), phi, mask)

    def field_last(self, feats: CoarseFeatures, points: torch.Tensor,
                   calibs: torch.Tensor) -> torch.Tensor:
        """Occupancy ``[B, N, 1]`` of the last stack, unmasked: the field
        whose negative gradient ``normal_mode='grad'`` colours with."""
        c = self.cfg
        xyz = geom.PROJECTIONS[c.projection_mode](points, calibs)
        sp_feat = geom.depth_normalize(xyz, c.load_size, c.z_size)
        return query_mlp(self.mlp, feats.im_feats[-1], xyz[..., :2], sp_feat,
                         -1)[0]

    def calc_normal(self, feats: CoarseFeatures, points: torch.Tensor,
                    calibs: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
        """Finite-difference unit normals ``[B, N, 3]``: taps p, p+dx,
        p+dy, p+dz of the last stack's field."""
        B, N, _ = points.shape
        offsets = torch.cat([
            torch.zeros(1, 3, dtype=points.dtype, device=points.device),
            torch.eye(3, dtype=points.dtype, device=points.device) * delta])
        pts_all = (points[:, :, None, :] + offsets).reshape(B, N * 4, 3)
        pred = self.field_last(feats, pts_all, calibs).reshape(B, N, 4)
        nml = -(pred[..., 1:] - pred[..., :1])
        norm = torch.linalg.norm(nml, dim=-1, keepdim=True)
        return nml / torch.clamp(norm, min=1e-8)

    def get_error(self, out: CoarseQueryOut, labels: torch.Tensor,
                  gamma: float, loss_type: str = "bce") -> torch.Tensor:
        """Mean over the stacks of the occupancy loss against the labels
        masked to the box."""
        labels = out.mask * labels
        gamma_b = torch.full((labels.shape[0],), float(gamma),
                             dtype=labels.dtype, device=labels.device)
        total = 0.0
        for s in range(out.preds.shape[0]):
            if loss_type == "bce":
                total = total + custom_bce(out.preds[s], labels, gamma_b)
            else:
                total = total + mse(out.preds[s], labels)
        return total / out.preds.shape[0]

    def forward(self, images, points, calibs, labels, gamma=0.5,
                train: bool = True):
        """filter -> query -> loss: the coarse pretraining objective;
        returns ``(err, query out)``."""
        feats = self.filter(images, train=train)
        out = self.query(feats, points, calibs, train=train)
        return self.get_error(out, labels, gamma), out
