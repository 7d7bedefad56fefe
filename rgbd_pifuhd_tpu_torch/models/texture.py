"""PIFu's texture network, Tex-PIFu (Saito et al., "PIFu: Pixel-Aligned
Implicit Function for High-Resolution Clothed Human Digitization", ICCV
2019; shunsukesaito/PIFu ``lib/model/ResBlkPIFuNet.py`` and
``lib/model/SurfaceClassifier.py``), NHWC, on the coarse level's features.

- ``ResnetFilter``: reflect-pad 3, conv 7x7 3 -> ngf, two stride-2 3x3
  convs to 4 ngf, ``n_blocks`` residual blocks ``x + [pad, conv 3x3, norm,
  ReLU, pad, conv 3x3, norm]`` (the last without its final norm); every
  norm GroupNorm(32) with affine parameters (``--norm_color group``), so
  the convs have no bias; no output tanh (``--use_tanh`` off).
- ``attach``: netG's last-stack feature, then the filter's, as one
  ``[h, w, C]`` map.
- the colour field: each point's bilinear sample of that map plus the
  normalised z, through the ``SurfaceClassifier`` chain (``mlp_dim_color``,
  every layer after the first also taking the input, Dense with biases,
  leaky_relu(0.01), no norm, tanh head), through the fused field query
  (``ops.fused_query.fused_gather_mlp``) with a three-column tanh head.

Departures from PIFu: the gather is the port's ``align_corners=True``
bilinear gather (netG's); the z feature takes netG's normaliser (the
coarse level's ``load_size`` and ``z_size``); a filter narrower than 32
channels (the tests') takes one group a channel.  Colours are ``pred * 0.5
+ 0.5``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import geometry as geom
from ..ops.fused_query import fused_gather_mlp
from ..utils.device import resolve_device, torch_dtype
from ..utils.options import ColorConfig, PIFuLevelConfig
from .blocks import Conv, GroupNorm
from .mlp import PointMLP
from .pix2pix import reflect_pad


def _norm(channels: int, device) -> GroupNorm:
    return GroupNorm(channels, min(32, channels), device=device)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, last: bool, dtype=None, device=None):
        super().__init__()
        self.last = last
        self.conv1 = Conv(dim, dim, 3, bias=False, dtype=dtype, device=device)
        self.norm1 = _norm(dim, device)
        self.conv2 = Conv(dim, dim, 3, bias=False, dtype=dtype, device=device)
        if not last:
            self.norm2 = _norm(dim, device)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(reflect_pad(x, 1))))
        y = self.conv2(reflect_pad(y, 1))
        return x + (y if self.last else self.norm2(y))


class ResnetFilter(nn.Module):
    """``[B, H, W, input_nc]`` -> ``[B, H / 4, W / 4, 4 ngf]``."""

    def __init__(self, input_nc: int = 3, ngf: int = 64, n_blocks: int = 6,
                 norm: str = "group", dtype=None, device=None):
        super().__init__()
        if norm != "group":
            raise ValueError(f"norm_color {norm!r}: only 'group' is ported")
        self.n_blocks = n_blocks
        self.stem = Conv(input_nc, ngf, 7, bias=False, dtype=dtype,
                         device=device)
        self.norm0 = _norm(ngf, device)
        for i in range(2):
            m = 2 ** i
            setattr(self, f"down{i}", Conv(ngf * m, ngf * m * 2, 3, stride=2,
                                           padding=1, bias=False, dtype=dtype,
                                           device=device))
            setattr(self, f"norm{i + 1}", _norm(ngf * m * 2, device))
        for i in range(n_blocks):
            setattr(self, f"block{i}", ResnetBlock(ngf * 4, i == n_blocks - 1,
                                                   dtype, device))

    def forward(self, x):
        y = F.relu(self.norm0(self.stem(reflect_pad(x, 3))))
        for i in range(2):
            y = F.relu(getattr(self, f"norm{i + 1}")(
                getattr(self, f"down{i}")(y)))
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}")(y)
        return y


def color_query(mlp: PointMLP, feat: torch.Tensor, uv: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """The colour chain over ``N`` points: ``feat [h, w, C]`` (the attached
    map, compute dtype), ``uv [N, 2]``, ``z [N, 1]`` -> ``[N, 3]`` in
    [-1, 1], one ``fused_gather_mlp`` call (its plain version on the
    CPU).  ``launches`` counts the CUDA calls."""
    pred, _ = fused_gather_mlp(feat, uv, z, mlp.packed(),
                               res_layers=mlp.res_layers, merge_layer=-1,
                               last_op="tanh")
    if feat.device.type == "cuda":
        color_query.launches += 1
    return pred


color_query.launches = 0


class TexPIFu(nn.Module):
    """netC: the filter and the colour MLP, queried on the map ``attach``
    builds from netG's features; ``cfg_global`` (netG's options) gives the
    projection and the z normaliser."""

    def __init__(self, cfg: ColorConfig, cfg_global: PIFuLevelConfig,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.cfg_global = cfg, cfg_global
        dt = None if cfg.compute_dtype == "float32" else torch_dtype(
            cfg.compute_dtype)
        dims = tuple(cfg.mlp_dim_color)
        want = cfg_global.hg_dim + 4 * cfg.ngf_color + 1
        if dims[0] != want:
            raise ValueError(f"mlp_dim_color starts at {dims[0]}; netG's "
                             f"{cfg_global.hg_dim} + the filter's "
                             f"{4 * cfg.ngf_color} + z make {want}")
        self.image_filter = ResnetFilter(3, cfg.ngf_color, cfg.n_blocks_color,
                                         cfg.norm_color, dt, dev)
        self.mlp = PointMLP(dims, -1, tuple(range(1, len(dims) - 1)), "none",
                            "tanh", dtype=dt, device=dev)

    def filter(self, rgb: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` in [-1, 1] -> the filter's ``[B, h, w, C]``."""
        return self.image_filter(rgb)

    def attach(self, tex_feat: torch.Tensor,
               g_feat: torch.Tensor) -> torch.Tensor:
        """Batch item 0 of netG's last-stack feature and the filter's, as
        one contiguous ``[h, w, C_g + C]`` map in the colour chain's
        compute dtype."""
        cd = self.mlp.packed().compute_dtype
        return torch.cat([g_feat[0].to(cd), tex_feat[0].to(cd)],
                         dim=-1).contiguous()

    def query(self, feat: torch.Tensor, points: torch.Tensor,
              calib: torch.Tensor) -> torch.Tensor:
        """Colours in [-1, 1] ``[N, 3]`` of world ``points [N, 3]`` under
        ``calib [4, 4]``."""
        c = self.cfg_global
        xyz = geom.PROJECTIONS[c.projection_mode](points[None], calib[None])[0]
        z = geom.depth_normalize(xyz, c.load_size, c.z_size)
        return color_query(self.mlp, feat, xyz[:, :2].float().contiguous(),
                           z.float().contiguous())
