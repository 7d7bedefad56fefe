"""Plain PyTorch reference of PIFu's texture network, Tex-PIFu (Saito et
al., ICCV 2019; shunsukesaito/PIFu ``lib/model/ResBlkPIFuNet.py``,
``lib/model/SurfaceClassifier.py``), float32, NHWC at the boundary: the
benchmark's copy of ``tests/reference_texpifu.py``, with which the
comparison that decides ``correct`` is made.

Every operation is a stock ``torch`` call: no kernel, cache or batching of
the measured program, and nothing imported from either package.  Parameter
names follow ``rgbd_pifuhd_tpu_torch.models.texture.TexPIFu`` one to one
(``image_filter.block0.conv1.weight``, ``mlp.dense0.weight``), so its state
dict loads as it is.

- ``ResnetFilter``: reflect-pad 3, conv 7x7 (no bias), GroupNorm, ReLU; two
  stride-2 3x3 convs, each with GroupNorm and ReLU; ``n_blocks`` blocks
  ``x + [pad 1, conv 3x3, norm, ReLU, pad 1, conv 3x3, norm]``, the last
  without its final norm.  GroupNorm(32) with affine parameters (one group
  a channel below 32 channels: the tests' narrow filters).
- ``attach``: netG's last-stack feature, then the filter's.
- the colour chain: bilinear sample (zeros outside, ``align_corners=True``)
  of the attached map at the projected xy, plus ``z * (load_size // 2) /
  z_size``; Dense layers, every one after the first taking ``[y, input]``,
  leaky_relu(0.01) between them, tanh last.  Colour = ``pred * 0.5 + 0.5``.

Precision: ``precision("ref")`` computes in float32 with TF32 off
(``no_tf32``).  ``precision("control")`` rounds the operands of every
convolution and Dense layer to float8 e4m3 (one scale per tensor, amax to
448), the precision below the bfloat16 that the configuration states for
them, before the float32 computation.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

_MODE = ["ref"]
_FP8_MAX = 448.0


@contextlib.contextmanager
def precision(mode: str):
    """``ref`` or ``control`` for the layers computed inside."""
    if mode not in ("ref", "control"):
        raise ValueError(mode)
    prev = _MODE[0]
    _MODE[0] = mode
    try:
        yield
    finally:
        _MODE[0] = prev


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32 inside; the process's
    own settings again after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def lowp(t: torch.Tensor) -> torch.Tensor:
    """The control's operand rounding; the reference leaves ``t``."""
    if _MODE[0] == "ref":
        return t
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    s = _FP8_MAX / amax
    return (t.float() * s).to(torch.float8_e4m3fn).float() / s


def _pad(x, p):
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                 mode="reflect").permute(0, 2, 3, 1)


class Conv(nn.Module):
    """NHWC convolution without bias, weight OIHW."""

    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        y = F.conv2d(lowp(x.permute(0, 3, 1, 2)), lowp(self.weight), None,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.groups = min(32, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), self.groups, self.weight,
                         self.bias, 1e-5)
        return y.permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, dim, last):
        super().__init__()
        self.last = last
        self.conv1 = Conv(dim, dim, 3)
        self.norm1 = GroupNorm(dim)
        self.conv2 = Conv(dim, dim, 3)
        if not last:
            self.norm2 = GroupNorm(dim)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(_pad(x, 1))))
        y = self.conv2(_pad(y, 1))
        return x + (y if self.last else self.norm2(y))


class ResnetFilter(nn.Module):
    def __init__(self, ngf=64, n_blocks=6, input_nc=3):
        super().__init__()
        self.n_blocks = n_blocks
        self.stem = Conv(input_nc, ngf, 7)
        self.norm0 = GroupNorm(ngf)
        for i in range(2):
            m = 2 ** i
            setattr(self, f"down{i}", Conv(ngf * m, ngf * m * 2, 3, 2, 1))
            setattr(self, f"norm{i + 1}", GroupNorm(ngf * m * 2))
        for i in range(n_blocks):
            setattr(self, f"block{i}", ResnetBlock(ngf * 4,
                                                   i == n_blocks - 1))

    def forward(self, x):
        y = F.relu(self.norm0(self.stem(_pad(x, 3))))
        for i in range(2):
            y = F.relu(getattr(self, f"norm{i + 1}")(
                getattr(self, f"down{i}")(y)))
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}")(y)
        return y


class ColorMLP(nn.Module):
    """PIFu's residual ``SurfaceClassifier`` with a tanh head."""

    def __init__(self, dims):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            cin = dims[i] + (dims[0] if i else 0)
            setattr(self, f"dense{i}", nn.Linear(cin, dims[i + 1]))

    def forward(self, feat):
        y = feat
        for i in range(self.n):
            x = torch.cat([y, feat], -1) if i else y
            lin = getattr(self, f"dense{i}")
            y = F.linear(lowp(x), lowp(lin.weight), lin.bias)
            if i != self.n - 1:
                y = F.leaky_relu(y, 0.01)
        return torch.tanh(y)


class TexPIFu(nn.Module):
    """netC: ``filter``, ``attach`` and the colours of points."""

    def __init__(self, mlp_dim_color, ngf=64, n_blocks=6, load_size=1024,
                 z_size=200.0):
        super().__init__()
        self.image_filter = ResnetFilter(ngf, n_blocks)
        self.mlp = ColorMLP(list(mlp_dim_color))
        self.load_size, self.z_size = load_size, z_size

    def filter(self, rgb):
        """``[B, H, W, 3]`` in [-1, 1] -> ``[B, H / 4, W / 4, 4 ngf]``."""
        return self.image_filter(rgb)

    @staticmethod
    def attach(tex_feat, g_feat):
        """Batch item 0 of netG's last-stack feature, then the filter's:
        ``[h, w, C_g + C]``."""
        return torch.cat([g_feat[0].float(), tex_feat[0].float()], -1)

    def query(self, feat, points, calib):
        """Colours in [-1, 1] ``[N, 3]`` of ``points [N, 3]`` under
        ``calib [4, 4]`` (orthogonal projection)."""
        xyz = points.float() @ calib[:3, :3].T + calib[:3, 3]
        z = xyz[:, 2:3] * (self.load_size // 2) / self.z_size
        s = F.grid_sample(feat.permute(2, 0, 1)[None], xyz[None, None, :, :2],
                          "bilinear", "zeros", align_corners=True)
        return self.mlp(torch.cat([s[0, :, 0].T, z], -1))

    def colors(self, rgb, g_feat, points, calib, block: int = 65536):
        """``uint8``-level colours ``round(255 (pred / 2 + 1 / 2))`` of
        ``points``, computed in blocks."""
        feat = self.attach(self.filter(rgb), g_feat)
        out = [self.query(feat, points[i:i + block], calib)
               for i in range(0, len(points), block)]
        return levels(torch.cat(out))


def levels(pred: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> the uint8 levels (as float) PIFu's ``pred * 0.5 + 0.5``
    quantises to."""
    return torch.round(torch.clamp(pred * 0.5 + 0.5, 0, 1) * 255.0)
