"""Plain PyTorch reference of the PIFuHD two-level model, float32, NHWC at
the boundary (PIFuHD, Saito et al., CVPR 2020; facebookresearch/pifuhd
``lib/model``; pix2pixHD ``GlobalGenerator``).

No kernel, cache or batching of the measured program: every operation is a
stock ``torch`` call.  Parameter names follow the flax tree one to one
(``image_filter.m0.b1.conv1.weight``), so a state dict of the measured
model, or one mapped from a flax checkpoint by ``reference.checkpoint``,
loads as it is.

Precision: ``Precision("ref")`` computes every convolution and dense layer
in float32 with TF32 off.  ``Precision("control")`` is the control of the
correctness check: the operands of each layer that the configuration states
in bfloat16 are rounded to float8 e4m3 (one scale per tensor, amax to 448),
and those of each layer stated in float32 to bfloat16 -- the nearest
precision below the stated one -- before the float32 computation.
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


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    s = _FP8_MAX / amax
    q = (t.float() * s).to(torch.float8_e4m3fn).float() / s
    # straight-through: the rounding has no gradient of its own
    return t + (q - t).detach()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t + (t.bfloat16().float() - t).detach()


def lowp(t: torch.Tensor, stated: str) -> torch.Tensor:
    """Operand rounding of the control; the reference leaves ``t``."""
    if _MODE[0] == "ref":
        return t
    return _fp8(t) if stated == "bfloat16" else _bf16(t)


class Conv(nn.Module):
    """NHWC convolution, weight OIHW; ``stated`` is the configuration's
    precision of the layer."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 stated="float32"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.stated = stride, padding, stated

    def forward(self, x):
        y = F.conv2d(lowp(x.permute(0, 3, 1, 2), self.stated),
                     lowp(self.weight, self.stated), self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """32 groups over every non-batch axis, on ``[B, ..., C]``."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        y = F.group_norm(x.reshape(B, -1, C).transpose(1, 2), 32,
                         self.weight, self.bias, 1e-5)
        return y.transpose(1, 2).reshape(x.shape)


class _NormReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.n = GroupNorm(channels)

    def forward(self, x):
        return F.relu(self.n(x))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, stated):
        super().__init__()
        c2, c4 = cout // 2, cout // 4
        self._NormReLU_0 = _NormReLU(cin)
        self.conv1 = Conv(cin, c2, 3, padding=1, bias=False, stated=stated)
        self._NormReLU_1 = _NormReLU(c2)
        self.conv2 = Conv(c2, c4, 3, padding=1, bias=False, stated=stated)
        self._NormReLU_2 = _NormReLU(c4)
        self.conv3 = Conv(c4, c4, 3, padding=1, bias=False, stated=stated)
        self.has_down = cin != cout
        if self.has_down:
            self._NormReLU_3 = _NormReLU(cin)
            self.down_conv = Conv(cin, cout, 1, bias=False, stated=stated)

    def forward(self, x):
        y1 = self.conv1(self._NormReLU_0(x))
        y2 = self.conv2(self._NormReLU_1(y1))
        y3 = self.conv3(self._NormReLU_2(y2))
        res = self.down_conv(self._NormReLU_3(x)) if self.has_down else x
        return torch.cat([y1, y2, y3], -1) + res


def _pool2(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _resize(x, hw, mode):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode=mode,
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


class HourGlass(nn.Module):
    def __init__(self, depth, features, stated):
        super().__init__()
        self.depth = depth
        self.b1 = ConvBlock(features, features, stated)
        self.b2 = ConvBlock(features, features, stated)
        if depth > 1:
            self.inner = HourGlass(depth - 1, features, stated)
        else:
            self.b2_plus = ConvBlock(features, features, stated)
        self.b3 = ConvBlock(features, features, stated)

    def forward(self, x):
        up1 = self.b1(x)
        low1 = self.b2(_pool2(x))
        low2 = self.inner(low1) if self.depth > 1 else self.b2_plus(low1)
        low3 = self.b3(low2)
        H, W = low3.shape[1:3]
        return up1 + _resize(low3, (2 * H, 2 * W), "bicubic")


class HGFilter(nn.Module):
    """Stacked hourglass; ``down`` is ``ave_pool`` or ``no_down``."""

    def __init__(self, n_stack, depth, last_ch, in_ch, down, stated):
        super().__init__()
        self.n_stack, self.down = n_stack, down
        self.conv1 = Conv(in_ch, 64, 7, 2, 3, stated=stated)
        self._NormReLU_0 = _NormReLU(64)
        self.conv2 = ConvBlock(64, 128, stated)
        self.conv3 = ConvBlock(128, 128, stated)
        self.conv4 = ConvBlock(128, 256, stated)
        for i in range(n_stack):
            setattr(self, f"m{i}", HourGlass(depth, 256, stated))
            setattr(self, f"top_m_{i}", ConvBlock(256, 256, stated))
            setattr(self, f"conv_last{i}", Conv(256, 256, 1, stated=stated))
            setattr(self, f"_NormReLU_{i + 1}", _NormReLU(256))
            setattr(self, f"l{i}", Conv(256, last_ch, 1, stated=stated))
            if i < n_stack - 1:
                setattr(self, f"bl{i}", Conv(256, 256, 1))
                setattr(self, f"al{i}", Conv(last_ch, 256, 1))

    def forward(self, x):
        x = self.conv2(self._NormReLU_0(self.conv1(x)))
        if self.down == "ave_pool":
            x = _pool2(x)
        prev = self.conv4(self.conv3(x))
        outs = []
        for i in range(self.n_stack):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(prev))
            ll = getattr(self, f"_NormReLU_{i + 1}")(
                getattr(self, f"conv_last{i}")(ll))
            out = getattr(self, f"l{i}")(ll)
            outs.append(out)
            if i < self.n_stack - 1:
                prev = (prev + getattr(self, f"bl{i}")(ll)
                        + getattr(self, f"al{i}")(out))
        return outs


def _inorm(x):
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _reflect(x, p):
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                 mode="reflect").permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """k3 s2 p1 output_padding 1; weight ``[cin, cout, 3, 3]``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv_transpose2d(lowp(x.permute(0, 3, 1, 2), "float32"),
                               lowp(self.weight, "float32"), self.bias, 2,
                               1, output_padding=1)
        return y.permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3)
        self.conv2 = Conv(dim, dim, 3)

    def forward(self, x):
        y = F.relu(_inorm(self.conv1(_reflect(x, 1))))
        return x + _inorm(self.conv2(_reflect(y, 1)))


class GlobalGenerator(nn.Module):
    """pix2pixHD global generator (instance norm, reflect padding, tanh)."""

    def __init__(self, cin, cout=3, ngf=64, n_down=4, n_blocks=9):
        super().__init__()
        self.n_down, self.n_blocks = n_down, n_blocks
        self.stem = Conv(cin, ngf, 7)
        for i in range(n_down):
            m = 2 ** i
            setattr(self, f"down{i}", Conv(ngf * m, ngf * m * 2, 3, 2, 1))
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResnetBlock(ngf * 2 ** n_down))
        for i in range(n_down):
            m = 2 ** (n_down - i)
            setattr(self, f"up{i}", ConvTranspose(ngf * m, ngf * m // 2))
        self.head = Conv(ngf, cout, 7)

    def forward(self, x):
        y = F.relu(_inorm(self.stem(_reflect(x, 3))))
        for i in range(self.n_down):
            y = F.relu(_inorm(getattr(self, f"down{i}")(y)))
        for i in range(self.n_blocks):
            y = getattr(self, f"res{i}")(y)
        for i in range(self.n_down):
            y = F.relu(_inorm(getattr(self, f"up{i}")(y)))
        return torch.tanh(self.head(_reflect(y, 3)))


class PointMLP(nn.Module):
    """Dense chain with residual input concats, GroupNorm over the call's
    points, leaky 0.01, sigmoid; returns ``(pred, phi)`` (``phi`` after
    layer ``merge``)."""

    def __init__(self, dims, res_layers, merge, stated):
        super().__init__()
        self.dims, self.res, self.merge = list(dims), set(res_layers), merge
        self.n = len(dims) - 1
        self.stated = stated
        for i in range(self.n):
            cin = dims[i] + (dims[0] if i in self.res else 0)
            setattr(self, f"dense{i}", nn.Linear(cin, dims[i + 1]))
            if i != self.n - 1:
                setattr(self, f"norm{i}", GroupNorm(dims[i + 1]))

    def forward(self, feat):
        y, phi = feat, None
        for i in range(self.n):
            x = torch.cat([y, feat], -1) if i in self.res else y
            lin = getattr(self, f"dense{i}")
            y = F.linear(lowp(x, self.stated), lowp(lin.weight, self.stated),
                         lin.bias)
            if i != self.n - 1:
                y = F.leaky_relu(getattr(self, f"norm{i}")(y), 0.01)
            if i == self.merge:
                phi = y
        return torch.sigmoid(y), phi


def index(feat, uv):
    """Bilinear sample of ``feat [B, H, W, C]`` at ``uv [B, N, 2]`` in
    [-1, 1] (x along the width), zeros outside, align_corners."""
    out = F.grid_sample(feat.permute(0, 3, 1, 2), uv[:, None], "bilinear",
                        "zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def orthogonal(points, calib):
    """``[B, N, 3]`` by ``[B, 4, 4]``: ``R p + t``."""
    return points @ calib[:, :3, :3].transpose(1, 2) + calib[:, None, :3, 3]


class Coarse(nn.Module):
    """The coarse level: normal nets, the 4-stack hourglass, its MLP."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        st = cfg["compute_dtype"]
        nin = 3 * (int(cfg["use_rgb"]) + int(cfg["use_depth"]))
        self.nml = [k for k, on in (("netF", cfg["use_front_normal"]),
                                    ("netB", cfg["use_back_normal"])) if on]
        for k in self.nml:
            setattr(self, k, GlobalGenerator(nin, 3, cfg["nml_ngf"],
                                             cfg["nml_n_downsampling"],
                                             cfg["nml_n_blocks"]))
        self.image_filter = HGFilter(
            cfg["num_stack"], cfg["hg_depth"], cfg["hg_dim"],
            nin + 3 * len(self.nml), cfg["hg_down"], st)
        self.mlp = PointMLP(cfg["mlp_dim"], cfg["mlp_res_layers"],
                            cfg["merge_layer"], st)

    def normals(self, images):
        with torch.no_grad():
            return [getattr(self, k)(images) for k in self.nml]

    def filter(self, images, nmls=None):
        """``(stack outputs, normal maps)``; the normal nets get no
        gradient."""
        nmls = self.normals(images) if nmls is None else nmls
        return self.image_filter(torch.cat([images] + nmls, -1)), nmls

    def query(self, feat, points, calib):
        """One stack: ``(pred * box mask, phi)`` over ``[B, N, 3]``."""
        xyz = orthogonal(points, calib)
        mask = ((xyz >= -1) & (xyz <= 1)).all(-1, keepdim=True).float()
        z = xyz[..., 2:3] * (self.cfg["load_size"] // 2) / self.cfg["z_size"]
        pred, phi = self.mlp(torch.cat([index(feat, xyz[..., :2]), z], -1))
        return mask * pred, phi, mask

    def loss(self, images, points, calib, labels, gamma=0.5):
        """Mean over the stacks of the balanced BCE against the labels
        masked to the box."""
        outs, _ = self.filter(images)
        total = 0.0
        for feat in outs:
            pred, _, mask = self.query(feat, points, calib)
            total = total + bce(pred, mask * labels, gamma)
        return total / len(outs)


class MultiRes(nn.Module):
    """The two-level model: ``netG`` (``Coarse``), the fine hourglass and
    its MLP."""

    def __init__(self, cfg_fine, cfg_coarse):
        super().__init__()
        self.cfg = cfg_fine
        self.netG = Coarse(cfg_coarse)
        st = cfg_fine["compute_dtype"]
        in_ch = 3 * (int(cfg_fine["use_rgb"]) + int(cfg_fine["use_depth"])
                     + len(self.netG.nml))
        # the fine level keeps its input's resolution (PIFuHD's local
        # hourglass): no pooling after the stem, whatever ``hg_down`` says
        self.image_filter = HGFilter(
            cfg_fine["num_stack"], cfg_fine["hg_depth"], cfg_fine["hg_dim"],
            in_ch, "no_down", st)
        self.mlp = PointMLP(cfg_fine["mlp_dim"], cfg_fine["mlp_res_layers"],
                            -1, st)

    def encode(self, img_local, img_global):
        """``img_local [1, H, W, 6]`` (full frame), ``img_global [1, h, w,
        6]`` -> ``(fine features, coarse features)`` of the last stacks."""
        g_outs, nmls = self.netG.filter(img_global)
        H, W = img_local.shape[1:3]
        nml = _resize(torch.cat(nmls, -1), (H, W), "bilinear")
        l_outs = self.image_filter(torch.cat([img_local, nml], -1))
        return l_outs[-1], g_outs[-1]

    def fine(self, l_feat, g_feat, points, calib):
        """Fine occupancy of ``points [1, N, 3]`` under one call's GroupNorm
        statistics, with the 2-D box mask, ``[1, N]``."""
        _, phi, _ = self.netG.query(g_feat, points, calib)
        xyz = orthogonal(points, calib)
        mask = ((xyz[..., :2] >= -1) & (xyz[..., :2] <= 1)).all(-1).float()
        pred, _ = self.mlp(torch.cat([index(l_feat, xyz[..., :2]), phi], -1))
        return pred[..., 0], mask


def bce(pred, gt, gamma, w=None, eps=1e-5):
    """Balanced binary cross-entropy (PIFuHD's ``CustomBCELoss``)."""
    x = torch.clamp(pred, eps, 1 - eps)
    loss = -(gamma * gt * torch.log(x) + (1 - gamma) * (1 - gt)
             * torch.log(1 - x))
    if w is not None:
        loss = loss * w
    return loss.mean()
