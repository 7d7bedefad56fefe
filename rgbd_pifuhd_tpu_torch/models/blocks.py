"""Stacked-hourglass encoder (port of ``models/blocks.py``), NHWC at the
boundary.  Attribute names follow the flax parameter tree, including flax's
auto-numbered ``_NormReLU_<k>`` submodules in creation order.

Dtypes follow flax: a conv with a ``dtype`` casts input, kernel and bias to
it and returns it; a conv without one computes in f32.  GroupNorm and
BatchNorm (f32 params) compute and return f32.

``train`` is threaded through every ``forward`` as flax threads it through
``__call__``: BatchNorm with ``train=False`` normalises with its running
statistics (flax ``use_running_average=True``; the buffers ``mean`` /
``var`` are the flax ``batch_stats``), with ``train=True`` with the batch's
and updates the buffers as flax ``BatchNorm(momentum=0.9)`` does: ``ra =
0.9 ra + 0.1 batch``, the variance biased (``E[x^2] - E[x]^2``).
``HGFilter(remat=True)`` recomputes each hourglass in the backward pass
(``torch.utils.checkpoint``), without updating the statistics twice.

``init_flax`` draws the initial parameters as flax's initialisers do: every
conv / dense / transposed-conv weight from N(0, 0.02), biases 0, norm
scales 1, running statistics 0 / 1.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.resize import avg_pool2d, upsample2x_bicubic

_STATS_FROZEN = [False]     # set while a checkpointed hourglass recomputes


@contextlib.contextmanager
def _stats_frozen(frozen: bool):
    prev = _STATS_FROZEN[0]
    _STATS_FROZEN[0] = frozen
    try:
        yield
    finally:
        _STATS_FROZEN[0] = prev


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC: ``weight`` OIHW, optional ``bias``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k, device=device).normal_(0.0, 0.02))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) \
            if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(cd), self.weight.to(cd),
                     None, self.stride, self.padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(cd)
        return y


class GroupNorm(nn.Module):
    """flax ``GroupNorm``: statistics over every non-batch axis of a group,
    ``E[x^2] - E[x]^2`` in f32 clipped at 0; returns f32.  Works on
    ``[B, ..., C]`` (images and point sets alike)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        G = self.num_groups
        C = x.shape[-1]
        xg = x.float().reshape(x.shape[0], -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9)`` on ``[..., C]``: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, with the running statistics
    (``train=False``) or the batch's over every axis but the last
    (``train=True``, which also updates the running ones)."""

    MOMENTUM = 0.9          # flax BatchNorm(momentum=0.9) of the JAX models

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def affine(self):
        """``(mul, add)`` with ``norm(x) = x * mul + add`` (f64 math)."""
        mul = torch.rsqrt(self.var.double() + self.eps) * self.weight.double()
        return mul, self.bias.double() - self.mean.double() * mul

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            mean, var = self.mean, self.var
        else:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(0)
            var = torch.clamp((flat * flat).mean(0) - mean * mean, min=0.0)
            if not _STATS_FROZEN[0]:
                m = self.MOMENTUM
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def make_norm(norm: str, channels: int, device=None) -> nn.Module:
    if norm == "group":
        return GroupNorm(channels, 32, device=device)
    if norm == "batch":
        return BatchNorm(channels, device=device)
    raise ValueError(f"unknown norm {norm!r}")


class _NormReLU(nn.Module):
    """norm (named ``n``) -> relu."""

    def __init__(self, norm: str, channels: int, device=None):
        super().__init__()
        self.n = make_norm(norm, channels, device)

    def forward(self, x, train: bool = False):
        return F.relu(self.n(x, train))


class ConvBlock(nn.Module):
    """Pre-activation residual block: out/2 + out/4 + out/4 channels."""

    def __init__(self, cin: int, cout: int, norm: str = "group", dtype=None,
                 device=None):
        super().__init__()
        c2, c4 = cout // 2, cout // 4
        self._NormReLU_0 = _NormReLU(norm, cin, device)
        self.conv1 = Conv(cin, c2, 3, padding=1, bias=False, dtype=dtype,
                          device=device)
        self._NormReLU_1 = _NormReLU(norm, c2, device)
        self.conv2 = Conv(c2, c4, 3, padding=1, bias=False, dtype=dtype,
                          device=device)
        self._NormReLU_2 = _NormReLU(norm, c4, device)
        self.conv3 = Conv(c4, c4, 3, padding=1, bias=False, dtype=dtype,
                          device=device)
        self.has_down = cin != cout
        if self.has_down:
            self._NormReLU_3 = _NormReLU(norm, cin, device)
            self.down_conv = Conv(cin, cout, 1, bias=False, dtype=dtype,
                                  device=device)

    def forward(self, x, train: bool = False):
        y1 = self.conv1(self._NormReLU_0(x, train))
        y2 = self.conv2(self._NormReLU_1(y1, train))
        y3 = self.conv3(self._NormReLU_2(y2, train))
        out = torch.cat([y1, y2, y3], dim=-1)
        res = self.down_conv(self._NormReLU_3(x, train)) if self.has_down \
            else x
        return out + res


class HourGlass(nn.Module):
    def __init__(self, depth: int, features: int, norm: str = "group",
                 dtype=None, device=None):
        super().__init__()
        cb = lambda: ConvBlock(features, features, norm, dtype, device)  # noqa: E731
        self.depth = depth
        self.b1 = cb()
        self.b2 = cb()
        if depth > 1:
            self.inner = HourGlass(depth - 1, features, norm, dtype, device)
        else:
            self.b2_plus = cb()
        self.b3 = cb()

    def forward(self, x, train: bool = False):
        up1 = self.b1(x, train)
        low1 = self.b2(avg_pool2d(x, 2, 2), train)
        low2 = self.inner(low1, train) if self.depth > 1 \
            else self.b2_plus(low1, train)
        low3 = self.b3(low2, train)
        return up1 + upsample2x_bicubic(low3)


class HGFilter(nn.Module):
    """Stacked-hourglass pixel-aligned encoder; returns ``(outputs,
    normx)`` with one ``[B, H', W', last_channels]`` map per stack.

    down_type (after the 7x7 stride-2 stem): ``ave_pool`` ConvBlock(128) +
    2x2 average pool; ``no_down`` ConvBlock(128); ``conv64`` ConvBlock(64) +
    a 3x3 stride-2 conv to 128; ``conv128`` ConvBlock(128) + the same
    conv (both convs f32, with a bias, as flax builds them).  ``remat``
    recomputes each hourglass in the backward pass."""

    def __init__(self, n_stack: int, depth: int, last_channels: int,
                 in_channels: int, norm: str = "group",
                 down_type: str = "ave_pool", dtype=None, remat: bool = False,
                 device=None):
        super().__init__()
        if down_type not in ("ave_pool", "no_down", "conv64", "conv128"):
            raise ValueError(f"unknown down_type {down_type!r}")
        self.n_stack, self.down_type, self.remat = n_stack, down_type, remat
        self.conv1 = Conv(in_channels, 64, 7, stride=2, padding=3,
                          dtype=dtype, device=device)
        self._NormReLU_0 = _NormReLU(norm, 64, device)
        c2 = 64 if down_type == "conv64" else 128
        self.conv2 = ConvBlock(64, c2, norm, dtype, device)
        if down_type in ("conv64", "conv128"):
            self.down_conv2 = Conv(c2, 128, 3, stride=2, padding=1,
                                   device=device)
        self.conv3 = ConvBlock(128, 128, norm, dtype, device)
        self.conv4 = ConvBlock(128, 256, norm, dtype, device)
        for i in range(n_stack):
            setattr(self, f"m{i}", HourGlass(depth, 256, norm, dtype, device))
            setattr(self, f"top_m_{i}", ConvBlock(256, 256, norm, dtype,
                                                  device))
            setattr(self, f"conv_last{i}", Conv(256, 256, 1, dtype=dtype,
                                                device=device))
            setattr(self, f"_NormReLU_{i + 1}", _NormReLU(norm, 256, device))
            setattr(self, f"l{i}", Conv(256, last_channels, 1, dtype=dtype,
                                        device=device))
            if i < n_stack - 1:
                setattr(self, f"bl{i}", Conv(256, 256, 1, device=device))
                setattr(self, f"al{i}", Conv(last_channels, 256, 1,
                                             device=device))

    def _hourglass(self, i: int, x, train: bool):
        hg = getattr(self, f"m{i}")
        if not (self.remat and torch.is_grad_enabled() and x.requires_grad):
            return hg(x, train)
        calls = [0]

        def run(t):
            calls[0] += 1     # the backward's recomputation: stats frozen
            with _stats_frozen(calls[0] > 1):
                return hg(t, train)

        return checkpoint(run, x, use_reentrant=False)

    def forward(self, x, train: bool = False):
        x = self._NormReLU_0(self.conv1(x), train)
        x = self.conv2(x, train)
        if self.down_type == "ave_pool":
            x = avg_pool2d(x, 2, 2)
        elif self.down_type != "no_down":
            x = self.down_conv2(x)
        normx = x
        x = self.conv4(self.conv3(x, train), train)
        previous = x
        outputs = []
        for i in range(self.n_stack):
            hg = self._hourglass(i, previous, train)
            ll = getattr(self, f"top_m_{i}")(hg, train)
            ll = getattr(self, f"_NormReLU_{i + 1}")(
                getattr(self, f"conv_last{i}")(ll), train)
            out = getattr(self, f"l{i}")(ll)
            outputs.append(out)
            if i < self.n_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(out))
        return outputs, normx


def init_flax(model: nn.Module, generator: torch.Generator,
              lecun: bool = False) -> None:
    """Re-draw every parameter of ``model`` as flax's initialisers draw
    them: conv, dense and transposed-conv weights N(0, 0.02) (the JAX
    package's ``conv_init``), biases 0, norm scales 1, running statistics
    0 / 1.  ``lecun``: conv weights as flax's default ``lecun_normal``
    instead (a normal truncated at +-2, scaled to variance 1 / fan_in;
    the modules built without ``kernel_init``: VGG16, the perceptual
    backbone).  The draws come from ``generator`` (a CPU generator) in
    module order."""
    from .pix2pix import ConvTranspose

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, nn.Linear, ConvTranspose)):
                if lecun and isinstance(m, Conv):
                    fan_in = m.weight[0].numel()
                    w = nn.init.trunc_normal_(
                        torch.empty(m.weight.shape), 0.0, 1.0, -2.0, 2.0,
                        generator=generator) * (
                            fan_in ** -0.5 / 0.87962566103423978)
                else:
                    w = torch.empty(m.weight.shape).normal_(
                        0.0, 0.02, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (GroupNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.mean.zero_()
                    m.var.fill_(1.0)
