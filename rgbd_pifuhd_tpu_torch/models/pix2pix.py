"""pix2pixHD global generator (port of ``models/pix2pix.py:45-114``), NHWC.

The flax module has no ``dtype``, so it runs in f32 even in a bf16 model.
``up{i}`` are torch ``ConvTranspose2d(k3, s2, p1, output_padding=1)``,
which equals flax ``ConvTranspose`` with ``UP_PAD = ((1, 2), (1, 2))`` once
the kernel is spatially flipped (done by ``utils.checkpoint.params_from_flax``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                 mode="reflect").permute(0, 2, 3, 1)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False): per sample and channel over H, W."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


class ConvTranspose(nn.Module):
    """torch ``ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1)`` on
    NHWC; ``weight [cin, cout, 3, 3]``."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cin, cout, 3, 3, device=device).normal_(0.0, 0.02))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).float(), self.weight,
                               self.bias, stride=2, padding=1,
                               output_padding=1)
        return y.permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, device=device)
        self.conv2 = Conv(dim, dim, 3, device=device)
        self.norm = InstanceNorm()

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(reflect_pad(x, 1))))
        y = self.norm(self.conv2(reflect_pad(y, 1)))
        return x + y


class GlobalGenerator(nn.Module):
    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 last_op: str | None = "tanh", device=None):
        super().__init__()
        self.n_down, self.n_blocks, self.last_op = (n_downsampling, n_blocks,
                                                    last_op)
        self.stem = Conv(input_nc, ngf, 7, device=device)
        for i in range(n_downsampling):
            m = 2 ** i
            setattr(self, f"down{i}", Conv(ngf * m, ngf * m * 2, 3, stride=2,
                                           padding=1, device=device))
        m = 2 ** n_downsampling
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResnetBlock(ngf * m, device))
        for i in range(n_downsampling):
            m = 2 ** (n_downsampling - i)
            setattr(self, f"up{i}", ConvTranspose(ngf * m, ngf * m // 2,
                                                  device))
        self.head = Conv(ngf, output_nc, 7, device=device)
        self.norm = InstanceNorm()

    def forward(self, x):
        y = F.relu(self.norm(self.stem(reflect_pad(x, 3))))
        for i in range(self.n_down):
            y = F.relu(self.norm(getattr(self, f"down{i}")(y)))
        for i in range(self.n_blocks):
            y = getattr(self, f"res{i}")(y)
        for i in range(self.n_down):
            y = F.relu(self.norm(getattr(self, f"up{i}")(y)))
        y = self.head(reflect_pad(y, 3))
        if self.last_op == "tanh":
            y = torch.tanh(y)
        return y
