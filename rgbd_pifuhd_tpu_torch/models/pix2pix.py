"""pix2pixHD generators and discriminators (port of ``models/pix2pix.py``),
NHWC:

- ``GlobalGenerator``: the normal nets netF / netB;
- ``LocalEnhancer``: a global generator without its head plus one local
  enhancer level on the full-resolution input;
- ``Encoder`` and ``instance_average_pool`` (one-hot segment means, no
  atomics);
- ``NLayerDiscriminator`` / ``MultiscaleDiscriminator``: PatchGAN
  discriminators (4x4 convolutions, symmetric padding 2, leaky 0.2)
  returning every layer's features, over an average-pool pyramid.

The flax modules have no ``dtype``, so they run in f32 even in a bf16
model.  ``up{i}`` (``g_up{i}``, ``l_up``) are torch ``ConvTranspose2d(k3,
s2, p1, output_padding=1)``, which equals flax ``ConvTranspose`` with
``UP_PAD = ((1, 2), (1, 2))`` once the kernel is spatially flipped (done by
``utils.checkpoint.params_from_flax``).  Attribute names are the flax
module names (``MultiscaleDiscriminator``'s ``scale{num_D - 1 - i}`` run in
reverse order), so checkpoints map one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import avg_pool2d
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


def _pyramid_down(x: torch.Tensor) -> torch.Tensor:
    return avg_pool2d(x, 3, 2, padding=1, count_include_pad=False)


class LocalEnhancer(nn.Module):
    """A global generator without its 7x7 head at half resolution, plus one
    local enhancer level (``g_*`` / ``l_*`` as the flax names)."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 32,
                 n_downsample_global: int = 3, n_blocks_global: int = 9,
                 n_blocks_local: int = 3, device=None):
        super().__init__()
        self.n_down, self.n_blocks_g, self.n_blocks_l = (
            n_downsample_global, n_blocks_global, n_blocks_local)
        ngf_g = ngf * 2
        self.g_stem = Conv(input_nc, ngf_g, 7, device=device)
        for i in range(n_downsample_global):
            m = 2 ** i
            setattr(self, f"g_down{i}", Conv(ngf_g * m, ngf_g * m * 2, 3,
                                             stride=2, padding=1,
                                             device=device))
        m = 2 ** n_downsample_global
        for i in range(n_blocks_global):
            setattr(self, f"g_res{i}", ResnetBlock(ngf_g * m, device))
        for i in range(n_downsample_global):
            m = 2 ** (n_downsample_global - i)
            setattr(self, f"g_up{i}", ConvTranspose(ngf_g * m, ngf_g * m // 2,
                                                    device))
        self.l_stem = Conv(input_nc, ngf, 7, device=device)
        self.l_down = Conv(ngf, ngf * 2, 3, stride=2, padding=1,
                           device=device)
        for i in range(n_blocks_local):
            setattr(self, f"l_res{i}", ResnetBlock(ngf * 2, device))
        self.l_up = ConvTranspose(ngf * 2, ngf, device)
        self.l_head = Conv(ngf, output_nc, 7, device=device)
        self.norm = InstanceNorm()

    def forward(self, x):
        y = F.relu(self.norm(self.g_stem(reflect_pad(_pyramid_down(x), 3))))
        for i in range(self.n_down):
            y = F.relu(self.norm(getattr(self, f"g_down{i}")(y)))
        for i in range(self.n_blocks_g):
            y = getattr(self, f"g_res{i}")(y)
        for i in range(self.n_down):
            y = F.relu(self.norm(getattr(self, f"g_up{i}")(y)))
        z = F.relu(self.norm(self.l_stem(reflect_pad(x, 3))))
        z = F.relu(self.norm(self.l_down(z))) + y
        for i in range(self.n_blocks_l):
            z = getattr(self, f"l_res{i}")(z)
        z = F.relu(self.norm(self.l_up(z)))
        return torch.tanh(self.l_head(reflect_pad(z, 3)))


class Encoder(nn.Module):
    """Feature encoder: stem, downs, ups, 7x7 head + tanh (the instance
    pooling is ``instance_average_pool``)."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 32,
                 n_downsampling: int = 4, device=None):
        super().__init__()
        self.n_down = n_downsampling
        self.stem = Conv(input_nc, ngf, 7, device=device)
        for i in range(n_downsampling):
            m = 2 ** i
            setattr(self, f"down{i}", Conv(ngf * m, ngf * m * 2, 3, stride=2,
                                           padding=1, device=device))
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
        for i in range(self.n_down):
            y = F.relu(self.norm(getattr(self, f"up{i}")(y)))
        return torch.tanh(self.head(reflect_pad(y, 3)))


def instance_average_pool(features: torch.Tensor, inst: torch.Tensor,
                          num_instances: int) -> torch.Tensor:
    """Every pixel's feature replaced by the mean over its instance region:
    ``features [B, H, W, C]``, ``inst [B, H, W]`` ids in
    ``[0, num_instances)``.  One-hot products (matrix multiplies, no
    atomics), so the sums are the same from run to run."""
    onehot = F.one_hot(inst.long(), num_instances).to(features.dtype)
    sums = torch.einsum("bhwk,bhwc->bkc", onehot, features)
    counts = onehot.sum(dim=(1, 2))[..., None]
    means = sums / torch.clamp(counts, min=1.0)
    return torch.einsum("bhwk,bkc->bhwc", onehot, means)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator; ``forward`` returns every layer's output."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, device=None):
        super().__init__()
        self.n_layers, self.use_sigmoid = n_layers, use_sigmoid
        self.conv0 = Conv(input_nc, ndf, 4, stride=2, padding=2,
                          device=device)
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"conv{n}", Conv(nf_prev, nf, 4, stride=2,
                                           padding=2, device=device))
        nf_prev, nf = nf, min(nf * 2, 512)
        self.conv_pre = Conv(nf_prev, nf, 4, padding=2, device=device)
        self.conv_out = Conv(nf, 1, 4, padding=2, device=device)
        self.norm = InstanceNorm()

    def forward(self, x):
        y = F.leaky_relu(self.conv0(x), 0.2)
        feats = [y]
        for n in range(1, self.n_layers):
            y = F.leaky_relu(self.norm(getattr(self, f"conv{n}")(y)), 0.2)
            feats.append(y)
        y = F.leaky_relu(self.norm(self.conv_pre(y)), 0.2)
        feats.append(y)
        y = self.conv_out(y)
        feats.append(torch.sigmoid(y) if self.use_sigmoid else y)
        return feats


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGAN discriminators over an average-pool pyramid; the
    full-resolution one is ``scale{num_D - 1}``."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 num_D: int = 3, use_sigmoid: bool = False, device=None):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"scale{num_D - 1 - i}", NLayerDiscriminator(
                input_nc, ndf, n_layers, use_sigmoid, device))

    def forward(self, x):
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"scale{self.num_D - 1 - i}")(x))
            if i != self.num_D - 1:
                x = _pyramid_down(x)
        return results
