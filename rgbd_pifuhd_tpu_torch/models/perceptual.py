"""The repo's own perceptual backbone (port of ``models/perceptual.py``),
NHWC: no external weights.

- ``CompactFeatures``: a 4-stage conv encoder (3x3 convolutions, ReLU, 2x2
  max-pool between stages), one tap per stage — the feature model that
  ``select_perceptual("native")`` plugs into ``make_perceptual_loss``;
- ``_DenoiseDecoder``: the light decoder of the denoising pretext
  (half-pixel bilinear upsampling, as ``jax.image.resize`` upsamples);
- ``backbone_step`` / ``train_backbone``: the pretext — reconstruct the
  clean image from a noised one through encoder and decoder, Adam.  The
  step takes the batch and the noise as tensors; the loop draws both from
  a ``torch.Generator`` (the JAX package draws them from its threefry
  stream, which the port does not reproduce);
- ``save_backbone`` / ``load_backbone`` / ``find_backbone``: the ``.npz``
  weights (the committed ``assets/perceptual/backbone.npz``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv, init_flax
from .vgg import max_pool2

_WIDTHS = (16, 32, 64, 128)

DEFAULT_BACKBONE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets", "perceptual", "backbone.npz")


class CompactFeatures(nn.Module):
    """4-stage conv encoder; returns one tap per stage."""

    def __init__(self, widths: tuple = _WIDTHS, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.widths = tuple(widths)
        cin = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"conv{i}a", Conv(cin, w, 3, padding=1,
                                            device=device))
            setattr(self, f"conv{i}b", Conv(w, w, 3, padding=1,
                                            device=device))
            cin = w

    def forward(self, x):
        taps = []
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"conv{i}a")(x))
            x = F.relu(getattr(self, f"conv{i}b")(x))
            taps.append(x)
            if i < len(self.widths) - 1:
                x = max_pool2(x)
        return taps


class _DenoiseDecoder(nn.Module):
    """Light decoder for the denoising pretext (training only)."""

    def __init__(self, widths: tuple = _WIDTHS, device=None):
        super().__init__()
        self.n = len(widths)
        for i in range(self.n - 2, -1, -1):
            # the upsampled output of the stage below, then tap i
            setattr(self, f"up{i}", Conv(widths[i + 1] + widths[i],
                                         widths[i], 3, padding=1,
                                         device=device))
        self.out = Conv(widths[0], 3, 3, padding=1, device=device)

    def forward(self, taps):
        x = taps[-1]
        for i in range(self.n - 2, -1, -1):
            H, W = taps[i].shape[1:3]
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(H, W),
                              mode="bilinear", align_corners=False
                              ).permute(0, 2, 3, 1)
            x = F.relu(getattr(self, f"up{i}")(torch.cat([x, taps[i]], -1)))
        return self.out(x)


def backbone_step(enc: nn.Module, dec: nn.Module,
                  opt: torch.optim.Optimizer, clean: torch.Tensor,
                  noise: torch.Tensor, noise_sigma: float = 0.35
                  ) -> torch.Tensor:
    """One pretext step on ``clean [B, H, W, 3]`` and a standard-normal
    ``noise`` of its shape; returns the loss (before the update)."""
    opt.zero_grad(set_to_none=True)
    rec = dec(enc(clean + noise_sigma * noise))
    loss = torch.mean((rec - clean) ** 2)
    loss.backward()
    opt.step()
    return loss.detach()


def train_backbone(images: np.ndarray, steps: int = 400,
                   noise_sigma: float = 0.35, lr: float = 1e-3,
                   batch: int = 4, seed: int = 0, device=None):
    """Denoising pretext over ``images [N, H, W, 3]`` in [-1, 1]; returns
    the trained ``CompactFeatures`` flax tree and the last loss."""
    from ..utils.checkpoint import params_to_flax
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    enc, dec = CompactFeatures(device="cpu"), _DenoiseDecoder(device="cpu")
    init_flax(enc, gen, lecun=True)
    init_flax(dec, gen, lecun=True)
    enc, dec = enc.to(dev), dec.to(dev)
    opt = torch.optim.Adam(list(enc.parameters()) + list(dec.parameters()),
                           lr=lr, betas=(0.9, 0.999), eps=1e-8)
    data = torch.as_tensor(np.asarray(images, np.float32))
    loss = None
    for _ in range(steps):
        idx = torch.randint(0, data.shape[0], (batch,), generator=gen)
        clean = data[idx]
        noise = torch.randn(clean.shape, generator=gen)
        loss = backbone_step(enc, dec, opt, clean.to(dev), noise.to(dev),
                             noise_sigma)
    return params_to_flax(enc), float(loss)


def save_backbone(path: str, params: dict) -> None:
    flat = {}
    for name, leaf in params["params"].items():
        flat[f"{name}_kernel"] = np.asarray(leaf["kernel"], np.float32)
        flat[f"{name}_bias"] = np.asarray(leaf["bias"], np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_backbone(path: str) -> dict:
    z = np.load(path)
    return {"params": {f"conv{i}{s}": {"kernel": z[f"conv{i}{s}_kernel"],
                                       "bias": z[f"conv{i}{s}_bias"]}
                       for i in range(len(_WIDTHS)) for s in ("a", "b")}}


def find_backbone(path: str | None = None) -> str | None:
    """Explicit path -> ``RGBD_PIFUHD_BACKBONE`` -> the committed file."""
    for c in (path, os.environ.get("RGBD_PIFUHD_BACKBONE"),
              os.path.normpath(DEFAULT_BACKBONE)):
        if c and os.path.exists(c):
            return c
    return None
