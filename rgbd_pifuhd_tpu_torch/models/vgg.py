"""VGG16 features and the perceptual (content + style) loss (port of
``models/vgg.py``), NHWC.

``VGG16Features`` is the first four conv blocks of VGG16 (``conv0`` ..
``conv9``, 3x3, ReLU, 2x2 max-pool between blocks) and returns the four
taps relu1_2, relu2_2, relu3_3, relu4_3.  Weights, in order of preference:
a local file (``find_weights``: an explicit path, ``RGBD_PIFUHD_VGG16``,
then ``~/.cache/torch/hub/checkpoints/*vgg16*``), a torchvision
``state_dict`` (``features.{0,2,5,...}``, OIHW) or an ``.npz`` of
``conv{i}_kernel`` (HWIO) / ``conv{i}_bias``; else a random draw.  Nothing
is downloaded.  The random draw is flax's default initialiser from a
``torch.Generator`` seeded with ``rng_key`` (``init_flax(..., lecun=True)``):
the same distribution as the JAX package's, not the same numbers (JAX's
PRNG).  Every loader returns a flax variables tree with numpy leaves, which
``utils.checkpoint.load_params`` maps onto the module.

``make_perceptual_loss(params)`` is ``(x, y, style) -> weight * (content +
style_weight * style)``: content the MSE of each tap of ``x`` against the
tap of ``y`` without gradient, style the MSE of the Gram matrices of ``y``'s
taps against ``style``'s.  The normal step calls it as ``(target, fake,
style)``, as the JAX package does.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.losses import gram_matrix, mse
from .blocks import Conv, init_flax

# convs per VGG16 block (before each max-pool)
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))
# torchvision vgg16 ``features`` indices of the ten convs
_TORCH_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, on NHWC (flax ``max_pool`` VALID)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class VGG16Features(nn.Module):
    """First four VGG16 conv blocks; returns the four tap activations."""

    def __init__(self, device=None):
        super().__init__()
        cin, i = 3, 0
        for widths in _BLOCKS:
            for w in widths:
                setattr(self, f"conv{i}", Conv(cin, w, 3, padding=1,
                                               device=device))
                cin, i = w, i + 1

    def forward(self, x):
        taps, i = [], 0
        for b, widths in enumerate(_BLOCKS):
            for _ in widths:
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
            taps.append(x)
            if b < len(_BLOCKS) - 1:
                x = max_pool2(x)
        return taps

    @staticmethod
    def init_params(rng_key: int = 0) -> dict:
        m = VGG16Features(device="cpu")
        init_flax(m, torch.Generator().manual_seed(rng_key), lecun=True)
        from ..utils.checkpoint import params_to_flax
        return params_to_flax(m)

    @staticmethod
    def load_torch_weights(path: str) -> dict:
        """A torchvision vgg16 ``state_dict`` (``features.*`` keys)."""
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = {}
        for i, tid in enumerate(_TORCH_IDS):
            w = sd[f"features.{tid}.weight"].float().numpy()  # [o, i, h, w]
            params[f"conv{i}"] = {
                "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                "bias": sd[f"features.{tid}.bias"].float().numpy().copy()}
        return {"params": params}

    @staticmethod
    def load_npz_weights(path: str) -> dict:
        """``conv{i}_kernel`` [kh, kw, in, out] / ``conv{i}_bias``."""
        z = np.load(path)
        return {"params": {f"conv{i}": {"kernel": z[f"conv{i}_kernel"],
                                        "bias": z[f"conv{i}_bias"]}
                           for i in range(len(_TORCH_IDS))}}

    @staticmethod
    def find_weights(path: str | None = None) -> str | None:
        """A local pretrained-weights file: explicit ``path`` -> the
        ``RGBD_PIFUHD_VGG16`` environment variable -> the torch hub
        cache."""
        candidates = [path, os.environ.get("RGBD_PIFUHD_VGG16")]
        cache = os.path.expanduser("~/.cache/torch/hub/checkpoints")
        if os.path.isdir(cache):
            candidates += [os.path.join(cache, f)
                           for f in sorted(os.listdir(cache))
                           if "vgg16" in f.lower()]
        for c in candidates:
            if c and os.path.exists(c):
                return c
        return None

    @staticmethod
    def load_weights(path: str | None = None, rng_key: int = 0) -> dict:
        """The best parameters available: a located file (.npz or torch),
        else the seeded random draw."""
        c = VGG16Features.find_weights(path)
        if c is not None:
            try:
                if c.endswith(".npz"):
                    return VGG16Features.load_npz_weights(c)
                return VGG16Features.load_torch_weights(c)
            except (OSError, KeyError, ValueError, RuntimeError,
                    AttributeError, pickle.UnpicklingError) as e:
                print(f"[vgg] could not load {c}: {e}")
        return VGG16Features.init_params(rng_key)


def make_perceptual_loss(params: dict, style_weight: float = 1e5,
                         feature_model: nn.Module | None = None,
                         weight: float = 1.0, device=None):
    """``(x, y, style_im) -> scalar`` over NHWC images in [-1, 1].
    ``params``: the feature model's flax tree; ``feature_model``: any module
    returning a list of taps (default ``VGG16Features``); it is frozen and
    moved to ``device`` (default: where it was built)."""
    from ..utils.checkpoint import load_params

    net = feature_model if feature_model is not None else VGG16Features(
        device="cpu")
    load_params(net, params)
    if device is not None:
        net = net.to(device)
    net.requires_grad_(False)

    def loss(x, y, style_im):
        x_f, y_f, s_f = net(x), net(y), net(style_im)
        content = sum(mse(xf, yf.detach()) for xf, yf in zip(x_f, y_f))
        style = sum(mse(gram_matrix(yf), gram_matrix(sf))
                    for yf, sf in zip(y_f, s_f))
        return weight * (content + style_weight * style)

    return loss
