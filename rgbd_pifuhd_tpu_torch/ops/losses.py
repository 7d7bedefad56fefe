"""Loss functions (port of ``ops/losses.py``): tensors over ``[B, N, C]``
(point predictions) or ``[B, H, W, C]`` (images).

- ``custom_bce``: clamped binary cross-entropy with a per-sample
  inside/outside balance ``gamma`` and an optional per-sample weight ``w``
  (and the "brock" rescaled variant);
- ``gram_matrix``: the style term's Gram matrix of NHWC features;
- ``gan_loss_lsgan`` / ``multiscale_gan_loss``: least-squares GAN loss over
  one or several discriminator scales.
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def _per_sample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(tuple(x.shape) + (1,) * (like.ndim - x.ndim))


def custom_bce(pred: torch.Tensor, gt: torch.Tensor, gamma: torch.Tensor,
               w: torch.Tensor | None = None, brock: bool = False,
               eps: float = 1e-5) -> torch.Tensor:
    """Balanced binary cross-entropy: ``pred/gt [B, N, C]``, ``gamma/w
    [B]`` broadcast over N and C.  ``gamma`` weights the inside (gt = 1)
    term, ``1 - gamma`` the outside term."""
    x_hat = torch.clamp(pred, eps, 1.0 - eps)
    g = _per_sample(gamma, pred)
    x = 3.0 * gt - 1.0 if brock else gt      # brock: rescaled to [-1, 2]
    loss = -(g * x * torch.log(x_hat)
             + (1.0 - g) * (1.0 - x) * torch.log(1.0 - x_hat))
    if w is not None:
        return torch.mean(loss * _per_sample(w, pred))
    return torch.mean(loss)


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, C, C]``, normalised by ``C H W``."""
    B, H, W, C = feat.shape
    f = feat.reshape(B, H * W, C)
    return torch.einsum("bnc,bnd->bcd", f, f) / (C * H * W)


def gan_loss_lsgan(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    target = 1.0 if target_is_real else 0.0
    return torch.mean((pred - target) ** 2)


def multiscale_gan_loss(preds, target_is_real: bool) -> torch.Tensor:
    """Sum over the scales of the loss of each scale's last output."""
    total = 0.0
    for scale_outputs in preds:
        total = total + gan_loss_lsgan(scale_outputs[-1], target_is_real)
    return total
