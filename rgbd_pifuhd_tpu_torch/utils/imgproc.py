"""The OpenCV image operations of the training data path, in NumPy: the
colour jitter's RGB <-> HSV conversions and Gaussian blur, and the 8-bit
Gaussian blur of the generator's backgrounds.

- ``rgb_to_hsv`` / ``hsv_to_rgb``: ``cv2.cvtColor`` with
  ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` on uint8 (H in [0, 180)).  RGB ->
  HSV is OpenCV's integer path (12-bit reciprocal tables), HSV -> RGB its
  float32 paths (vectorised and scalar).  Both are equal to OpenCV's (as
  built for AVX2) on every input: all 2^24 RGB values, all 180 x 2^16 HSV
  values, in rows of 1, 33, 40, 64, 96 and 128 pixels.
- ``gaussian_blur``: ``cv2.GaussianBlur(x, (0, 0), sigma)`` on float32:
  the kernel size from sigma (``round(8 sigma + 1) | 1``), the separable
  kernel normalised in float64 and rounded to float32, reflected borders
  (``BORDER_REFLECT_101``); summed in float64 here, so within float32
  rounding of OpenCV's float32 sums.
- ``gaussian_blur_u8``: ``cv2.GaussianBlur(x, (k, k), 0)`` on uint8, which
  OpenCV 4+ computes bit-exactly in fixed point: a kernel of 8 fractional
  bits (error-diffused rounding, the centre tap taking the rest of 256),
  exact integer sums, and one rounding at the end.
"""

from __future__ import annotations

import numpy as np

_HSV_SHIFT = 12


def _round(x) -> np.ndarray:
    """``saturate_cast<int>(double)``: round half to even."""
    return np.rint(x).astype(np.int64)


_SDIV = np.zeros(256, np.int64)
_SDIV[1:] = _round((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV180 = np.zeros(256, np.int64)
_HDIV180[1:] = _round((180 << _HSV_SHIFT)
                      / (6.0 * np.arange(1, 256, dtype=np.float64)))


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` on ``[..., 3]`` uint8."""
    x = np.asarray(rgb).astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).clip(0, 255).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` on ``[H, W, 3]`` uint8, H in
    [0, 180).  OpenCV computes in float32, and its compiler fuses ``1 - s
    h`` and ``1 - s (1 - h)`` into one multiply-add each (emulated here in
    float64, where the product is exact); each row's leading multiple of
    32 pixels takes the vectorised loop, which truncates the result, the
    rest of the row the scalar loop, which rounds it."""
    x = np.asarray(hsv)
    f32, f64 = np.float32, np.float64
    h = x[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = x[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = x[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.trunc(h)
    frac = (h - sector).astype(f32)
    sector = (sector - np.trunc(sector * f32(1.0 / 6.0)) * f32(6.0)
              ).astype(np.int64)
    tab = np.stack([
        v, v * (f32(1.0) - s),
        v * (1.0 - s.astype(f64) * frac).astype(f32),
        v * (1.0 - s.astype(f64) * (f32(1.0) - frac)).astype(f32)], axis=-1)
    # sector -> the (b, g, r) entries of tab
    sector_data = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                            [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    rgb = np.take_along_axis(tab, sector_data[sector], axis=-1)[..., ::-1]
    rgb = rgb * f32(255.0)
    vec = x.shape[-2] // 32 * 32
    out = np.concatenate([np.trunc(rgb[..., :vec, :]),
                          np.rint(rgb[..., vec:, :])], axis=-2)
    return np.clip(out, 0, 255).astype(np.uint8)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source index of each of the ``n + 2 r`` padded positions."""
    i = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _sep_filter(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable correlation of ``x [H, W, ...]`` with ``k`` along rows,
    then columns, reflected borders; in ``x``'s dtype arithmetic."""
    r = len(k) // 2
    for axis in (1, 0):
        n = x.shape[axis]
        p = np.take(x, _reflect101(n, r), axis=axis)
        acc = None
        for i in range(len(k)):
            t = k[i] * np.take(p, np.arange(i, i + n), axis=axis)
            acc = t if acc is None else acc + t
        x = acc
    return x


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` in float64."""
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k * (1.0 / k.sum())


def gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` on float32 ``[H, W(, C)]``."""
    ksize = int(np.rint(sigma * 4 * 2 + 1)) | 1
    k = _gaussian_kernel(ksize, sigma).astype(np.float32).astype(np.float64)
    return _sep_filter(np.asarray(x, np.float64), k).astype(np.float32)


def _fixed_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's bit-exact 8-bit Gaussian kernel (``ufixedpoint16``):
    error-diffused rounding of each tap times 256 from the edge inwards,
    the centre tap the rest of 256."""
    k = _gaussian_kernel(ksize, sigma)
    out = np.zeros(ksize, np.int64)
    err = 0.0
    half = ksize // 2
    for i in range(half):
        adj = k[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
    out[half] = 256 - 2 * out[:half].sum()
    return out


def gaussian_blur_u8(x: np.ndarray, ksize: int,
                     sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(x, (ksize, ksize), sigma)`` on uint8
    ``[H, W(, C)]``: exact integer sums, one round-half-up at the end."""
    k = _fixed_kernel(ksize, sigma)
    acc = _sep_filter(np.asarray(x).astype(np.int64), k)
    return np.clip((acc + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
