"""Resize and pooling with PyTorch ``align_corners=True`` semantics on NHWC
(port of ``ops/resize.py``: the taps are computed once in NumPy, copied
once to each device, and the resize is a gather plus weighted sum per axis,
in the input's dtype)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a,
                 0.0),
    )


@functools.lru_cache(maxsize=256)
def _resize_taps(in_size: int, out_size: int, mode: str):
    if out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (
            out_size - 1)
    else:
        src = np.zeros((1,), dtype=np.float64)
    base = np.floor(src).astype(np.int64)
    t = src - base
    if mode == "bilinear":
        idx = np.stack([base, base + 1], axis=1)
        w = np.stack([1.0 - t, t], axis=1)
    elif mode == "bicubic":
        idx = np.stack([base - 1, base, base + 1, base + 2], axis=1)
        w = np.stack([_cubic_weight(1.0 + t), _cubic_weight(t),
                      _cubic_weight(1.0 - t), _cubic_weight(2.0 - t)], axis=1)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    idx = np.clip(idx, 0, in_size - 1)
    return idx.astype(np.int64), w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _device_taps(in_size: int, out_size: int, mode: str,
                 device: torch.device, dtype: torch.dtype):
    """``_resize_taps`` on ``device`` (index flat, weights ``[out, k]`` in
    ``dtype``), copied there once: a copy from pageable host memory waits
    for the device's queue, and a CUDA graph cannot hold one.  Made outside
    inference mode, so that training may save them for its backward."""
    idx, w = _resize_taps(in_size, out_size, mode)
    with torch.inference_mode(False):
        return (torch.from_numpy(idx.reshape(-1)).to(device),
                torch.from_numpy(w).to(device, dtype))


def _resize_axis(x: torch.Tensor, out_size: int, axis: int,
                 mode: str) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size and mode == "bilinear":
        return x
    idx, w = _device_taps(in_size, out_size, mode, x.device, x.dtype)
    k = w.shape[1]
    g = torch.index_select(x, axis, idx)
    shape = list(x.shape)
    shape[axis:axis + 1] = [out_size, k]
    g = g.reshape(shape)
    w_shape = [1] * len(shape)
    w_shape[axis] = out_size
    w_shape[axis + 1] = k
    return (g * w.reshape(w_shape)).sum(dim=axis + 1)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    x = _resize_axis(x, out_hw[0], 1, "bilinear")
    return _resize_axis(x, out_hw[1], 2, "bilinear")


def resize_bicubic_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    x = _resize_axis(x, out_hw[0], 1, "bicubic")
    return _resize_axis(x, out_hw[1], 2, "bicubic")


def upsample2x_bicubic(x: torch.Tensor) -> torch.Tensor:
    _, H, W, _ = x.shape
    return resize_bicubic_align_corners(x, (2 * H, 2 * W))


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0, count_include_pad: bool = True
               ) -> torch.Tensor:
    """``F.avg_pool2d`` on NHWC (a channels-last view, no copy, where the
    windows do not overlap).  Overlapping windows (``window > stride``) pool
    a contiguous NCHW copy: on the card, PyTorch 2.11's (CUDA 12.8)
    backward of such a pool over channels-last strides is wrong (up to
    half of the gradient's scale), the forward and the contiguous case
    right."""
    stride = window if stride is None else stride
    x = x.permute(0, 3, 1, 2)
    if window > stride:
        x = x.contiguous()
    y = F.avg_pool2d(x, window, stride, padding,
                     count_include_pad=count_include_pad)
    return y.permute(0, 2, 3, 1)
