"""Image preprocessing of the readers (port of ``data/preprocessing.py``).

``addrect`` is the zero-padded person-rect crop, ``rect_to_ndc_transform``
the calibration of that crop, ``normalize_image`` the map to ``[-1, 1]``.
``resize_image`` reproduces ``cv2.resize``'s default (``INTER_LINEAR``,
half-pixel centres, no antialiasing) on uint8 images pixel for pixel, with
OpenCV's fixed-point scheme: 11-bit horizontal and vertical weights, the
intermediate row sums kept as integers.  As in OpenCV, a column outside the
source is clamped to the edge with its weight, while a row outside it keeps
its fractional weights and reads the edge row twice (which rounds
differently in fixed point when upscaling).

``prepare_map`` / ``prepare_stack`` are ``normalize_image(resize_image(...))``
and the RGB-D ``concatenate`` of two such maps, bit for bit.  A uint8 map
takes one native pass (``native/imageprep.cc``: the same fixed-point resize
and float32 map, written straight into the output's channels, the GIL
released); any other dtype takes the NumPy chain.
"""

from __future__ import annotations

import ctypes

import numpy as np


def addrect(img: np.ndarray, rect) -> np.ndarray:
    """Crop ``rect=(x, y, w, h)`` out of ``img``; out-of-frame regions are
    black."""
    x, y, w, h = [int(v) for v in rect]
    H, W = img.shape[:2]
    out = np.zeros((h, w) + img.shape[2:], dtype=img.dtype)
    src_x0, src_y0 = max(x, 0), max(y, 0)
    src_x1, src_y1 = min(x + w, W), min(y + h, H)
    if src_x1 > src_x0 and src_y1 > src_y0:
        dst_x0, dst_y0 = src_x0 - x, src_y0 - y
        out[dst_y0:dst_y0 + (src_y1 - src_y0),
            dst_x0:dst_x0 + (src_x1 - src_x0)] = (
            img[src_y0:src_y1, src_x0:src_x1])
    return out


def rect_to_ndc_transform(rect, img_w: int, img_h: int,
                          flip_y: bool = False) -> np.ndarray:
    """4x4 NDC transform of a person-rect crop.  ``flip_y=False`` is the
    inference reader's sign, ``True`` the training crop's."""
    x, y, w, h = [int(v) for v in rect]
    trans = np.identity(4)
    scale_im2ndc = 1.0 / float(img_w // 2)
    scale = img_w / w
    trans *= scale
    trans[3, 3] = 1.0
    trans[0, 3] = -scale * (x + w // 2 - img_w // 2) * scale_im2ndc
    sy = -1.0 if flip_y else 1.0
    trans[1, 3] = sy * scale * (y + h // 2 - img_h // 2) * scale_im2ndc
    return trans


def normalize_image(img: np.ndarray) -> np.ndarray:
    """HWC uint8 / float ``[0, 255]`` -> float32 HWC in ``[-1, 1]``."""
    img = np.asarray(img, dtype=np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img * 2.0 - 1.0


def _taps(n_dst: int, n_src: int, clamp_frac: bool = True):
    """Left tap index and the fraction towards the right tap for each
    destination coordinate (half-pixel centres, indices clamped at the
    borders; the fraction too where ``clamp_frac``, as OpenCV does for
    columns but not rows)."""
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0).astype(np.float32)
    if clamp_frac:
        frac[i0 < 0] = 0.0
        frac[i0 >= n_src - 1] = 0.0
    return (np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1),
            frac)


def resize_image(img: np.ndarray, size) -> np.ndarray:
    """Resize HWC (or HW) to ``(size, size)``, or to ``size = (width,
    height)`` (``cv2.resize``'s ``dsize``), bilinear as ``cv2.resize``."""
    a = np.asarray(img)
    H, W = a.shape[:2]
    w_out, h_out = (size, size) if np.isscalar(size) else size
    if (H, W) == (h_out, w_out):
        return a.copy()
    y0, y1, fy = _taps(h_out, H, clamp_frac=False)
    x0, x1, fx = _taps(w_out, W)
    flat = a.reshape(H, W, -1)
    if a.dtype == np.uint8:
        # OpenCV's 8-bit path: weights in 1/2048 units (rounded to
        # nearest), horizontal sums as int32, then the vertical pass
        # ((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
        ax1 = np.rint(fx * 2048.0).astype(np.int32)
        ax0 = np.rint((1.0 - fx) * 2048.0).astype(np.int32)
        by1 = np.rint(fy * 2048.0).astype(np.int32)
        by0 = np.rint((1.0 - fy) * 2048.0).astype(np.int32)
        src = flat.astype(np.int32)
        rows = (src[:, x0] * ax0[None, :, None]
                + src[:, x1] * ax1[None, :, None])
        s0, s1 = rows[y0] >> 4, rows[y1] >> 4
        out = (((by0[:, None, None] * s0) >> 16)
               + ((by1[:, None, None] * s1) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        src = flat.astype(np.float32)
        rows = (src[:, x0] * (1.0 - fx)[None, :, None]
                + src[:, x1] * fx[None, :, None])
        out = (rows[y0] * (1.0 - fy)[:, None, None]
               + rows[y1] * fy[:, None, None]).astype(a.dtype)
    return out.reshape((h_out, w_out) + a.shape[2:])


def _weights(frac: np.ndarray):
    """``resize_image``'s 8-bit weights of the left and right taps, in
    1/2048 units."""
    return (np.rint((1.0 - frac) * 2048.0).astype(np.int32),
            np.rint(frac * 2048.0).astype(np.int32))


def native_pass(img: np.ndarray) -> bool:
    """Whether ``prepare_map`` / ``prepare_stack`` take ``img`` through the
    native pass: uint8 maps do."""
    return img.dtype == np.uint8


def _prepare_into(img: np.ndarray, size, out: np.ndarray, c_off: int):
    """``normalize_image(resize_image(img, size))`` into ``out[..., c_off:
    c_off + C]``; ``out`` is a C-contiguous float32 ``[h, w, channels]``."""
    H, W = img.shape[:2]
    src = img.reshape(H, W, -1)
    C = src.shape[2]
    h_out, w_out, out_c = out.shape
    if not native_pass(img):
        out[..., c_off:c_off + C] = normalize_image(resize_image(src, size))
        return
    from ..native import load_imageprep

    lib = load_imageprep()
    src = np.ascontiguousarray(src)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    u8, i64, i32, f32 = (ctypes.c_uint8, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_float)
    if (H, W) == (h_out, w_out):
        lib.prep_same(p(src, u8), H * W, C, p(out, f32), out_c, c_off)
        return
    y0, y1, fy = _taps(h_out, H, clamp_frac=False)
    x0, x1, fx = _taps(w_out, W)
    (by0, by1), (ax0, ax1) = _weights(fy), _weights(fx)
    lib.prep_resized(p(src, u8), W, C, p(y0, i64), p(y1, i64), p(by0, i32),
                     p(by1, i32), h_out, p(x0, i64), p(x1, i64), p(ax0, i32),
                     p(ax1, i32), w_out, p(out, f32), out_c, c_off)


def _out_hw(size) -> tuple[int, int]:
    w_out, h_out = (size, size) if np.isscalar(size) else size
    return int(h_out), int(w_out)


def prepare_map(img: np.ndarray, size) -> np.ndarray:
    """``normalize_image(resize_image(img, size))`` of an HWC (or HW) map,
    bit for bit; ``size`` as ``resize_image`` takes it."""
    a = np.asarray(img)
    h, w = _out_hw(size)
    out = np.empty((h, w, int(np.prod(a.shape[2:]))), np.float32)
    _prepare_into(a, size, out, 0)
    return out.reshape((h, w) + a.shape[2:])


def prepare_stack(rgb: np.ndarray, depth: np.ndarray, size) -> np.ndarray:
    """``np.concatenate([prepare_map(rgb, size), prepare_map(depth, size)],
    -1)`` of two HWC maps: RGB in the first channels, depth after them."""
    rgb, depth = np.asarray(rgb), np.asarray(depth)
    h, w = _out_hw(size)
    c = rgb.shape[2]
    out = np.empty((h, w, c + depth.shape[2]), np.float32)
    _prepare_into(rgb, size, out, 0)
    _prepare_into(depth, size, out, c)
    return out
