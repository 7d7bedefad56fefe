"""Inference dataset reader (port of ``data/readdata.py``).

Scans ``dataroot`` for images that have a sibling ``<name>_rect.txt``;
``depth/depth_<name>.png`` is the depth image (zeros when missing).  Each
item crops the person rect (zero-padded), builds the rect's NDC transform,
resizes to ``load_size`` (local) and 512 (global) and returns the data
dict ``Reconstructor`` takes.  RGB and depth are concatenated to ``[H, W,
6]``.  ``calib = diag(1, -1, 1, 1)`` (y flip); ``calib_world`` is the rect's
NDC transform.

Images are decoded by the port itself: ``utils/png.py`` (PNG) and
``utils/jpeg.py`` (baseline JPEG), each giving what ``cv2.imread``, which
the JAX package's reader calls, gives.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from ..utils import jpeg, png
from .preprocessing import addrect, prepare_stack, rect_to_ndc_transform

_IMG_EXT = (".jpg", ".jpeg", ".png")


def _read_image(path: str) -> np.ndarray:
    if path.lower().endswith((".jpg", ".jpeg")):
        return jpeg.read_rgb8(path)
    return png.read_rgb8(path)


class InferenceDataset:
    def __init__(self, dataroot: str, load_size: int = 1024,
                 projection: str = "orthogonal"):
        self.root = dataroot
        self.load_size = load_size
        self.projection_mode = projection
        files = sorted(os.listdir(dataroot)) if os.path.isdir(dataroot) \
            else []
        self.items = []
        for f in files:
            stem, ext = os.path.splitext(f)
            if ext.lower() not in _IMG_EXT:
                continue
            rect = os.path.join(dataroot, f"{stem}_rect.txt")
            if os.path.exists(rect):
                self.items.append((os.path.join(dataroot, f), rect, stem))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> dict[str, Any]:
        img_path, rect_path, name = self.items[index]
        depth_path = os.path.join(self.root, "depth", f"depth_{name}.png")

        im = _read_image(img_path)
        depth = png.read_rgb8(depth_path) if os.path.exists(depth_path) \
            else np.zeros_like(im)
        h, w = im.shape[:2]

        rects = np.loadtxt(rect_path, dtype=np.int64)
        if rects.ndim == 1:
            rects = rects[None]
        rect = rects[0]

        im = addrect(im, rect)
        depth = addrect(depth, rect)
        trans_mat = rect_to_ndc_transform(rect, w, h, flip_y=False)

        calib = np.identity(4, dtype=np.float32)
        calib[1, 1] = -1.0
        return {
            "name": name,
            # [B2=1, H, W, 6] and [1, 512, 512, 6]
            "img": prepare_stack(im, depth, self.load_size)[None],
            "img_512": prepare_stack(im, depth, 512)[None],
            "calib": calib,
            "calib_world": trans_mat.astype(np.float32),
            "b_min": np.array([-1.0, -1.0, -1.0]),
            "b_max": np.array([1.0, 1.0, 1.0]),
        }
