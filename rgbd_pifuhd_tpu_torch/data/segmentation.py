"""Person segmentation and foreground cropping (port of
``data/segmentation.py``), without OpenCV:

- ``segment_person_grabcut``: GrabCut seeded by the person rect, as
  ``cv2.grabCut(..., GC_INIT_WITH_RECT)`` computes it, in host C++
  (``native/grabcut.cc``: k-means-initialised colour GMMs, 8-neighbour
  n-links, a Boykov-Kolmogorov min cut per round).  Where OpenCV raises
  (an empty rect, no pixel outside it, a singular colour model) the result
  is the rect itself, as in the JAX package;
- ``crop_people``: the foreground of an image file on a flat background
  (255, white, by default), in OpenCV's BGR order;
- ``ExternalSegmenter``: the plug-point for an external segmenter with the
  same ``(image, rect) -> mask`` contract.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np

from ..native import load_grabcut
from ..utils.imageio import imread_rgb8

GC_FGD, GC_PR_FGD = 1, 3


def segment_person_grabcut(img: np.ndarray, rect=None,
                           iters: int = 3) -> np.ndarray:
    """Foreground mask [H, W] bool via GrabCut seeded by ``rect``.

    rect = (x, y, w, h); defaults to the central 80% of the frame.
    """
    H, W = img.shape[:2]
    if rect is None:
        rect = (int(W * 0.1), int(H * 0.05), int(W * 0.8), int(H * 0.9))
    src = np.ascontiguousarray(img[:, :, :3])
    mask = np.zeros((H, W), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    x, y, w, h = (int(v) for v in rect)
    rc = 1                      # OpenCV takes 8-bit, 3-channel images only
    if src.dtype == np.uint8 and src.shape[2] == 3:
        rc = load_grabcut().grabcut_rect(src.ctypes.data_as(u8p), H, W, x,
                                         y, w, h, int(iters),
                                         mask.ctypes.data_as(u8p))
    if rc != 0:
        out = np.zeros((H, W), bool)
        out[y:y + h, x:x + w] = True
        return out
    return (mask == GC_FGD) | (mask == GC_PR_FGD)


def crop_people(img_path: str, rect=None,
                segmenter: Callable | None = None,
                background: int = 255) -> np.ndarray:
    """``[H, W, 3]`` uint8 BGR (as ``cv2.imread`` gives) with the pixels
    off the person set to ``background`` (255, white, by default; 0 for
    the black fill of training tooling)."""
    rgb = imread_rgb8(img_path)
    if rgb is None:
        raise ValueError(f"{img_path}: not an image file")
    img = np.ascontiguousarray(rgb[:, :, ::-1])
    seg = segmenter or segment_person_grabcut
    mask = seg(img, rect)
    out = img.copy()
    out[~mask] = background
    return out


class ExternalSegmenter:
    """Adapter for an external segmentation service or model: constructed
    with a callable that maps an image to a [H, W] float foreground score;
    called with an image (and an ignored rect) it returns the mask."""

    def __init__(self, score_fn: Callable[[np.ndarray], np.ndarray],
                 threshold: float = 0.5):
        self.score_fn = score_fn
        self.threshold = threshold

    def __call__(self, img: np.ndarray, rect=None) -> np.ndarray:
        return self.score_fn(img) > self.threshold
