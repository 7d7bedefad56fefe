"""Background compositing of training images (port of
``data/composite.py``): each subject's front render (``RENDER/<s>/
0_0_00.jpg``) over a background wherever its mask is set, written as
``gen/<s>_<i>.png``, the images ``TrainDataset`` reads.  Backgrounds are
read from a directory of JPEG / PNG files as ``cv2.imread`` reads them
(``utils.imageio``) and resized as ``cv2.resize`` resizes them
(``data.preprocessing.resize_image``); without one, uniform noise under
OpenCV's 31 x 31 Gaussian blur (``utils.imgproc.gaussian_blur_u8``, bit
for bit).  The random draws come in the JAX package's order from one
``default_rng(seed)``, and arrays are composed in BGR as OpenCV's are.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.imageio import imread_rgb8
from ..utils.imgproc import gaussian_blur_u8
from ..utils.jpeg import read_rgb8 as read_jpeg
from ..utils.png import read_png, write_png
from .preprocessing import resize_image


def _imread_bgr(path: str) -> np.ndarray:
    img = imread_rgb8(path)
    if img is None:
        raise ValueError(f"{path}: not an image file")
    return img[:, :, ::-1]


def composite_over_backgrounds(
    dataroot: str,
    background_dir: str | None = None,
    per_subject: int = 1,
    seed: int = 0,
) -> list[str]:
    """RENDER/<s>/0_0_00.jpg + MASK -> gen/<s>_<i>.png composites; returns
    the written paths."""
    rng = np.random.default_rng(seed)
    render_dir = os.path.join(dataroot, "RENDER")
    mask_dir = os.path.join(dataroot, "MASK")
    gen_dir = os.path.join(dataroot, "gen")
    os.makedirs(gen_dir, exist_ok=True)

    bgs = []
    if background_dir and os.path.isdir(background_dir):
        bgs = [
            os.path.join(background_dir, f)
            for f in sorted(os.listdir(background_dir))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        ]

    written = []
    for subject in sorted(os.listdir(render_dir)):
        rp = os.path.join(render_dir, subject, "0_0_00.jpg")
        mp = os.path.join(mask_dir, subject, "0_0_00.png")
        if not (os.path.exists(rp) and os.path.exists(mp)):
            continue
        render = read_jpeg(rp)[:, :, ::-1]
        m = read_png(mp)
        mask = (m if m.ndim == 2 else m[:, :, 0]) > 127
        H, W = render.shape[:2]
        for i in range(per_subject):
            if bgs:
                bg = _imread_bgr(bgs[int(rng.integers(len(bgs)))])
                bg = resize_image(bg, (W, H))
            else:
                bg = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
                bg = gaussian_blur_u8(bg, 31)
            comp = np.where(mask[:, :, None], render, bg)
            out = os.path.join(gen_dir, f"{subject}_{i}.png")
            write_png(out, np.ascontiguousarray(comp[:, :, ::-1]))
            written.append(out)
    return written
