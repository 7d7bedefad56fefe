"""Training / evaluation datasets over a training tree (port of
``data/datasets.py``), laid out as the generator writes it:

    gen/<subject>_<i>.png        background-composited renders (train input)
    RENDER/<subject>/<y>_<p>_<q>.jpg
    MASK/<subject>/...png  DEPTH/<subject>/...png  NORM/<subject>/...png
    PARAM/<subject>/<y>_<p>_<q>.npy   {ortho_ratio, scale, center, R}
    OBJ/<subject>_100k.obj
    normal/Fnormal.jpg, Bnormal.jpg   style images

Items are NumPy NHWC dicts with the RGB-D stack concatenated
([H, W, 6]); points / labels are [N, 3] / [N, 1].  Images are read with the
port's PNG and JPEG decoders (the pixels ``cv2.imread`` gives), the colour
jitter runs on ``utils.imgproc``, and every random draw comes from one
``default_rng(seed)`` in the JAX reader's order, so ``samples``, ``labels``
and crop rects are byte-equal to its items.  The random crop (``use_crop``)
is ``[256, U(10, 512), 512, 512]`` out of the 1024 render, its NDC transform
folded into ``calib_local``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from ..recon.mesh import load_obj
from ..utils import imgproc, jpeg, png
from .containment import MeshContainmentTester
from .preprocessing import (
    addrect,
    normalize_image,
    rect_to_ndc_transform,
    resize_image,
)
from .sampling import sample_occupancy_points

# the fixed sampling boxes of training and evaluation
TRAIN_B_MIN = np.array([-256.0, -28.0, -562.0])
TRAIN_B_MAX = np.array([0.0, 228.0, -306.0])
EVAL_B_MIN = np.array([-384.0, -28.0, -384.0])
EVAL_B_MAX = np.array([-128.0, 228.0, -128.0])


def _calib_from_param(param: dict, load_size: int):
    """PARAM npy dict -> (calib [4,4], extrinsic [4,4]): extrinsic from
    R / center, intrinsic from scale / ortho_ratio with a y-flip, uv scale
    1 / (load_size // 2)."""
    ortho_ratio = float(param["ortho_ratio"])
    scale = float(param["scale"])
    center = np.asarray(param["center"], np.float64).reshape(3)
    R = np.asarray(param["R"], np.float64).reshape(3, 3)

    translate = -(R @ center).reshape(3, 1)
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = R
    extrinsic[:3, 3:4] = translate

    s = scale / ortho_ratio
    scale_intr = np.diag([s, -s, s, 1.0])
    uv = np.diag([1.0 / (load_size // 2)] * 3 + [1.0])
    intrinsic = uv @ scale_intr
    return intrinsic @ extrinsic, extrinsic


class TrainDataset:
    """Training dataset; one item per augmented render in gen/."""

    def __init__(self, opt, phase: str = "train", load_mesh: bool = True,
                 use_crop: bool = False, seed: int = 0,
                 b_min=TRAIN_B_MIN, b_max=TRAIN_B_MAX, max_subjects=None,
                 imread=None):
        self.opt = opt
        # RGB reader of the renders and maps: ``png.read_rgb8`` unless the
        # caller gives one (a per-process cache, ``train_bench_flagship``)
        self.imread = imread or png.read_rgb8
        self.projection_mode = "orthogonal"
        self.root = opt.dataroot
        self.is_train = phase == "train"
        self.use_crop = use_crop
        self.load_mesh = load_mesh
        if isinstance(b_min, str):
            self.b_min, self.b_max = b_min, b_max  # 'auto'
        else:
            self.b_min, self.b_max = np.asarray(b_min), np.asarray(b_max)
        self.rng = np.random.default_rng(seed)

        gen_dir = os.path.join(self.root, "gen")
        files = sorted(os.listdir(gen_dir)) if os.path.isdir(gen_dir) else []
        self.img_files = [
            os.path.join(gen_dir, f) for f in files if f.endswith(".png")
        ]

        self.meshes: dict[str, tuple] = {}
        self.testers: dict[str, MeshContainmentTester] = {}
        if load_mesh:
            obj_dir = os.path.join(self.root, "OBJ")
            objs = (sorted(os.listdir(obj_dir)) if os.path.isdir(obj_dir)
                    else [])
            if max_subjects is not None:
                objs = objs[:max_subjects]
            for f in objs:
                if f.endswith("_100k.obj"):
                    v, fc, _ = load_obj(os.path.join(obj_dir, f))
                    self.meshes[f[:-9]] = (v, fc)
                    self.testers[f[:-9]] = MeshContainmentTester(v, fc)

        self._style_cache = None

    def __len__(self) -> int:
        return len(self.img_files)

    # ---------------------------------------------------------------- io
    def _load_styles(self, size: int):
        if self._style_cache is None:
            out = []
            for n in ("Fnormal.jpg", "Bnormal.jpg"):
                p = os.path.join(self.root, "normal", n)
                img = jpeg.read_rgb8(p) if os.path.exists(p) else np.full(
                    (size, size, 3), 127, np.uint8)
                out.append(normalize_image(resize_image(img, size)))
            self._style_cache = out
        return self._style_cache

    def _color_jitter(self, rgb: np.ndarray) -> np.ndarray:
        """Brightness / contrast / saturation / hue / blur augmentation of
        the RGB render (never depth or normal maps), gated on
        ``opt.use_aug`` and the train phase."""
        o = self.opt
        if not (self.is_train and getattr(o, "use_aug", False)):
            return rgb

        r = self.rng
        x = rgb.astype(np.float32) / 255.0
        if o.aug_bri > 0:
            x = x * (1.0 + r.uniform(-o.aug_bri, o.aug_bri))
        if o.aug_con > 0:
            c = 1.0 + r.uniform(-o.aug_con, o.aug_con)
            m = x.mean()
            x = (x - m) * c + m
        if o.aug_sat > 0:
            s = 1.0 + r.uniform(-o.aug_sat, o.aug_sat)
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            x = gray[..., None] + (x - gray[..., None]) * s
        x = np.clip(x, 0.0, 1.0)
        if o.aug_hue > 0:
            hsv = imgproc.rgb_to_hsv((x * 255).astype(np.uint8)).astype(
                np.int16)
            hsv[..., 0] = (hsv[..., 0]
                           + int(r.uniform(-o.aug_hue, o.aug_hue) * 180)) % 180
            x = imgproc.hsv_to_rgb(hsv.astype(np.uint8)).astype(
                np.float32) / 255.0
        if o.aug_blur > 0:
            sigma = float(r.uniform(0.0, o.aug_blur))
            if sigma > 1e-3:
                x = imgproc.gaussian_blur(x, sigma)
        return (np.clip(x, 0.0, 1.0) * 255).astype(rgb.dtype)

    def __getitem__(self, index: int) -> dict[str, Any]:
        render_path = self.img_files[index]
        stem = os.path.splitext(os.path.basename(render_path))[0]
        subject = "_".join(stem.split("_")[:-1])
        o = self.opt

        def sub(d, name):
            return os.path.join(self.root, d, subject, name)

        def read(path):        # RGB; a missing map reads as zeros
            return self.imread(path) if os.path.exists(path) else None

        param = np.load(sub("PARAM", "0_0_00.npy"), allow_pickle=True).item()
        render = self._color_jitter(self.imread(render_path))
        depth, imF, imB = (read(sub("DEPTH", "0_0_00.png")),
                           read(sub("NORM", "0_0_00.png")),
                           read(sub("NORM", "180_0_00.png")))
        depth, imF, imB = (np.zeros_like(render) if x is None else x
                           for x in (depth, imF, imB))

        big, local = o.load_size_big, o.load_size_local
        calib, extrinsic = _calib_from_param(param, o.load_size)
        intr_local = calib @ np.linalg.inv(extrinsic)

        img_big = resize_image(render, big)
        dep_big = resize_image(depth, big)
        if self.use_crop:
            rect = [256, int(self.rng.integers(10, 512)), 512, 512]
            img_big = addrect(resize_image(render, 1024), rect)
            dep_big = addrect(resize_image(depth, 1024), rect)
            trans = rect_to_ndc_transform(rect, 1024, 1024, flip_y=True)
            intr_local = trans @ intr_local
        calib_local = intr_local @ extrinsic

        def stack(rgb, dep):
            return np.concatenate(
                [normalize_image(rgb), normalize_image(dep)], axis=-1)

        res = {
            "name": subject,
            "img": stack(img_big, dep_big)[None],              # [1, H, W, 6]
            "img_512": stack(resize_image(render, local),
                             resize_image(depth, local)),       # [h, w, 6]
            "imF": normalize_image(resize_image(imF, big)),
            "imB": normalize_image(resize_image(imB, big)),
            "calib": calib.astype(np.float32),
            "calib_local": calib_local.astype(np.float32),
            "b_min": None if isinstance(self.b_min, str) else self.b_min,
            "b_max": None if isinstance(self.b_max, str) else self.b_max,
        }
        f_style, b_style = self._load_styles(big)
        res["Fstyle"], res["Bstyle"] = f_style, b_style

        if self.load_mesh and subject in self.meshes:
            v, fc = self.meshes[subject]
            if isinstance(self.b_min, str):  # 'auto': per-subject box
                lo, hi = v.min(axis=0), v.max(axis=0)
                margin = 0.15 * (hi - lo)
                b_min, b_max = lo - margin, hi + margin
            else:
                b_min, b_max = self.b_min, self.b_max
            samples, labels = sample_occupancy_points(
                v, fc, o.num_sample_inout, b_min, b_max,
                self.rng, sigma=o.sigma, tester=self.testers[subject],
            )
            res["samples"] = samples
            res["labels"] = labels
            res["b_min"], res["b_max"] = np.asarray(b_min), np.asarray(b_max)
        return res


class EvalDataset(TrainDataset):
    """Evaluation variant: no crop, the evaluation box, the first 4
    subjects."""

    def __init__(self, opt, **kw):
        kw.setdefault("b_min", EVAL_B_MIN)
        kw.setdefault("b_max", EVAL_B_MAX)
        kw.setdefault("max_subjects", 4)
        super().__init__(opt, phase="eval", use_crop=False, **kw)
