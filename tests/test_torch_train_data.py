"""The port's training data against the JAX package's, on the CPU.

- ``ops/losses.py``: every loss within 1e-6 relative.
- ``data/sampling.py`` / ``data/containment.py``: byte-equal arrays for the
  same generator state.
- ``utils/jpeg.encode``: byte-equal to ``cv2.imencode('.jpg')`` (OpenCV's
  defaults: quality 95, 4:2:0), including sizes that are not whole MCUs.
- ``utils/imgproc``: RGB <-> HSV equal to ``cv2.cvtColor`` (max |diff| 0),
  the 8-bit 31 x 31 Gaussian blur equal to ``cv2.GaussianBlur`` (0), the
  float blur within 1e-5 (measured 1.8e-7).
- ``data/synthetic.py``: the port's tree against the JAX package's for one
  seed — OBJ text identical, PARAM values equal, every PNG's pixels equal
  (max |diff| 0), RENDER and style JPEGs byte-equal; ``rasterize_ortho``
  on ``raster.cc`` equal to the JAX package's.
- ``data/datasets.py``: ``TrainDataset`` / ``EvalDataset`` items on a tree
  the JAX package wrote, equal in both packages: ``samples``, ``labels``,
  ``calib``, ``calib_local``, ``b_min`` / ``b_max`` and every image exactly,
  with the crop on and off and the ``'auto'`` box; with the colour jitter
  on (brightness, contrast, saturation, hue, blur) the images within one
  grey level (2/255 normalised: the float blur's rounding can move a
  truncation), the rest exactly.
- ``data/prefetch.py``: batches come out in order whatever the threads do.
"""

import dataclasses
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.data import containment as jcont
from rgbd_pifuhd_tpu.data import datasets as jds
from rgbd_pifuhd_tpu.data import sampling as jsamp
from rgbd_pifuhd_tpu.data import synthetic as jsyn
from rgbd_pifuhd_tpu.ops import losses as jloss
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.data import containment as tcont
from rgbd_pifuhd_tpu_torch.data import datasets as tds
from rgbd_pifuhd_tpu_torch.data import prefetch as tpre
from rgbd_pifuhd_tpu_torch.data import sampling as tsamp
from rgbd_pifuhd_tpu_torch.data import synthetic as tsyn
from rgbd_pifuhd_tpu_torch.ops import losses as tloss
from rgbd_pifuhd_tpu_torch.utils import imgproc, jpeg
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions

SUBJECTS = ("sphere", "capsule", "bumpy")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    j, t = str(base / "jax"), str(base / "port")
    jsyn.generate_synthetic_dataset(j, SUBJECTS, size=128, load_size=128,
                                    seed=3)
    tsyn.generate_synthetic_dataset(t, SUBJECTS, size=128, load_size=128,
                                    seed=3)
    return j, t


# ------------------------------------------------------------------ losses
def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("case", ["mse", "l1", "bce", "bce_w", "bce_brock",
                                  "gram", "gan", "multiscale_gan"])
def test_losses(case, rng):
    p = rng.uniform(0, 1, (2, 50, 1)).astype(np.float32)
    g = (rng.uniform(0, 1, (2, 50, 1)) > 0.5).astype(np.float32)
    gam = rng.uniform(0.2, 0.8, 2).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 2).astype(np.float32)
    f = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    if case in ("mse", "l1"):
        a = getattr(tloss, case)(T(p), T(g))
        b = getattr(jloss, case)(J(p), J(g))
    elif case.startswith("bce"):
        kw = dict(brock=case == "bce_brock")
        a = tloss.custom_bce(T(p), T(g), T(gam),
                             T(w) if case == "bce_w" else None, **kw)
        b = jloss.custom_bce(J(p), J(g), J(gam),
                             J(w) if case == "bce_w" else None, **kw)
    elif case == "gram":
        a, b = tloss.gram_matrix(T(f)), jloss.gram_matrix(J(f))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
        return
    elif case == "gan":
        a = tloss.gan_loss_lsgan(T(p), True) + tloss.gan_loss_lsgan(T(p),
                                                                    False)
        b = jloss.gan_loss_lsgan(J(p), True) + jloss.gan_loss_lsgan(J(p),
                                                                    False)
    else:
        preds = [[T(f), T(p)], [T(g)]]
        a = tloss.multiscale_gan_loss(preds, True)
        b = jloss.multiscale_gan_loss([[J(x.numpy()) for x in s]
                                       for s in preds], True)
    assert _rel(a, b) <= 1e-6


# ------------------------------------------------------ sampling, containment
def test_sampling_and_containment_byte_equal():
    v, f = jsyn.make_bumpy_sphere(subdiv=3)
    v = jsyn.normalize_mesh_height(v) + jsyn.SUBJECT_CENTER
    for seed in (0, 1):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        sj, lj = jsamp.sample_occupancy_points(
            v, f, 500, jds.TRAIN_B_MIN, jds.TRAIN_B_MAX, rj, sigma=4.0)
        st, lt = tsamp.sample_occupancy_points(
            v, f, 500, tds.TRAIN_B_MIN, tds.TRAIN_B_MAX, rt, sigma=4.0)
        assert sj.tobytes() == st.tobytes() and lj.tobytes() == lt.tobytes()
        assert 0 < lt.sum() < len(lt)
    pts = np.random.default_rng(2).uniform(v.min(0) - 5, v.max(0) + 5,
                                           (4000, 3))
    a = jcont.points_in_mesh(pts, v, f)
    b = tcont.points_in_mesh(pts, v, f)
    assert np.array_equal(a, b) and 0 < b.sum() < len(b)
    assert np.array_equal(tsamp.sample_surface_points(
        v, f, 64, np.random.default_rng(4)), jsamp.sample_surface_points(
        v, f, 64, np.random.default_rng(4)))


# ------------------------------------------------------------ cv2 in NumPy
def _smooth(rng, h, w):
    base = (rng.random((h, w, 3)) * 40).cumsum(0).cumsum(1)
    return (base / base.max() * 255).astype(np.uint8)


@pytest.mark.parametrize("shape,kind", [((128, 128), "smooth"),
                                        ((64, 64), "noise"),
                                        ((97, 131), "smooth"),
                                        ((17, 9), "noise"),
                                        ((33, 50), "noise")])
def test_jpeg_encoder_writes_cv2_bytes(rng, shape, kind):
    img = _smooth(rng, *shape) if kind == "smooth" else rng.integers(
        0, 256, shape + (3,), dtype=np.uint8)
    ok, ref = cv2.imencode(".jpg", img[:, :, ::-1])
    mine = jpeg.encode(img)
    assert ok and mine == ref.tobytes()
    assert np.array_equal(jpeg.decode(mine), cv2.imdecode(
        ref, cv2.IMREAD_COLOR)[:, :, ::-1])


@pytest.mark.parametrize("width", [128, 100, 40, 1])
def test_hsv_conversions_match_cv2(rng, width):
    img = rng.integers(0, 256, (64, width, 3), dtype=np.uint8)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    assert np.array_equal(imgproc.rgb_to_hsv(img), hsv)
    hsv[..., 0] = (hsv[..., 0].astype(int) + 37) % 180
    assert np.array_equal(imgproc.hsv_to_rgb(hsv),
                          cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_gaussian_blurs_match_cv2(rng):
    for sigma in (0.3, 0.9, 1.4):
        x = rng.random((48, 40, 3)).astype(np.float32)
        d = np.abs(imgproc.gaussian_blur(x, sigma)
                   - cv2.GaussianBlur(x, (0, 0), sigma))
        assert d.max() <= 1e-5
    for shape in ((128, 128, 3), (40, 23, 3)):
        bg = rng.integers(0, 255, shape, dtype=np.uint8)
        assert np.array_equal(imgproc.gaussian_blur_u8(bg, 31),
                              cv2.GaussianBlur(bg, (31, 31), 0))


# ---------------------------------------------------------------- the tree
def test_rasterizer_matches_jax():
    v, f = jsyn.make_capsule(1.6, 0.55, 3)
    v = jsyn.normalize_mesh_height(v) + jsyn.SUBJECT_CENTER
    calib = tsyn.capsule_calib(96, 96, yaw=30.0)
    shade = np.linspace(0.5, 1.0, len(v))
    for kw in ({}, {"vert_shade": shade}):
        a = jsyn.rasterize_ortho(v, f, 96, calib, **kw)
        b = tsyn.rasterize_ortho(v, f, 96, calib, **kw)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert b["mask"].sum() > 500


def test_tree_matches_jax_tree(trees):
    j, t = trees
    n = 0
    for root, _, files in os.walk(j):
        for fn in files:
            pa = os.path.join(root, fn)
            pb = os.path.join(t, os.path.relpath(pa, j))
            n += 1
            if fn.endswith(".obj"):
                assert open(pa).read() == open(pb).read(), pb
            elif fn.endswith(".npy"):
                a = np.load(pa, allow_pickle=True).item()
                b = np.load(pb, allow_pickle=True).item()
                assert set(a) == set(b)
                assert all(np.array_equal(a[k], b[k]) for k in a), pb
            elif fn.endswith(".png"):
                a = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
                b = cv2.imread(pb, cv2.IMREAD_UNCHANGED)
                assert a.shape == b.shape and np.array_equal(a, b), pb
            else:
                assert fn.endswith(".jpg")
                assert open(pa, "rb").read() == open(pb, "rb").read(), pb
    assert n == 3 * (1 + 2 * 5 + 1) + 2


# -------------------------------------------------------------- the reader
def _opts(root, **kw):
    common = dict(dataroot=root, load_size=128, load_size_big=128,
                  load_size_local=64, num_sample_inout=400, sigma=3.0, **kw)
    return JOptions(**common), TOptions(**common)


def _assert_items(a, b, image_tol=0.0):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if x is None or isinstance(x, str):
            assert x == y, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if image_tol and k in ("img", "img_512"):
            assert np.abs(x - y).max() <= image_tol + 1e-6, k
        else:
            assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("mode", ["plain", "crop", "aug", "auto", "eval"])
def test_dataset_items_match_jax(trees, mode):
    root = trees[0]
    aug = dict(use_aug=True, aug_sat=0.3, aug_hue=0.2, aug_blur=1.5) \
        if mode == "aug" else {}
    jo, to = _opts(root, **aug)
    kw = dict(seed=5)
    if mode == "crop":
        kw["use_crop"] = True
    if mode == "auto":
        kw.update(b_min="auto", b_max="auto")
    if mode == "eval":
        jd, td = jds.EvalDataset(jo, seed=5), tds.EvalDataset(to, seed=5)
    else:
        jd, td = jds.TrainDataset(jo, **kw), tds.TrainDataset(to, **kw)
    assert len(jd) == len(td) == 3
    for i in range(len(jd)):
        _assert_items(jd[i], td[i], image_tol=2 / 255 if aug else 0.0)


def test_port_tree_reads_in_port(trees):
    """The port's own tree, read by the port: finite items, both labels
    present, the crop inside the 1024 render."""
    _, to = _opts(trees[1])
    d = tds.TrainDataset(dataclasses.replace(to, load_size=128),
                         use_crop=True, seed=1)
    for i in range(len(d)):
        it = d[i]
        assert np.isfinite(it["img"]).all() and it["img"].shape == (
            1, 512, 512, 6)
        assert 0 < it["labels"].sum() < len(it["labels"])


def test_prefetch_keeps_order():
    class Slow:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            import time
            time.sleep(0.002 * (9 - i))
            return i

    order = [4, 2, 8, 0, 7, 1, 3, 5, 6]
    got = list(tpre.prefetch_batches(Slow(), 2, list, order, num_threads=3))
    assert got == [[4, 2], [8, 0], [7, 1], [3, 5]]
    got = list(tpre.prefetch_batches(Slow(), 2, list, order, num_threads=3,
                                     drop_last=False))
    assert got[-1] == [6]
