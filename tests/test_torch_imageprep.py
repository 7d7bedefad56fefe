"""The readers' one-pass image preparation (``data/preprocessing``'s
``prepare_stack`` / ``prepare_map`` on ``native/imageprep.cc``) against the
NumPy chain it replaces, bit for bit (compared as ``uint32`` views):

- ``prepare_stack(rgb, depth, s)`` equals ``concatenate([normalize_image(
  resize_image(rgb, s)), normalize_image(resize_image(depth, s))], -1)`` for
  1024 -> 512, 1024 -> 1024 (no resize), non-square sources and targets and
  an upscale, with random, all-zero and all-one depth maps (the last two take
  ``normalize_image``'s ``max() <= 1.5`` branch);
- ``prepare_map`` equals ``normalize_image(resize_image(img, s))`` for HWC
  and HW maps of 1, 3 and 4 channels; a float map takes the NumPy chain;
- ``TrainDataset`` and ``InferenceDataset`` items read with the native pass
  equal the items read through the NumPy chain, field for field, and the
  dataset's counters count the maps the native pass prepared, also under
  many reader threads at once.
"""

import sys
import threading

import numpy as np
import pytest

from rgbd_pifuhd_tpu_torch.data import datasets as tds
from rgbd_pifuhd_tpu_torch.data import preprocessing as P
from rgbd_pifuhd_tpu_torch.data import readdata as trd
from rgbd_pifuhd_tpu_torch.data import synthetic as tsyn
from rgbd_pifuhd_tpu_torch.utils import png
from rgbd_pifuhd_tpu_torch.utils.options import Options


@pytest.fixture
def rng():      # here, so the file also runs with --noconftest (no JAX)
    return np.random.default_rng(16)


def _chain_map(img, size):
    return P.normalize_image(P.resize_image(img, size))


def _chain_stack(rgb, depth, size):
    return np.concatenate([_chain_map(rgb, size), _chain_map(depth, size)],
                          axis=-1)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype == np.float32 and a.shape == b.shape
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def _depth(rng, kind, h, w):
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return np.full((h, w, 3), {"zeros": 0, "ones": 1}[kind], np.uint8)


@pytest.mark.parametrize("depth_kind", ["random", "zeros", "ones"])
@pytest.mark.parametrize("hw,size", [((1024, 1024), 512),
                                     ((1024, 1024), 1024),
                                     ((300, 200), 128),
                                     ((97, 131), (80, 48)),
                                     ((72, 60), 128)],
                         ids=["1024to512", "1024to1024", "nonsquare",
                              "nonsquare_target", "upscale"])
def test_prepare_stack_is_the_numpy_chain(rng, hw, size, depth_kind):
    h, w = hw
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    depth = _depth(rng, depth_kind, h, w)
    got = P.prepare_stack(rgb, depth, size)
    assert _bits_equal(got, _chain_stack(rgb, depth, size))
    assert P.native_pass(rgb) and P.native_pass(depth)
    if depth_kind != "random":       # the other branch: -1 or 1
        assert set(np.unique(got[..., 3:]).tolist()) <= {-1.0, 1.0}


@pytest.mark.parametrize("shape,size", [((1024, 1024, 3), 512),
                                        ((1024, 1024, 3), 1024),
                                        ((130, 90), 64),
                                        ((64, 48, 1), (32, 40)),
                                        ((50, 70, 4), 96)],
                         ids=["1024to512", "1024to1024", "gray2d",
                              "one_channel", "four_channels"])
@pytest.mark.parametrize("kind", ["random", "zeros", "ones"])
def test_prepare_map_is_the_numpy_chain(rng, shape, size, kind):
    img = (rng.integers(0, 256, shape, dtype=np.uint8) if kind == "random"
           else np.full(shape, kind == "ones", np.uint8))
    assert _bits_equal(P.prepare_map(img, size), _chain_map(img, size))


def test_float_maps_take_the_numpy_chain(rng):
    rgb = rng.random((60, 80, 3)).astype(np.float32) * 255.0
    dep = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    assert not P.native_pass(rgb)
    assert _bits_equal(P.prepare_stack(rgb, dep, 32),
                       _chain_stack(rgb, dep, 32))
    assert _bits_equal(P.prepare_map(rgb / 255.0, 48),
                       _chain_map(rgb / 255.0, 48))


# ------------------------------------------------------------ the readers
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    tsyn.generate_synthetic_dataset(root, ("sphere", "capsule"), size=128,
                                    load_size=128, seed=3)
    return root


def _chain_readers(monkeypatch):
    """The readers as they were: every map through the NumPy chain."""
    monkeypatch.setattr(tds, "prepare_stack", _chain_stack)
    monkeypatch.setattr(tds, "prepare_map", _chain_map)
    monkeypatch.setattr(trd, "prepare_stack", _chain_stack)


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if x is None or isinstance(x, str):
            assert x == y, k
        elif np.asarray(x).dtype == np.float32:
            assert _bits_equal(x, y), k
        else:
            assert np.array_equal(x, y) and x.dtype == y.dtype, k


@pytest.mark.parametrize("mode", ["plain", "resized", "crop"])
def test_train_items_native_equal_numpy(tree, monkeypatch, mode):
    big, local = (96, 80) if mode == "resized" else (128, 64)
    opt = Options(dataroot=tree, load_size=128, load_size_big=big,
                  load_size_local=local, num_sample_inout=200, sigma=3.0)
    kw = dict(use_crop=mode == "crop", seed=7)
    native = tds.TrainDataset(opt, **kw)
    got = [native[i] for i in range(len(native))]
    st = native.prep_stats()
    assert st["items"] == len(got) == 2
    assert st["native_maps"] == 6 * len(got)
    assert st["image_s"] > 0 and st["sample_s"] > 0
    _chain_readers(monkeypatch)
    chain = tds.TrainDataset(opt, **kw)
    for i, item in enumerate(got):
        want = chain[i]
        _assert_items_equal(item, want)
        for k in ("img", "img_512", "imF", "imB"):
            assert item[k].dtype == np.float32, k


def test_train_counter_leaves_float_maps_out(tree):
    opt = Options(dataroot=tree, load_size=128, load_size_big=128,
                  load_size_local=64, num_sample_inout=200, sigma=3.0)

    def read_float(path):
        return png.read_rgb8(path).astype(np.float32)

    d = tds.TrainDataset(opt, seed=7, imread=read_float)
    d[0]
    assert d.prep_stats()["native_maps"] == 0
    assert d.prep_stats()["items"] == 1


def test_train_counter_under_many_threads(tree):
    opt = Options(dataroot=tree, load_size=128, load_size_big=128,
                  load_size_local=64, num_sample_inout=50, sigma=3.0)
    d = tds.TrainDataset(opt, seed=1)
    n_threads, per_thread = 12, 3
    errors = []

    def work():
        try:
            for i in range(per_thread):
                d[i % len(d)]
        except Exception as e:       # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    st = d.prep_stats()
    assert st["items"] == n_threads * per_thread
    assert st["native_maps"] == 6 * n_threads * per_thread


def _request_dir(root, rng):
    root.joinpath("depth").mkdir(parents=True)
    yy, xx = np.mgrid[0:96, 0:80]
    rgb = np.stack([xx * 3, yy * 2, (xx + yy) % 256], -1).astype(np.uint8)
    rgb = np.clip(rgb.astype(int) + rng.integers(-20, 21, rgb.shape), 0,
                  255).astype(np.uint8)
    png.write_png(str(root / "anna.png"), rgb)
    png.write_png(str(root / "depth" / "depth_anna.png"),
                  rng.integers(0, 256, (96, 80), dtype=np.uint8))
    np.savetxt(str(root / "anna_rect.txt"), np.array([[-4, 6, 72, 72]]),
               fmt="%d")
    png.write_png(str(root / "bert.png"), rgb[::-1].copy())    # no depth
    np.savetxt(str(root / "bert_rect.txt"), np.array([0, 0, 80, 96]),
               fmt="%d")
    return str(root)


def test_inference_items_native_equal_numpy(tmp_path, rng, monkeypatch):
    root = _request_dir(tmp_path / "req", rng)
    got = [trd.InferenceDataset(root, 128)[i] for i in (0, 1)]
    _chain_readers(monkeypatch)
    chain = trd.InferenceDataset(root, 128)
    for i, item in enumerate(got):
        _assert_items_equal(item, chain[i])
    assert got[0]["img"].shape == (1, 128, 128, 6)
    assert got[0]["img_512"].shape == (1, 512, 512, 6)
    assert float(np.abs(got[1]["img"][..., 3:] + 1.0).max()) == 0.0
