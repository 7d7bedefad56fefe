"""The port's image reading without OpenCV: ``utils/png.py`` against files
OpenCV wrote, ``data/preprocessing.py`` against the JAX package's (whose
``resize_image`` is ``cv2.resize``), and ``InferenceDataset`` against the
JAX package's reader on the same directory.

Tolerances: PNG decoding is exact.  ``resize_image`` is held to
``cv2.resize`` within one grey level (1/255); so a normalised image
(``[-1, 1]``) may differ by 2/255 = 1/127.5.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from rgbd_pifuhd_tpu.data import preprocessing as jpre
from rgbd_pifuhd_tpu.data.readdata import InferenceDataset as JInferenceDataset
from rgbd_pifuhd_tpu_torch.data import preprocessing as tpre
from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset
from rgbd_pifuhd_tpu_torch.utils import png


def _smooth(rng, h, w, c):
    base = (rng.random((h, w, c)) * 40).cumsum(0).cumsum(1)
    return base / base.max()


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "gray16", "noise"])
def test_decodes_files_written_by_opencv(tmp_path, rng, kind):
    img = {"rgb": lambda: (_smooth(rng, 97, 131, 3) * 255).astype(np.uint8),
           "gray": lambda: (_smooth(rng, 97, 131, 1)[..., 0] * 255)
           .astype(np.uint8),
           "rgba": lambda: (_smooth(rng, 50, 70, 4) * 255).astype(np.uint8),
           "gray16": lambda: (_smooth(rng, 97, 131, 1)[..., 0] * 65535)
           .astype(np.uint16),
           "noise": lambda: rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
           }[kind]()
    path = str(tmp_path / f"{kind}.png")
    cv2.imwrite(path, img)                       # BGR(A) channel order
    got = png.read_png(path)
    want = img if img.ndim == 2 else img[:, :, [2, 1, 0] + [3] * (
        img.shape[2] == 4)]
    assert got.dtype == img.dtype and np.array_equal(got, want)
    # the 8-bit RGB view the reader uses equals cv2.imread's
    assert np.array_equal(png.read_rgb8(path), cv2.imread(path)[:, :, ::-1])


def _encode_with_filter(img: np.ndarray, ft: int) -> bytes:
    """A PNG whose every scanline uses filter type ``ft`` (test-side
    encoder, straight from the PNG specification)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out += bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_every_scanline_filter(tmp_path, rng, ft):
    img = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode_with_filter(img, ft))
    assert np.array_equal(cv2.imread(path)[:, :, ::-1], img)   # a valid file
    assert np.array_equal(png.read_png(path), img)


@pytest.mark.parametrize("shape", [(40, 56, 3), (40, 56)], ids=["rgb", "gray"])
def test_write_read_round_trip(tmp_path, rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    assert np.array_equal(png.read_png(path), img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back if img.ndim == 2 else back[:, :, ::-1], img)


def test_unsupported_files_name_the_limit(tmp_path, rng):
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    data = bytearray(_encode_with_filter(img, 0))
    for field, value, word in ((25, 3, "colour type"), (28, 1, "interlaced")):
        bad = bytearray(data)
        bad[field] = value               # IHDR colour type / interlace byte
        p = str(tmp_path / f"bad{field}.png")
        open(p, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match=word):
            png.read_png(p)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("h,w,size", [(97, 131, 64), (128, 128, 512),
                                      (300, 200, 512), (64, 64, 64),
                                      (100, 60, 128), (256, 256, 96)])
def test_resize_image_matches_cv2(rng, h, w, size):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = tpre.resize_image(img, size)
    want = jpre.resize_image(img, size)          # cv2.resize, INTER_LINEAR
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    smooth = (_smooth(rng, h, w, 3) * 255).astype(np.uint8)
    d = np.abs(tpre.resize_image(smooth, size).astype(int)
               - jpre.resize_image(smooth, size).astype(int))
    assert d.max() <= 1


def test_addrect_transform_normalize_match(rng):
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    for rect in ((0, 0, 50, 40), (-7, 5, 30, 60), (20, 10, 64, 64),
                 (60, 60, 8, 8)):
        assert np.array_equal(tpre.addrect(img, rect),
                              jpre.addrect(img, rect))
        for flip in (False, True):
            assert np.array_equal(
                tpre.rect_to_ndc_transform(rect, 50, 40, flip),
                jpre.rect_to_ndc_transform(rect, 50, 40, flip))
    for a in (img, img.astype(np.float32) / 255.0):
        assert np.array_equal(tpre.normalize_image(a),
                              jpre.normalize_image(a))


def _request_dir(tmp_path, rng):
    root = tmp_path / "req"
    os.makedirs(root / "depth")
    rgb = (_smooth(rng, 96, 80, 3) * 255).astype(np.uint8)
    dep = (_smooth(rng, 96, 80, 1)[..., 0] * 65535).astype(np.uint16)
    cv2.imwrite(str(root / "anna.png"), rgb)
    cv2.imwrite(str(root / "depth" / "depth_anna.png"), dep)   # 16-bit gray
    np.savetxt(str(root / "anna_rect.txt"), np.array([[-4, 6, 72, 72]]),
               fmt="%d")
    png.write_png(str(root / "bert.png"), rgb[::-1].copy())    # no depth
    np.savetxt(str(root / "bert_rect.txt"), np.array([0, 0, 80, 96]),
               fmt="%d")
    cv2.imwrite(str(root / "norect.png"), rgb)                 # not listed
    cv2.imwrite(str(root / "carl.jpg"), rgb)
    np.savetxt(str(root / "carl_rect.txt"), np.array([0, 0, 80, 96]),
               fmt="%d")
    return str(root)


def test_inference_dataset_matches_jax(tmp_path, rng):
    root = _request_dir(tmp_path, rng)
    mine, ref = InferenceDataset(root, 128), JInferenceDataset(root, 128)
    assert [n for _, _, n in mine.items] == [n for _, _, n in ref.items] \
        == ["anna", "bert", "carl"]
    for i in (0, 1):
        a, b = mine[i], ref[i]
        assert set(a) == set(b) and a["name"] == b["name"]
        assert a["img"].shape == b["img"].shape == (1, 128, 128, 6)
        assert a["img_512"].shape == b["img_512"].shape == (1, 512, 512, 6)
        for k in ("img", "img_512"):
            assert a[k].dtype == np.float32
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=1.0 / 127.5 + 1e-6)
            assert np.abs(a[k] - b[k]).mean() < 1e-3
        for k in ("calib", "calib_world", "b_min", "b_max"):
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
    assert float(np.abs(mine[1]["img"][..., 3:] + 1.0).max()) == 0.0
    with pytest.raises(ValueError, match="PNG"):
        mine[2]                                  # the .jpg subject
    assert len(InferenceDataset(str(tmp_path / "nowhere"))) == 0
