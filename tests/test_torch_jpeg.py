"""The port's JPEG decoder (``utils/jpeg.py``) against ``cv2.imread``,
which the JAX package's reader calls, on files ``cv2.imencode`` writes in
the test: qualities 75 and 95, chroma sampling 4:2:0, 4:2:2 and 4:4:4,
grey, restart intervals, sizes that are not multiples of the block or MCU,
and an EXIF orientation; progressive files (``IMWRITE_JPEG_PROGRESSIVE``:
spectral selection and successive approximation) over the same samplings,
ragged sizes, grey and restart intervals.  Target: the same pixels (max
|diff| 0; measured 0 on every case), held to at most one grey level, and
0 for the progressive cases.  Arithmetic-coded (here a progressive file
whose SOF2 marker is rewritten to SOF10), truncated and broken files
raise.

The committed subjects ``tests/data/jpeg_subject`` (the capsule at 512^2,
quality 90, 4:2:0) and ``tests/data/jpeg_progressive`` (the same pixels
written progressive, quality 90; its ``cv2.imread`` pixels committed as
``tests/data/jpeg_progressive_expected.png``, which ``chip_smoke.py``
holds the card's host to, having no cv2 there) are read by both
packages' ``InferenceDataset`` and served on the CPU.
"""

import os
import struct

import cv2
import numpy as np
import pytest

from rgbd_pifuhd_tpu.data.readdata import InferenceDataset as JDataset
from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset
from rgbd_pifuhd_tpu_torch.utils import jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBJECT = os.path.join(REPO, "tests", "data", "jpeg_subject")
PROGRESSIVE = os.path.join(REPO, "tests", "data", "jpeg_progressive")


def _image(rng, h, w, c=3):
    """Smooth structure plus noise: every DCT frequency gets energy."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 7.0) * 100 + 128,
                     np.cos(yy / 5.0) * 90 + 128, (xx + yy) % 256], -1)
    base = base + rng.normal(0, 20, base.shape)
    return np.clip(base[..., :c], 0, 255).astype(np.uint8)


def _write(path, img, quality, sampling="420", restart=0, progressive=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    return path


def _same(path):
    ref = cv2.imread(path)[:, :, ::-1]
    got = jpeg.read_rgb8(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = int(np.abs(got.astype(int) - ref.astype(int)).max())
    assert d <= 1, d
    return d


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("size", [(64, 64), (37, 101), (123, 77)])
def test_decode_matches_cv2(tmp_path, rng, quality, sampling, size):
    path = _write(str(tmp_path / "a.jpg"), _image(rng, *size), quality,
                  sampling)
    assert _same(path) == 0


@pytest.mark.parametrize("restart,sampling", [(1, "420"), (3, "422"),
                                              (2, "444")])
def test_restart_intervals(tmp_path, rng, restart, sampling):
    path = _write(str(tmp_path / "r.jpg"), _image(rng, 50, 83), 90,
                  sampling, restart=restart)
    assert b"\xff\xdd" in open(path, "rb").read()        # a DRI segment
    assert _same(path) == 0


def test_grey(tmp_path, rng):
    path = _write(str(tmp_path / "g.jpg"), _image(rng, 45, 61, 1)[..., 0],
                  85)
    assert _same(path) == 0
    assert jpeg.decode(open(path, "rb").read()).shape == (45, 61, 1)


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_exif_orientation(tmp_path, rng, orientation):
    """An APP1 Exif segment with the orientation tag, spliced in after SOI:
    ``cv2.imread`` turns the image, and so does the port."""
    path = _write(str(tmp_path / "o.jpg"), _image(rng, 40, 72), 90)
    data = open(path, "rb").read()
    tiff = b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1) + \
        struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\0" * 4
    app1 = b"Exif\x00\x00" + tiff
    with open(path, "wb") as f:
        f.write(data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
                + app1 + data[2:])
    assert cv2.imread(path).shape[:2] == ((72, 40) if orientation != 3
                                          else (40, 72))
    assert _same(path) == 0


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("size,restart", [((64, 64), 0), ((37, 101), 1),
                                          ((123, 77), 3)])
def test_progressive_matches_cv2(tmp_path, rng, sampling, size, restart):
    path = _write(str(tmp_path / "p.jpg"), _image(rng, *size), 85,
                  sampling, restart=restart, progressive=1)
    data = open(path, "rb").read()
    assert b"\xff\xc2" in data and data.count(b"\xff\xda") > 1
    assert _same(path) == 0


def test_progressive_grey_with_restarts(tmp_path, rng):
    path = _write(str(tmp_path / "pg.jpg"), _image(rng, 45, 61, 1)[..., 0],
                  90, restart=2, progressive=1)
    assert b"\xff\xdd" in open(path, "rb").read()
    assert _same(path) == 0


def test_progressive_and_broken_files_raise(tmp_path, rng):
    path = _write(str(tmp_path / "p.jpg"), _image(rng, 32, 32), 90,
                  progressive=1)
    data = open(path, "rb").read()
    arith = data.replace(b"\xff\xc2", b"\xff\xca", 1)
    with pytest.raises(ValueError, match="arithmetic-coded progressive"):
        jpeg.decode(arith)
    with pytest.raises(ValueError, match="JPEG"):
        jpeg.decode(data[:len(data) // 3])
    with pytest.raises(ValueError, match="JPEG"):
        jpeg.decode(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG")


def test_progressive_subject_fixture():
    """The committed progressive subject: cv2's pixels (and the committed
    PNG of them), read by both packages' readers."""
    from rgbd_pifuhd_tpu_torch.utils.png import read_rgb8 as read_png

    path = os.path.join(PROGRESSIVE, "capsule.jpg")
    assert b"\xff\xc2" in open(path, "rb").read()
    assert os.path.getsize(path) < 256 * 1024
    assert _same(path) == 0
    want = read_png(os.path.join(REPO, "tests", "data",
                                 "jpeg_progressive_expected.png"))
    assert np.array_equal(jpeg.read_rgb8(path), want)
    mine = InferenceDataset(PROGRESSIVE, 256)[0]
    ref = JDataset(PROGRESSIVE, 256)[0]
    for k in ("img", "img_512"):
        np.testing.assert_allclose(mine[k], ref[k], rtol=0,
                                   atol=1.0 / 127.5 + 1e-6)


def test_subject_fixture_reads_as_the_jax_package_reads_it():
    path = os.path.join(SUBJECT, "capsule.jpg")
    assert os.path.getsize(path) < 256 * 1024
    assert _same(path) == 0
    mine, ref = InferenceDataset(SUBJECT, 256)[0], JDataset(SUBJECT, 256)[0]
    assert mine["name"] == ref["name"] == "capsule"
    for k in ("img", "img_512"):
        assert mine[k].shape == ref[k].shape
        # the same decoded pixels; the resize matches cv2's within a level
        np.testing.assert_allclose(mine[k], ref[k], rtol=0,
                                   atol=1.0 / 127.5 + 1e-6)
    for k in ("calib", "calib_world"):
        assert np.array_equal(mine[k], ref[k])


def test_serve_answers_a_jpeg_subject(tmp_path):
    """``cli.serve``'s request loop on the CPU (``bench_tiny``, res 32)
    answers the JPEG subject with a mesh."""
    from rgbd_pifuhd_tpu_torch.cli import serve
    from rgbd_pifuhd_tpu_torch.cli.common import load_reconstructor
    from rgbd_pifuhd_tpu_torch.recon.mesh import load_obj
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    opt, dev = parse_options(
        ["--load_netMR_checkpoint_path",
         os.path.join(REPO, "assets", "bench_tiny", "ckpt"),
         "--resolution", "32", "--loadSize", "128", "--device", "cpu"],
        with_device=True)
    recon, _, _ = load_reconstructor(opt, dev)
    got = []
    serve._serve_loop(recon, opt, str(tmp_path), [f"{SUBJECT}::capsule\n"],
                      got.append)
    assert len(got) == 1 and "error" not in got[0], got
    v, f, _ = load_obj(got[0]["mesh"])
    assert len(v) == got[0]["verts"] > 0 and len(f) > 0


def test_serve_answers_a_progressive_subject(tmp_path):
    """``cli.serve`` on the CPU (``bench_tiny``, res 32) answers the
    committed progressive subject with a mesh."""
    from rgbd_pifuhd_tpu_torch.cli import serve
    from rgbd_pifuhd_tpu_torch.cli.common import load_reconstructor
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    opt, dev = parse_options(
        ["--load_netMR_checkpoint_path",
         os.path.join(REPO, "assets", "bench_tiny", "ckpt"),
         "--resolution", "32", "--loadSize", "128", "--device", "cpu"],
        with_device=True)
    recon, _, _ = load_reconstructor(opt, dev)
    got = []
    serve._serve_loop(recon, opt, str(tmp_path),
                      [f"{PROGRESSIVE}::capsule\n"], got.append)
    assert len(got) == 1 and "error" not in got[0], got
    assert got[0]["verts"] > 0
