"""``recon/turntable.py`` and ``utils/avi.py`` against the JAX package's
turntable, on the CPU.

Frames are byte-equal.  The port writes the ``.avi`` itself (Motion-JPEG,
one JFIF frame a chunk): ``cv2.VideoCapture`` opens it and yields
``n_frames`` frames of the right size at the right rate, each within 1.0
grey level on average and 40 at most of the frame rendered (JPEG at
quality 95, decoded by OpenCV's video reader); the port's own reader gives
back the very JPEG files it wrote.  A ``.mp4`` (or any other extension)
raises.
"""

import cv2
import numpy as np
import pytest

from rgbd_pifuhd_tpu.recon import turntable as jt
from rgbd_pifuhd_tpu_torch.data.synthetic import make_bumpy_sphere, make_capsule
from rgbd_pifuhd_tpu_torch.recon import mesh as tm
from rgbd_pifuhd_tpu_torch.recon import turntable as tt
from rgbd_pifuhd_tpu_torch.utils import avi, jpeg

MEAN_TOL, MAX_TOL = 1.0, 40


@pytest.mark.parametrize("shape,size,n", [("capsule", 64, 5),
                                          ("bumpy", 96, 4)])
def test_frames_equal(shape, size, n):
    v, f = (make_capsule(1.6, 0.55, 2) if shape == "capsule"
            else make_bumpy_sphere(3))
    got = list(tt.render_turntable_frames(v, f, size, n))
    want = list(jt.render_turntable_frames(v, f, size, n))
    assert len(got) == n
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == (size, size, 3)
        assert a.tobytes() == b.tobytes()


def test_avi_opens_in_cv2_and_own_reader(tmp_path):
    v, f = make_capsule(1.6, 0.55, 2)
    obj = str(tmp_path / "m.obj")
    tm.save_obj_with_color(obj, v, f)
    path = str(tmp_path / "turn.avi")
    assert tt.generate_video_from_obj(obj, path, 80, 6, 12) == path
    vv, ff, _ = tm.load_obj(obj)
    frames = list(tt.render_turntable_frames(vv, ff, 80, 6))
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == 12
    read = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        read.append(fr[:, :, ::-1])
    cap.release()
    assert len(read) == 6
    for fr, want in zip(read, frames):
        assert fr.shape == (80, 80, 3)
        d = np.abs(fr.astype(int) - want.astype(int))
        assert d.mean() <= MEAN_TOL and d.max() <= MAX_TOL
    info = avi.read_avi(path)
    assert (info["fps"], info["width"], info["height"]) == (12, 80, 80)
    assert info["frames"] == [jpeg.encode(x) for x in frames]
    assert all(jpeg.decode(b).shape == (80, 80, 3) for b in info["frames"])


def test_avi_odd_chunks_and_empty(tmp_path):
    blobs = [b"\xff\xd8abc\xff\xd9", b"\xff\xd8ab\xff\xd9"]   # odd, even
    p = str(tmp_path / "x.avi")
    assert avi.write_mjpeg_avi(p, blobs, 8, 6, 25) == 2
    assert avi.read_avi(p)["frames"] == blobs
    assert avi.write_mjpeg_avi(p, [], 8, 6, 25) == 0
    assert avi.read_avi(p)["frames"] == []
    with open(p, "wb") as fh:
        fh.write(b"RIFF\x00\x00\x00\x00WAVE")
    with pytest.raises(ValueError, match="not an AVI"):
        avi.read_avi(p)


@pytest.mark.parametrize("ext", [".mp4", ".mov", ".mkv"])
def test_other_containers_raise(tmp_path, ext):
    v, f = make_capsule(1.6, 0.55, 1)
    obj = str(tmp_path / "m.obj")
    tm.save_obj_with_color(obj, v, f)
    with pytest.raises(ValueError, match=r"\.avi"):
        tt.generate_video_from_obj(obj, str(tmp_path / f"v{ext}"))
