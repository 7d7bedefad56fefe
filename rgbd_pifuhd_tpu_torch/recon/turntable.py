"""Turntable videos of result meshes (port of ``recon/turntable.py``):
frames from the orthographic rasteriser (``native/raster.cc``) as the mesh
turns about +y, written as a Motion-JPEG ``.avi`` by the port's own
container writer (``utils/avi.py``) with JPEG frames from ``utils/jpeg``.
The JAX package writes through ``cv2.VideoWriter`` (``mp4v`` for ``.mp4``,
``MJPG`` otherwise); this package has no video encoder, so any other
extension than ``.avi`` raises.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.synthetic import rasterize_ortho, rotation_y
from ..utils.avi import write_mjpeg_avi
from ..utils.jpeg import encode as encode_jpeg
from .mesh import load_obj


def render_turntable_frames(verts: np.ndarray, faces: np.ndarray,
                            size: int = 512, n_frames: int = 36,
                            colors: np.ndarray | None = None):
    """Yield [H, W, 3] uint8 RGB frames rotating the mesh about +y (white
    background; ``colors`` is accepted and unused, as in the JAX
    package)."""
    center = (verts.max(axis=0) + verts.min(axis=0)) / 2
    extent = float(np.abs(verts - center).max()) * 1.2
    for k in range(n_frames):
        R = rotation_y(360.0 * k / n_frames)
        v = (verts - center) @ R.T
        calib = np.diag([1 / extent, -1 / extent, 1 / extent, 1.0])
        out = rasterize_ortho(v, faces, size, calib)
        frame = np.ones((size, size, 3))
        m = out["mask"]
        frame[m] = out["rgb"][m]
        yield (frame * 255).astype(np.uint8)


def generate_video_from_obj(obj_path: str, video_path: str,
                            size: int = 512, n_frames: int = 36,
                            fps: int = 12) -> str:
    """OBJ -> turntable ``.avi`` (Motion-JPEG, ``fps`` frames a second)."""
    if os.path.splitext(video_path)[1].lower() != ".avi":
        raise ValueError(
            f"{video_path}: this package writes Motion-JPEG .avi only (it "
            "has no MPEG-4 or other video encoder); use a .avi path")
    verts, faces, _ = load_obj(obj_path)
    write_mjpeg_avi(video_path, (encode_jpeg(f) for f in
                                 render_turntable_frames(verts, faces, size,
                                                         n_frames)),
                    size, size, fps)
    return video_path
