"""Offline training-data rendering of OBJ subjects (port of
``data/render_dataset.py``): each subject's yaw sweep (default step 180:
the front / back pair the datasets read; step 4 is the full 90-view sweep)
rendered by the orthographic rasteriser of ``data/synthetic.py``
(``native/raster.cc``), textured from the subject's ``map_Kd`` or flat
``Kd``, optionally shaded by per-vertex PRT (SH order 2, ``data/render``),
and written as the training tree: RENDER (JPEG, ``utils/jpeg``, the bytes
``cv2.imwrite`` writes), MASK, DEPTH and NORM (PNG, ``utils/png``), PARAM
(``np.save`` of ``{ortho_ratio, scale, center, R}``), and the OBJ copied to
``OBJ/<subject>_100k.obj``.  The mesh is not moved: the camera is built
around its bounding box (centre, and the scale that makes it 180 units
tall).  Conventions: DEPTH = 255 - 255 z_normalised on the silhouette, 0 off
it, in three channels; NORM = view-space normals on white, the back view
(yaw 180) inverted.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from ..recon.mesh import compute_vertex_normals, load_obj_mtl
from ..utils.jpeg import encode as encode_jpeg
from ..utils.png import write_png
from .render import compute_prt, rotate_sh_coeffs, sh_shade
from .synthetic import rasterize_ortho, rotation_y


def _default_sh_env() -> np.ndarray:
    """A soft white top-lit SH environment (order 2, 9 coeffs)."""
    env = np.zeros(9)
    env[0] = 2.5          # ambient
    env[2] = 1.2          # y-directional (top light), l=1 m=0
    return env


def _add(timings: dict | None, key: str, t0: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def render_subject(
    root: str,
    subject: str,
    obj_path: str,
    size: int = 512,
    load_size: int = 1024,
    yaw_step: int = 180,
    pitch_list=(0,),
    use_prt: bool = False,
    prt_dirs: int = 6,
    timings: dict | None = None,
) -> int:
    """Render one subject's yaw sweep into the tree at ``root``; returns
    the number of views written.  ``timings``, when given, accumulates
    seconds under ``load``, ``prt``, ``raster`` (shading and
    rasterising) and ``encode`` (image encoding and writing)."""
    t0 = time.perf_counter()
    mesh = load_obj_mtl(obj_path)
    _add(timings, "load", t0)
    verts, faces = mesh["verts"], mesh["faces"]
    verts = verts.astype(np.float64)
    vmin, vmax = verts.min(axis=0), verts.max(axis=0)
    center = (vmin + vmax) / 2.0
    height = max(vmax[1] - vmin[1], 1e-9)
    scale = 180.0 / height

    prt = None
    if use_prt:
        t0 = time.perf_counter()
        normals = compute_vertex_normals(verts, faces)
        prt = compute_prt(verts, faces, normals, order=2, n_dirs=prt_dirs)
        _add(timings, "prt", t0)

    for d in ("RENDER", "MASK", "DEPTH", "NORM", "PARAM"):
        os.makedirs(os.path.join(root, d, subject), exist_ok=True)

    ortho_ratio = 0.2 * (1024 / size)
    n_views = 0
    for pitch in pitch_list:
        for yaw in range(0, 360, yaw_step):
            t0 = time.perf_counter()
            R = rotation_y(yaw)
            translate = -(R @ center).reshape(3, 1)
            extrinsic = np.eye(4)
            extrinsic[:3, :3] = R
            extrinsic[:3, 3:4] = translate
            s = scale / ortho_ratio
            intr = np.diag([s, -s, s, 1.0])
            uv = np.diag([1.0 / (load_size // 2)] * 3 + [1.0])
            calib = uv @ intr @ extrinsic

            shade_v = None
            if prt is not None:
                # per-vertex transport . rotated environment, interpolated
                # barycentrically by the rasteriser
                env_rot = rotate_sh_coeffs(_default_sh_env(), R)
                shade_v = np.clip(sh_shade(prt, env_rot) / np.pi, 0.0, 1.5)
            out = rasterize_ortho(
                verts, faces, size, calib, vert_shade=shade_v,
                uvs=mesh["uvs"], face_uvs=mesh["face_uvs"],
                texture=mesh["texture"], face_albedo=mesh["face_albedo"])
            _add(timings, "raster", t0)

            t0 = time.perf_counter()
            tag = f"{yaw}_{pitch}_00"
            with open(os.path.join(root, "RENDER", subject, f"{tag}.jpg"),
                      "wb") as fh:
                fh.write(encode_jpeg((out["rgb"] * 255).astype(np.uint8)))
            m = out["mask"]
            write_png(os.path.join(root, "MASK", subject, f"{tag}.png"),
                      (m * 255).astype(np.uint8))
            z = out["zbuf"]
            zn = np.zeros_like(z)
            if m.any():
                zmin, zmax = z[m].min(), z[m].max()
                zn[m] = (z[m] - zmin) / max(zmax - zmin, 1e-9)
            depth_png = (255 - 255 * zn).astype(np.uint8)
            depth_png[~m] = 0
            write_png(os.path.join(root, "DEPTH", subject, f"{tag}.png"),
                      np.repeat(depth_png[:, :, None], 3, axis=2))
            nimg = np.ones((size, size, 3))
            nimg[m] = out["normal"][m] * 0.5 + 0.5
            if yaw == 180:
                nimg[m] = 1.0 - nimg[m]
            write_png(os.path.join(root, "NORM", subject, f"{tag}.png"),
                      (nimg * 255).astype(np.uint8))
            np.save(os.path.join(root, "PARAM", subject, f"{tag}.npy"),
                    {"ortho_ratio": ortho_ratio, "scale": scale,
                     "center": center, "R": R})
            _add(timings, "encode", t0)
            n_views += 1
    return n_views


def render_dataset(root: str, obj_dir: str, size: int = 512,
                   load_size: int = 1024, yaw_step: int = 180,
                   use_prt: bool = False,
                   timings: dict | None = None) -> dict:
    """Render every ``.obj`` in ``obj_dir`` (sorted) into ``root``; the
    subject is the file name without ``_100k.obj`` (or ``.obj``), and the
    mesh is copied to ``OBJ/<subject>_100k.obj``.  Returns ``{subject:
    views}``."""
    os.makedirs(os.path.join(root, "OBJ"), exist_ok=True)
    written = {}
    for f in sorted(os.listdir(obj_dir)):
        if not f.endswith(".obj"):
            continue
        subject = f[:-9] if f.endswith("_100k.obj") else os.path.splitext(f)[0]
        dst = os.path.join(root, "OBJ", f"{subject}_100k.obj")
        src = os.path.join(obj_dir, f)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst)
        written[subject] = render_subject(
            root, subject, src, size=size, load_size=load_size,
            yaw_step=yaw_step, use_prt=use_prt, timings=timings)
    return written
