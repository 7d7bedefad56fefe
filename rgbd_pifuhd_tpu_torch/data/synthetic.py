"""Synthetic subjects and training trees (port of ``data/synthetic.py``):
analytic meshes (icosphere, capsule, the "bumpy" sphere), height
normalisation and placement, the orthographic rasteriser on
``native/raster.cc``, and ``generate_synthetic_dataset``, which writes the
full training-tree layout (OBJ, RENDER, MASK, DEPTH, NORM, PARAM, the
background-composited ``gen/`` images and the style images) with the port's
own PNG and JPEG writers.  Its files decode to the same pixels as the JAX
package's for the same seed (the JPEGs are byte-equal to ``cv2.imwrite``'s).

Conventions: ``calib`` maps world -> NDC ([-1, 1], y up); pixels follow the
grid_sample convention (align_corners): u=-1 -> col 0, v=-1 -> row 0.
DEPTH png = 255 - 255 z_normalised on the silhouette, 0 off it; NORM png =
view-space normals on white; PARAM npy = {ortho_ratio, scale, center, R}.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native import load_raster
from ..recon.mesh import save_obj_with_color
from ..utils.imgproc import gaussian_blur_u8
from ..utils.jpeg import decode as decode_jpeg
from ..utils.jpeg import encode as encode_jpeg
from ..utils.png import write_png


def make_icosphere(subdiv: int = 3, radius: float = 1.0):
    """Icosphere verts/faces via repeated subdivision of an icosahedron."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdiv):
        edge_mid: dict = {}
        new_faces = []
        vlist = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts * radius, faces


def make_capsule(height: float = 2.0, radius: float = 0.5, subdiv: int = 3):
    """Capsule: icosphere split at the equator and extruded along y."""
    v, f = make_icosphere(subdiv, radius)
    v = v.copy()
    v[:, 1] += np.where(v[:, 1] > 0, height / 2, -height / 2)
    return v, f


def bumpy_radius(directions: np.ndarray, radius: float = 1.0,
                 amp: float = 0.08, omega: float = 25.0) -> np.ndarray:
    """Surface radius of the "bumpy" subject along unit ``directions``:
    ``radius * (1 + amp sin(w dx) sin(w dy) sin(w dz))``."""
    d = np.asarray(directions, np.float64)
    s = np.sin(omega * d[..., 0]) * np.sin(omega * d[..., 1]) \
        * np.sin(omega * d[..., 2])
    return radius * (1.0 + amp * s)


def make_bumpy_sphere(subdiv: int = 5, radius: float = 1.0,
                      amp: float = 0.08, omega: float = 25.0):
    """Icosphere displaced radially by ``bumpy_radius``: detail that a
    half-resolution image blurs away and the full-resolution one keeps."""
    v, f = make_icosphere(subdiv, 1.0)
    r = bumpy_radius(v, radius, amp, omega)
    return v * r[:, None], f


def normalize_mesh_height(verts: np.ndarray, target: float = 180.0):
    """Center and scale so the y-extent is ``target`` world units."""
    vmin, vmax = verts.min(axis=0), verts.max(axis=0)
    up = max(vmax[1] - vmin[1], 1e-9)
    center = (vmax + vmin) / 2
    return (verts - center) * (target / up)


# World position every synthetic subject is placed at (roughly the
# reference's training box: z around -430, TrainDataset.py B_MIN/B_MAX).
SUBJECT_CENTER = np.array([-128.0, 100.0, -434.0])


def bumpy_surface_frame(target_height: float = 180.0):
    """``(c0, scale)`` of the "bumpy" subject as the generator places it:
    its surface is radial around ``c0`` with radius ``scale *
    bumpy_radius(dir)``."""
    v0, _ = make_bumpy_sphere()
    vmin, vmax = v0.min(axis=0), v0.max(axis=0)
    scale = target_height / (vmax[1] - vmin[1])
    c0 = SUBJECT_CENTER - (vmax + vmin) / 2 * scale
    return c0, scale


def bumpy_surface_error(verts: np.ndarray) -> np.ndarray:
    """Per-vertex ``|r - r_expected|`` of world-space ``verts`` against the
    analytic bumpy surface."""
    c0, scale = bumpy_surface_frame()
    d = np.asarray(verts, np.float64) - c0
    r = np.linalg.norm(d, axis=1)
    dirs = d / np.maximum(r[:, None], 1e-12)
    return np.abs(r - scale * bumpy_radius(dirs))


def rotation_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


# ------------------------------------------------------------ rasterizer
def _vertex_normals(verts: np.ndarray, faces: np.ndarray,
                    ndc: np.ndarray) -> np.ndarray:
    """Smooth vertex normals in view (NDC) space: the sum of the unit
    normals of a vertex's faces, normalised.  ``np.bincount`` over the
    corners in the order faces[:, 0], faces[:, 1], faces[:, 2] adds in the
    order the JAX package's three ``np.add.at`` passes do (the same bits),
    about twice as fast."""
    v0, v1, v2 = (ndc[faces[:, 0]], ndc[faces[:, 1]], ndc[faces[:, 2]])
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    idx = faces.T.reshape(-1)
    vn = np.stack([np.bincount(idx, weights=np.tile(fn[:, c], 3),
                               minlength=len(verts)) for c in range(3)], 1)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    return vn


def rasterize_ortho(verts: np.ndarray, faces: np.ndarray, size: int,
                    calib: np.ndarray, albedo=(0.8, 0.65, 0.55),
                    vert_shade: np.ndarray | None = None,
                    uvs: np.ndarray | None = None,
                    face_uvs: np.ndarray | None = None,
                    texture: np.ndarray | None = None,
                    face_albedo: np.ndarray | None = None):
    """Orthographic z-buffer rasteriser on ``native/raster.cc`` (parallel
    two-pass: an atomic packed depth + face-id test, then attributes of
    each covered pixel's winning face).  A failed build or call raises.

    ``calib`` maps world -> NDC ([-1, 1], y up); pixels follow the
    grid_sample convention (align_corners): u=-1 -> col 0, v=-1 -> row 0.

    Args:
        vert_shade: optional ``[V]`` or ``[V, 3]`` per-vertex shading
            multiplier, barycentrically interpolated.
        uvs / face_uvs / texture / face_albedo: UV-mapped albedo: ``uvs
            [T, 2]`` (origin bottom-left), ``face_uvs [F, 3]`` (-1: the
            face is untextured), ``texture [th, tw, 3]`` float RGB in
            [0, 1] (bilinear, repeat wrap), ``face_albedo [F, 3]`` flat
            colour per face where no texture applies.

    Returns dict with rgb [H,W,3] float[0,1], mask [H,W] bool,
    zbuf [H,W] float (NDC z, +inf where empty), normal [H,W,3] view-space.
    """
    lib = load_raster()
    verts = np.asarray(verts, np.float64)
    faces_c = np.ascontiguousarray(faces, dtype=np.int32)
    ndc = verts @ calib[:3, :3].T + calib[:3, 3]
    px = np.ascontiguousarray((ndc[:, 0] + 1.0) * 0.5 * (size - 1))
    py = np.ascontiguousarray((ndc[:, 1] + 1.0) * 0.5 * (size - 1))
    pz = np.ascontiguousarray(ndc[:, 2])
    vn = np.ascontiguousarray(_vertex_normals(verts, faces_c, ndc))
    albedo_c = np.ascontiguousarray(albedo, np.float64)
    light = np.array([0.3, 0.6, -0.8])
    light = np.ascontiguousarray(light / np.linalg.norm(light))

    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    shade_ch = 0
    vs_ptr = dp()
    if vert_shade is not None:
        vs = np.ascontiguousarray(np.asarray(vert_shade, np.float64))
        shade_ch = 1 if vs.ndim == 1 else vs.shape[1]
        vs_ptr = vs.ctypes.data_as(dp)
    uv_ptr, fuv_ptr, tex_ptr, falb_ptr = dp(), ip(), fp(), dp()
    th = tw = 0
    if texture is not None and uvs is not None and face_uvs is not None:
        uvs_c = np.ascontiguousarray(uvs, np.float64)
        fuv_c = np.ascontiguousarray(face_uvs, np.int32)
        tex_c = np.ascontiguousarray(texture, np.float32)
        th, tw = tex_c.shape[:2]
        uv_ptr = uvs_c.ctypes.data_as(dp)
        fuv_ptr = fuv_c.ctypes.data_as(ip)
        tex_ptr = tex_c.ctypes.data_as(fp)
    if face_albedo is not None:
        falb_c = np.ascontiguousarray(face_albedo, np.float64)
        falb_ptr = falb_c.ctypes.data_as(dp)

    zbuf = np.empty((size, size), np.float32)
    nbuf = np.empty((size, size, 3), np.float32)
    rgb = np.empty((size, size, 3), np.float32)
    mask = np.empty((size, size), np.uint8)
    rc = lib.raster_ortho(
        px.ctypes.data_as(dp), py.ctypes.data_as(dp), pz.ctypes.data_as(dp),
        len(verts), vn.ctypes.data_as(dp), vs_ptr, shade_ch,
        faces_c.ctypes.data_as(ip), len(faces_c), size,
        albedo_c.ctypes.data_as(dp), light.ctypes.data_as(dp),
        uv_ptr, fuv_ptr, tex_ptr, th, tw, falb_ptr,
        zbuf.ctypes.data_as(fp), nbuf.ctypes.data_as(fp),
        rgb.ctypes.data_as(fp),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0)
    if rc != 0:
        raise RuntimeError(f"raster_ortho failed (rc={rc})")
    return {"rgb": rgb.astype(np.float64), "mask": mask.astype(bool),
            "zbuf": zbuf.astype(np.float64), "normal": nbuf.astype(np.float64)}


def capsule_calib(size: int, load_size: int, yaw: float = 0.0
                  ) -> np.ndarray:
    """World -> NDC calib of the capsule subject at ``yaw``, as the JAX
    package's dataset generator builds it (``ortho_ratio = 0.2 * 1024 /
    size``, ``uv = 1 / (load_size // 2)``)."""
    ortho_ratio = 0.2 * (1024 / size)
    R = rotation_y(yaw)
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = R
    extrinsic[:3, 3:4] = -(R @ SUBJECT_CENTER).reshape(3, 1)
    s = 1.0 / ortho_ratio
    intr = np.diag([s, -s, s, 1.0])
    uv = np.diag([1.0 / (load_size // 2)] * 3 + [1.0])
    return uv @ intr @ extrinsic


def noise_background(rng: np.random.Generator, size: int) -> np.ndarray:
    """``[size, size, 3]`` uint8 uniform noise drawn from ``rng`` under
    OpenCV's 31 x 31 Gaussian blur (sigma 5, reflected borders), bit-exact:
    near-flat mid grey, channels in the order they are drawn.  The
    generator composites every training image onto such a background, so
    a model trained on them has never seen the renderer's white."""
    bg = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    return gaussian_blur_u8(bg, 31)


def capsule_subject(size: int = 512, height: float = 1.6,
                    radius: float = 0.55):
    """The capsule (``make_capsule(1.6, 0.55, 3)`` unless another shape is
    asked for, 180 units tall, at ``SUBJECT_CENTER``) rendered at
    ``size``^2, yaw 0, as the dataset generator's training image: the
    shaded render composited onto ``noise_background`` of seed 0.  Returns
    ``(rgbd [size, size, 6] f32 in
    [-1, 1], calib [4, 4] f32, verts, faces)``: RGB, then the depth map
    normalised as the generator does (``1 - z_norm`` on the silhouette, 0
    off it) in all three channels."""
    v, f = make_capsule(height, radius, 3)
    v = normalize_mesh_height(v, 180.0) + SUBJECT_CENTER
    calib = capsule_calib(size, size)
    out = rasterize_ortho(v, f, size, calib)
    z, m = out["zbuf"], out["mask"]
    zn = np.zeros_like(z)
    if m.any():
        zmin, zmax = z[m].min(), z[m].max()
        zn[m] = (z[m] - zmin) / max(zmax - zmin, 1e-9)
    depth = np.where(m, 1.0 - zn, 0.0)
    rgb = np.where(m[:, :, None], out["rgb"],
                   noise_background(np.random.default_rng(0), size) / 255.0)
    rgbd = np.concatenate([rgb, np.repeat(depth[:, :, None], 3, 2)], axis=-1)
    return ((rgbd * 2.0 - 1.0).astype(np.float32), calib.astype(np.float32),
            v, f)


# ------------------------------------------------------------ dataset tree
def _mesh_of(name: str):
    if name == "sphere":
        return make_icosphere(3, 1.0)
    if name == "bumpy":
        return make_bumpy_sphere()
    return make_capsule(1.6, 0.55, 3)


def generate_synthetic_dataset(root: str, subjects=("sphere", "capsule"),
                               size: int = 512, load_size: int = 1024,
                               seed: int = 0) -> None:
    """Write a full training tree from analytic meshes (any subject name
    other than ``sphere`` and ``bumpy`` is a capsule).  One generator,
    ``default_rng(seed)``, draws each subject's background in subject
    order, as the JAX package's generator does.  Background draws are
    channel-ordered as OpenCV's BGR arrays were: the first channel drawn is
    the file's blue."""
    rng = np.random.default_rng(seed)
    for d in ("RENDER", "MASK", "DEPTH", "NORM", "PARAM", "OBJ", "gen",
              "normal"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    for si, name in enumerate(subjects):
        v, f = _mesh_of(name)
        center = SUBJECT_CENTER
        v = normalize_mesh_height(v, 180.0) + center
        save_obj_with_color(os.path.join(root, "OBJ", f"{name}_100k.obj"),
                            v, f)
        ortho_ratio = 0.2 * (1024 / size)
        scale = 1.0
        R0 = np.eye(3)
        for d in ("RENDER", "MASK", "DEPTH", "NORM", "PARAM"):
            os.makedirs(os.path.join(root, d, name), exist_ok=True)

        for yaw in (0, 180):
            R = rotation_y(yaw) @ R0
            extrinsic = np.eye(4)
            extrinsic[:3, :3] = R
            extrinsic[:3, 3:4] = -(R @ center).reshape(3, 1)
            s = scale / ortho_ratio
            intr = np.diag([s, -s, s, 1.0])
            uv = np.diag([1.0 / (load_size // 2)] * 3 + [1.0])
            calib = uv @ intr @ extrinsic

            out = rasterize_ortho(v, f, size, calib)
            tag = f"{yaw}_0_00"
            m = out["mask"]
            render = encode_jpeg((out["rgb"] * 255).astype(np.uint8))
            with open(os.path.join(root, "RENDER", name, f"{tag}.jpg"),
                      "wb") as fh:
                fh.write(render)
            write_png(os.path.join(root, "MASK", name, f"{tag}.png"),
                      (m * 255).astype(np.uint8))
            z = out["zbuf"]
            zn = np.zeros_like(z)
            if m.any():
                zmin, zmax = z[m].min(), z[m].max()
                zn[m] = (z[m] - zmin) / max(zmax - zmin, 1e-9)
            depth_png = (255 - 255 * zn).astype(np.uint8)
            depth_png[~m] = 0
            write_png(os.path.join(root, "DEPTH", name, f"{tag}.png"),
                      np.repeat(depth_png[:, :, None], 3, axis=2))
            nimg = np.ones((size, size, 3))
            nimg[m] = out["normal"][m] * 0.5 + 0.5
            if yaw == 180:              # back view: normals inverted
                nimg[m] = 1.0 - nimg[m]
            write_png(os.path.join(root, "NORM", name, f"{tag}.png"),
                      (nimg * 255).astype(np.uint8))
            np.save(os.path.join(root, "PARAM", name, f"{tag}.npy"),
                    {"ortho_ratio": ortho_ratio, "scale": scale,
                     "center": center, "R": R})
            if yaw == 0:
                front, front_mask = decode_jpeg(render), m

        # the training image: the decoded front render on the background
        bg = noise_background(rng, size)[:, :, ::-1]
        comp = np.where(front_mask[:, :, None], front, bg)
        write_png(os.path.join(root, "gen", f"{name}_{si}.png"), comp)

    # style images of the normal-pretraining loss
    style = np.full((size, size, 3), 127, np.uint8)
    style[:, :, 2] = 200
    for n in ("Fnormal.jpg", "Bnormal.jpg"):
        with open(os.path.join(root, "normal", n), "wb") as fh:
            fh.write(encode_jpeg(style))
