"""Traffic of the benchmark: RGB-D subjects and training trees, made from a
seed on the host with NumPy and plain PyTorch.

Each subject is one of the two bodies the committed flagship-lite was
trained on (``rgbd_pifuhd_tpu_torch/data/synthetic.py``: the sphere,
``make_icosphere(3, 1.0)``, and the capsule, ``make_capsule(1.6, 0.55,
3)``, each 180 units tall at ``SUBJECT_CENTER``), rendered
orthographically as that file's ``capsule_subject`` does: albedo (0.8,
0.65, 0.55) under ``|n . l|`` clamped to [0.15, 1] with l = (0.3, 0.6,
-0.8), composited onto blurred uniform noise, the depth map ``1 - z_norm``
on the silhouette.  The bodies are ray-cast exactly instead of
rasterised, so the render needs no native code.  The meshes the training
tree stores are the same polyhedra as the program's generator builds
(frozen copies of ``make_icosphere``, ``make_capsule`` and
``normalize_mesh_height`` of that file).

A PNG writer (frozen copy of ``rgbd_pifuhd_tpu_torch/utils/png.py``'s
``write_png``) stores the images.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SUBJECT_CENTER = np.array([-128.0, 100.0, -434.0])
HEIGHT = 180.0
# the capsule: make_capsule(1.6, 0.55) scaled to 180 units tall
CAPSULE_R = 0.55 * HEIGHT / 2.7
CAPSULE_HALF = 0.8 * HEIGHT / 2.7
SPHERE_R = HEIGHT / 2.0
_ALBEDO = np.array([0.8, 0.65, 0.55])
_LIGHT = np.array([0.3, 0.6, -0.8]) / np.linalg.norm([0.3, 0.6, -0.8])


# ------------------------------------------------------------------ PNG
def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 3) -> None:
    """``[H, W]`` gray or ``[H, W, 3]`` RGB uint8, filter type 0."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3):
        raise ValueError(f"write_png takes uint8 images, got {a.dtype}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + w * (1 if a.ndim == 2 else 3)), np.uint8)
    rows[:, 1:] = a.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


# --------------------------------------------------------------- meshes
def make_icosphere(subdiv: int = 3, radius: float = 1.0):
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdiv):
        mids: dict = {}
        vlist = list(verts)
        new = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = vlist[a] + vlist[b]
                mids[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return mids[key]

        for f in faces:
            a, b, c = (int(x) for x in f)
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.asarray(vlist), np.asarray(new, np.int64)
    return verts * radius, faces


def body_mesh(kind: str):
    """World verts and faces of ``sphere`` or ``capsule``, 180 units tall
    at ``SUBJECT_CENTER``."""
    v, f = make_icosphere(3, 1.0 if kind == "sphere" else 0.55)
    if kind != "sphere":
        v = v.copy()
        v[:, 1] += np.where(v[:, 1] > 0, 0.8, -0.8)
    lo, hi = v.min(0), v.max(0)
    v = (v - (lo + hi) / 2) * (HEIGHT / (hi[1] - lo[1]))
    return v + SUBJECT_CENTER, f


# -------------------------------------------------------------- render
def calib_of(size: int, yaw_deg: float = 0.0) -> np.ndarray:
    """World -> NDC of the training renders (ortho ratio 0.2 x 1024 /
    size, uv 1 / (size // 2)), as ``capsule_calib(size, size, yaw)``."""
    r = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(r), 0, np.sin(r)], [0, 1, 0],
                  [-np.sin(r), 0, np.cos(r)]])
    ext = np.eye(4)
    ext[:3, :3] = R
    ext[:3, 3] = -R @ SUBJECT_CENTER
    s = 1.0 / (0.2 * 1024 / size)
    return np.diag([1.0 / (size // 2)] * 3 + [1.0]) @ np.diag(
        [s, -s, s, 1.0]) @ ext


def render(kind: str, size: int):
    """Ray-cast ``kind`` (a body of revolution about the vertical axis, so
    its yaw changes nothing) at ``size``^2: ``(rgb [H, W, 3] in [0, 1],
    mask [H, W], depth [H, W] = 1 - z_norm on the mask)``."""
    k = (size // 2) * (0.2 * 1024 / size)     # camera units per NDC unit
    u = np.arange(size) / (size - 1) * 2 - 1
    X, Y = np.meshgrid(u * k, -u * k)          # camera x, y (y up)
    if kind == "sphere":
        R, dy = SPHERE_R, np.zeros_like(Y)
    else:
        R = CAPSULE_R
        dy = Y - np.clip(Y, -CAPSULE_HALF, CAPSULE_HALF)
    rho2 = X * X + dy * dy
    mask = rho2 <= R * R
    zc = -np.sqrt(np.maximum(R * R - rho2, 0.0))  # nearest hit, camera z
    # unit normal in NDC (y flipped), as the rasteriser shades with
    n = np.stack([X, -dy, zc], -1) / R
    shade = np.clip(np.abs(n @ _LIGHT), 0.15, 1.0)
    rgb = _ALBEDO * shade[..., None]
    z = np.where(mask, zc, np.inf)
    zn = np.zeros_like(z)
    zmin, zmax = z[mask].min(), z[mask].max()
    zn[mask] = (z[mask] - zmin) / max(zmax - zmin, 1e-9)
    depth = np.where(mask, 1.0 - zn, 0.0)
    return rgb, mask, depth


def noise_background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Uniform noise under a 31-tap Gaussian blur (sigma 5, reflected
    borders): near-flat mid grey, ``[size, size, 3]`` uint8."""
    from scipy.ndimage import convolve1d

    bg = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    g = np.exp(-((np.arange(31) - 15.0) ** 2) / (2 * 25.0))
    g /= g.sum()
    x = convolve1d(bg.astype(np.float32), g, axis=1, mode="mirror")
    x = convolve1d(x, g, axis=0, mode="mirror")
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def subject_pixels(kind: str, size: int, rng: np.random.Generator):
    """The request subject's files' pixels: ``(rgb u8 [H, W, 3], depth u8
    [H, W, 3])``, as ``chip_smoke._write_subject`` stores them."""
    rgb, mask, depth = render(kind, size)
    bg = noise_background(rng, size) / 255.0
    rgb = np.where(mask[..., None], rgb, bg)
    u8 = lambda a: np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    return u8(rgb), u8(np.repeat(depth[..., None], 3, 2))


def write_subject(root: str, stem: str, rgb: np.ndarray,
                  depth: np.ndarray) -> None:
    """``<stem>.png``, ``depth/depth_<stem>.png`` and ``<stem>_rect.txt``
    (the whole frame) under ``root``."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    write_png(os.path.join(root, f"{stem}.png"), rgb)
    write_png(os.path.join(root, "depth", f"depth_{stem}.png"), depth)
    with open(os.path.join(root, f"{stem}_rect.txt"), "w") as f:
        f.write(f"0 0 {rgb.shape[1]} {rgb.shape[0]}\n")


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in verts))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces))


def write_tree(root: str, subjects, size: int, images_per_subject: int,
               rng: np.random.Generator) -> dict:
    """A training tree as ``TrainDataset`` reads it: ``gen/<subject>_<i>.png``
    (the front render on a fresh background each), ``DEPTH/<subject>/
    0_0_00.png`` (``255 - 255 z_norm`` on the silhouette), ``PARAM/
    <subject>/0_0_00.npy`` ({ortho_ratio, scale, center, R} at the
    subject's yaw) and ``OBJ/<subject>_100k.obj``.  ``subjects`` is a list
    of ``(name, kind, yaw)``.  Returns ``{name: (kind, yaw, rgb u8, depth
    u8 per image)}``: the pixels the reference builds its batches from."""
    out = {}
    for d in ("gen", "DEPTH", "PARAM", "OBJ"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name, kind, yaw in subjects:
        rgb, mask, depth = render(kind, size)
        dep = np.where(mask, (255 - 255 * (1.0 - depth)).astype(np.uint8),
                       0).astype(np.uint8)
        dep3 = np.repeat(dep[..., None], 3, 2)
        for d in ("DEPTH", "PARAM"):
            os.makedirs(os.path.join(root, d, name), exist_ok=True)
        write_png(os.path.join(root, "DEPTH", name, "0_0_00.png"), dep3)
        r = np.deg2rad(yaw)
        R = np.array([[np.cos(r), 0, np.sin(r)], [0, 1, 0],
                      [-np.sin(r), 0, np.cos(r)]])
        np.save(os.path.join(root, "PARAM", name, "0_0_00.npy"),
                {"ortho_ratio": 0.2 * 1024 / size, "scale": 1.0,
                 "center": SUBJECT_CENTER, "R": R})
        v, f = body_mesh(kind)
        write_obj(os.path.join(root, "OBJ", f"{name}_100k.obj"), v, f)
        imgs = []
        for i in range(images_per_subject):
            bg = noise_background(rng, size)
            comp = np.where(mask[..., None],
                            (rgb * 255).astype(np.uint8), bg)
            write_png(os.path.join(root, "gen", f"{name}_{i}.png"), comp)
            imgs.append(comp)
        out[name] = (kind, yaw, imgs, dep3)
    return out
