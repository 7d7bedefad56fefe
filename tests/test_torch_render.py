"""Offline rendering's building blocks, the port against the JAX package on
the CPU, at tolerance 0 throughout:

- ``data/render.py``: ``sh_basis``, ``sample_sphere_directions``,
  ``sh_rotation_matrix``, ``rotate_sh_coeffs``, ``compute_prt`` and
  ``sh_shade`` give equal arrays, ``ray_any_hit`` equal booleans;
- ``recon/mesh.load_obj_mtl``: equal dicts for PNG (8 and 16 bit, grey,
  RGBA, palette) and JPEG (baseline, progressive, grey) textures, spaced
  file names, quads, negative indices and multi-material files; ``None``
  where ``cv2.imread`` gives ``None``; a BMP texture raises, naming it;
- ``save_ply_points`` / ``save_occupancy_samples_ply``: equal bytes;
- ``utils/png.read_rgb8`` equal to ``cv2.imread`` on palette, low-bit grey
  and 16-bit colour files, and ``resize_image`` equal to ``cv2.resize`` on
  upscales and non-square sizes (the composites' backgrounds).
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from rgbd_pifuhd_tpu.data import render as jr
from rgbd_pifuhd_tpu.recon import mesh as jm
from rgbd_pifuhd_tpu_torch.data import render as tr
from rgbd_pifuhd_tpu_torch.data.preprocessing import resize_image
from rgbd_pifuhd_tpu_torch.data.synthetic import make_bumpy_sphere, make_icosphere
from rgbd_pifuhd_tpu_torch.recon import mesh as tm
from rgbd_pifuhd_tpu_torch.utils import png


def _dirs(n=40, seed=1):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_sh_basis_and_directions_equal(order):
    d = _dirs()
    assert np.array_equal(tr.sh_basis(d, order), jr.sh_basis(d, order))
    a = tr.sample_sphere_directions(5, np.random.default_rng(order))
    b = jr.sample_sphere_directions(5, np.random.default_rng(order))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("yaw", [0.0, 37.0, 180.0])
def test_sh_rotation_equal(yaw):
    r = np.deg2rad(yaw)
    R = np.array([[np.cos(r), 0, np.sin(r)], [0, 1, 0],
                  [-np.sin(r), 0, np.cos(r)]])
    assert np.array_equal(tr.sh_rotation_matrix(R), jr.sh_rotation_matrix(R))
    env = np.arange(9, dtype=np.float64) / 9.0
    assert np.array_equal(tr.rotate_sh_coeffs(env, R),
                          jr.rotate_sh_coeffs(env, R))


def test_ray_any_hit_equal():
    v, f = make_bumpy_sphere(subdiv=2)
    rng = np.random.default_rng(0)
    origins = rng.uniform(-1.3, 1.3, (300, 3))
    for d in (np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, -1.0]),
              np.array([0.3, -0.5, 0.8]), np.array([1.0, 0.0, 0.0])):
        a = tr.ray_any_hit(origins, d, v, f)
        b = jr.ray_any_hit(origins, d, v, f)
        assert a.dtype == bool and np.array_equal(a, b)
        assert 0 < a.sum() < len(a)


@pytest.mark.parametrize("n_dirs,seed", [(3, 0), (6, 5)])
def test_compute_prt_and_shade_equal(n_dirs, seed):
    v, f = make_bumpy_sphere(subdiv=2)
    n = tm.compute_vertex_normals(v, f)
    assert np.array_equal(n, jm.compute_vertex_normals(v, f))
    a = tr.compute_prt(v, f, n, n_dirs=n_dirs, seed=seed)
    b = jr.compute_prt(v, f, n, n_dirs=n_dirs, seed=seed)
    assert a.shape == (len(v), 9) and np.array_equal(a, b)
    env = np.random.default_rng(2).normal(size=(9, 3))
    assert np.array_equal(tr.sh_shade(a, env), jr.sh_shade(b, env))


# ----------------------------------------------------------- load_obj_mtl
def _png_raw(path, w, h, depth, ctype, rows, plte=None):
    def chunk(k, b):
        return (struct.pack(">I", len(b)) + k + b
                + struct.pack(">I", zlib.crc32(k + b) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte.tobytes())
    out += chunk(b"IDAT", zlib.compress(b"".join(b"\x00" + r for r in rows)))
    with open(path, "wb") as fh:
        fh.write(out + chunk(b"IEND", b""))


def _packed_rows(vals, depth):
    return [np.packbits(np.unpackbits(r[:, None], axis=1)[:, 8 - depth:]
                        .reshape(-1)).tobytes() for r in vals]


def _texture(path, kind, rng):
    """Write a 24 x 20 texture of ``kind`` to ``path``."""
    h, w = 20, 24
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind in ("png8", "jpeg"):
        cv2.imwrite(path, img)
    elif kind == "jpeg_progressive":
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                cv2.IMWRITE_JPEG_QUALITY, 90])
    elif kind in ("png_grey", "jpeg_grey"):
        cv2.imwrite(path, img[:, :, 0])
    elif kind == "png_rgba":
        cv2.imwrite(path, np.concatenate(
            [img, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1))
    elif kind == "png16":
        cv2.imwrite(path, rng.integers(0, 65536, (h, w, 3)).astype(np.uint16))
    elif kind in ("png_palette", "png_palette4", "png_grey2"):
        depth = {"png_palette": 8, "png_palette4": 4, "png_grey2": 2}[kind]
        vals = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
        plte = None if kind == "png_grey2" else rng.integers(
            0, 256, (1 << depth, 3)).astype(np.uint8)
        _png_raw(path, w, h, depth, 0 if plte is None else 3,
                 _packed_rows(vals, depth), plte)
    elif kind == "bmp":
        cv2.imwrite(path, img)
    elif kind == "text":
        with open(path, "w") as fh:
            fh.write("not an image\n")
    else:
        raise ValueError(kind)


_EXT = {"jpeg": ".jpg", "jpeg_progressive": ".jpg", "jpeg_grey": ".jpg",
        "bmp": ".bmp", "text": ".png"}


def _write_obj(d, name, materials, quads=False, negative=False):
    """An OBJ (icosphere, spherical UVs) whose faces cycle through
    ``materials`` = [(mtl name, Kd, texture file or None), ...]."""
    v, f = make_icosphere(1)
    uv = np.stack([np.arctan2(v[:, 0], v[:, 2]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(v[:, 1], -1, 1)) / np.pi], 1)
    mtl = f"{name} materials.mtl"
    with open(os.path.join(d, mtl), "w") as fh:
        for m, kd, tex in materials:
            fh.write(f"newmtl {m}\nKd {kd[0]} {kd[1]} {kd[2]}\n")
            if tex:
                fh.write(f"map_Kd {tex}\n")
    path = os.path.join(d, f"{name}.obj")
    with open(path, "w") as fh:
        fh.write(f"mtllib {mtl}\n")
        for p in v:
            fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in uv:
            fh.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        V = len(v)
        for i, tri in enumerate(f):
            if i % 7 == 0:
                fh.write(f"usemtl {materials[(i // 7) % len(materials)][0]}\n")
            a, b, c = (int(x) + 1 for x in tri)
            if negative and i % 3 == 0:
                a, b, c = a - V - 1, b - V - 1, c - V - 1
            if quads and i % 5 == 0:
                fh.write(f"f {a}/{a} {b}/{b} {c}/{c} {a}\n")
            elif i % 11 == 0:
                fh.write(f"f {a} {b} {c}\n")
            else:
                fh.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
    return path


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", [
    "png8", "png16", "png_grey", "png_rgba", "png_palette", "png_palette4",
    "png_grey2", "jpeg", "jpeg_progressive", "jpeg_grey"])
def test_load_obj_mtl_textures_equal(tmp_path, kind):
    tex = f"skin {kind}{_EXT.get(kind, '.png')}"       # a spaced name
    _texture(str(tmp_path / tex), kind, np.random.default_rng(len(kind)))
    path = _write_obj(str(tmp_path), "subj", [("skin", (0.7, 0.6, 0.5),
                                               tex)], quads=True)
    got, want = tm.load_obj_mtl(path), jm.load_obj_mtl(path)
    _same(got, want)
    assert got["texture"].shape == (20, 24, 3)


def test_load_obj_mtl_materials_quads_negative(tmp_path):
    """Multi-material: the first material's map is unreadable (cv2 gives
    None), the second's is read, the third is flat Kd; quads and negative
    indices; then the all-None case and an OBJ without UVs or materials."""
    rng = np.random.default_rng(0)
    _texture(str(tmp_path / "bad.png"), "text", rng)
    _texture(str(tmp_path / "good.jpg"), "jpeg", rng)
    mats = [("a", (0.1, 0.2, 0.3), "bad.png"), ("b", (0.4, 0.5, 0.6),
                                                 "good.jpg"),
            ("c", (0.9, 0.8, 0.7), None), ("d", (0.3, 0.3, 0.3),
                                           "missing.png")]
    p = _write_obj(str(tmp_path), "multi", mats, quads=True, negative=True)
    got = tm.load_obj_mtl(p)
    _same(got, jm.load_obj_mtl(p))
    assert got["texture"] is not None and (got["face_uvs"] == -1).any()
    p = _write_obj(str(tmp_path), "none", [mats[0], mats[2], mats[3]],
                   negative=True)
    got = tm.load_obj_mtl(p)
    _same(got, jm.load_obj_mtl(p))
    assert got["texture"] is None
    bare = str(tmp_path / "bare.obj")
    with open(bare, "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 4 3\n")
    _same(tm.load_obj_mtl(bare), jm.load_obj_mtl(bare))


def test_load_obj_mtl_unsupported_format_raises(tmp_path):
    _texture(str(tmp_path / "skin.bmp"), "bmp", np.random.default_rng(0))
    p = _write_obj(str(tmp_path), "s", [("skin", (0.5, 0.5, 0.5),
                                         "skin.bmp")])
    assert jm.load_obj_mtl(p)["texture"] is not None     # cv2 reads BMP
    with pytest.raises(ValueError, match="BMP"):
        tm.load_obj_mtl(p)


# ------------------------------------------------------------- PLY writers
@pytest.mark.parametrize("colors", [False, True])
def test_ply_writers_equal_bytes(tmp_path, colors):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(57, 3)) * 100
    col = rng.uniform(-0.2, 1.2, (57, 3)) if colors else None
    tm.save_ply_points(str(tmp_path / "a.ply"), pts, col)
    jm.save_ply_points(str(tmp_path / "b.ply"), pts, col)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply"
                                                 ).read_bytes()
    prob = rng.uniform(size=(57, 1))
    tm.save_occupancy_samples_ply(str(tmp_path / "c.ply"), pts, prob)
    jm.save_occupancy_samples_ply(str(tmp_path / "d.ply"), pts, prob)
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "d.ply"
                                                 ).read_bytes()


# ------------------------------------------------- image reading, resizing
@pytest.mark.parametrize("kind", ["png16", "png_rgba", "png_palette",
                                  "png_palette4", "png_grey2"])
def test_png_read_rgb8_matches_cv2(tmp_path, kind):
    p = str(tmp_path / "x.png")
    _texture(p, kind, np.random.default_rng(7))
    assert np.array_equal(png.read_rgb8(p), cv2.imread(p)[:, :, ::-1])


@pytest.mark.parametrize("h,w,size", [(97, 61, 128), (200, 150, 512),
                                      (300, 400, (128, 90)),
                                      (5, 7, (96, 33))])
def test_resize_image_equal_to_cv2(h, w, size):
    img = np.random.default_rng(h).integers(0, 256, (h, w, 3),
                                            dtype=np.uint8)
    dsize = (size, size) if np.isscalar(size) else size
    assert np.array_equal(resize_image(img, size), cv2.resize(img, dsize))
