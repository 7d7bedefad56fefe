"""Offline data generation, the port against the JAX package on the CPU, at
tolerance 0 throughout:

- ``data/render_dataset.render_dataset`` with and without PRT, on a
  textured and a Kd-only subject: RENDER JPEG bytes equal, MASK / DEPTH /
  NORM decoded pixels equal, PARAM values equal, the OBJ copies equal;
- ``data/composite.composite_over_backgrounds`` without backgrounds and
  with a directory of PNG, baseline, progressive and grey JPEG backgrounds
  of other sizes: ``gen/`` pixels equal;
- the port's ``TrainDataset`` on the port's generated tree gives the JAX
  ``TrainDataset``'s items on the JAX-generated tree;
- ``cli/gen_data`` (both branches), ``cli/encode_objs`` and
  ``cli/debug_vis``: the same printed lines, equal trees, equal files.
"""

import contextlib
import io
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from rgbd_pifuhd_tpu.cli import debug_vis as jdv
from rgbd_pifuhd_tpu.cli import encode_objs as jenc
from rgbd_pifuhd_tpu.cli import gen_data as jgen
from rgbd_pifuhd_tpu.data import composite as jcomp
from rgbd_pifuhd_tpu.data import datasets as jds
from rgbd_pifuhd_tpu.data import render_dataset as jrd
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.cli import debug_vis as tdv
from rgbd_pifuhd_tpu_torch.cli import encode_objs as tenc
from rgbd_pifuhd_tpu_torch.cli import gen_data as tgen
from rgbd_pifuhd_tpu_torch.data import composite as tcomp
from rgbd_pifuhd_tpu_torch.data import datasets as tds
from rgbd_pifuhd_tpu_torch.data import render_dataset as trd
from rgbd_pifuhd_tpu_torch.data.synthetic import (SUBJECT_CENTER,
                                                  make_capsule,
                                                  make_icosphere,
                                                  normalize_mesh_height)
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions


def _write_subjects(d):
    """``skin_100k.obj``: an icosphere 180 units tall at the training box's
    centre, spherical UVs, a PNG ``map_Kd``; ``plain.obj``: a capsule with
    a flat ``Kd`` and no UVs."""
    os.makedirs(d, exist_ok=True)
    v, f = make_icosphere(2)
    uv = np.stack([np.arctan2(v[:, 0], v[:, 2]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(v[:, 1], -1, 1)) / np.pi], 1)
    v = normalize_mesh_height(v) + SUBJECT_CENTER
    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur(rng.integers(0, 256, (64, 64, 3), np.uint8),
                           (5, 5), 0)
    cv2.imwrite(os.path.join(d, "skin tex.png"), tex)
    with open(os.path.join(d, "skin.mtl"), "w") as fh:
        fh.write("newmtl skin\nKd 0.7 0.6 0.5\nmap_Kd skin tex.png\n")
    with open(os.path.join(d, "skin_100k.obj"), "w") as fh:
        fh.write("mtllib skin.mtl\nusemtl skin\n")
        fh.writelines(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n" for p in v)
        fh.writelines(f"vt {t[0]:.5f} {t[1]:.5f}\n" for t in uv)
        fh.writelines(f"f {a}/{a} {b}/{b} {c}/{c}\n" for a, b, c in f + 1)
    v, f = make_capsule(1.6, 0.55, 2)
    v = normalize_mesh_height(v) + SUBJECT_CENTER + np.array([20, 0, 0])
    with open(os.path.join(d, "plain.mtl"), "w") as fh:
        fh.write("newmtl body\nKd 0.2 0.5 0.9\n")
    with open(os.path.join(d, "plain.obj"), "w") as fh:
        fh.write("mtllib plain.mtl\nusemtl body\n")
        fh.writelines(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n" for p in v)
        fh.writelines(f"f {a} {b} {c}\n" for a, b, c in f + 1)


def _assert_trees_equal(ja, pa):
    n = 0
    for dirpath, _, files in os.walk(ja):
        for fn in files:
            a = os.path.join(dirpath, fn)
            b = os.path.join(pa, os.path.relpath(a, ja))
            n += 1
            if fn.endswith(".npy"):
                x = np.load(a, allow_pickle=True).item()
                y = np.load(b, allow_pickle=True).item()
                assert set(x) == set(y)
                assert all(np.array_equal(x[k], y[k]) for k in x), b
            elif fn.endswith(".png"):
                x = cv2.imread(a, cv2.IMREAD_UNCHANGED)
                y = cv2.imread(b, cv2.IMREAD_UNCHANGED)
                assert x.shape == y.shape and np.array_equal(x, y), b
            else:
                assert open(a, "rb").read() == open(b, "rb").read(), b
    n_port = sum(len(f) for _, _, f in os.walk(pa))
    assert n == n_port
    return n


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("objs"))
    _write_subjects(d)
    return d


@pytest.fixture(scope="module")
def trees(objs, tmp_path_factory):
    """Both packages' PRT-shaded trees of the two subjects (4 views)."""
    base = tmp_path_factory.mktemp("gen")
    j, t = str(base / "jax"), str(base / "port")
    kw = dict(size=64, load_size=64, yaw_step=90, use_prt=True)
    wj = jrd.render_dataset(j, objs, **kw)
    wt = trd.render_dataset(t, objs, **kw)
    assert wj == wt == {"skin": 4, "plain": 4}
    return j, t


def test_render_dataset_with_prt_equal(trees):
    n = _assert_trees_equal(*trees)
    assert n == 2 + 2 * 4 * 5


@pytest.mark.parametrize("yaw_step,size", [(180, 64), (120, 96)])
def test_render_dataset_without_prt_equal(objs, tmp_path, yaw_step, size):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(size=size, load_size=128, yaw_step=yaw_step)
    timings: dict = {}
    assert jrd.render_dataset(j, objs, **kw) == trd.render_dataset(
        t, objs, timings=timings, **kw)
    _assert_trees_equal(j, t)
    assert set(timings) == {"load", "raster", "encode"}
    m = cv2.imread(os.path.join(t, "MASK", "skin", "0_0_00.png"), 0)
    r = cv2.imread(os.path.join(t, "RENDER", "skin", "0_0_00.jpg"))
    assert m.any() and r[m > 127].std() > 2       # the texture shows


def _backgrounds(d):
    os.makedirs(d)
    rng = np.random.default_rng(4)
    cv2.imwrite(os.path.join(d, "a.png"),
                rng.integers(0, 256, (50, 70, 3), np.uint8))
    cv2.imwrite(os.path.join(d, "b.jpg"),
                rng.integers(0, 256, (90, 40, 3), np.uint8))
    cv2.imwrite(os.path.join(d, "c.JPEG"),
                rng.integers(0, 256, (130, 150, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cv2.imwrite(os.path.join(d, "d.jpg"),
                rng.integers(0, 256, (33, 47), np.uint8))
    with open(os.path.join(d, "notes.txt"), "w") as fh:
        fh.write("ignored\n")


@pytest.mark.parametrize("with_bgs", [False, True])
def test_composite_equal(trees, tmp_path, with_bgs):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    for dst in (j, t):
        for d in ("RENDER", "MASK"):
            shutil.copytree(os.path.join(trees[0], d), os.path.join(dst, d))
    bgs = None
    if with_bgs:
        bgs = str(tmp_path / "bgs")
        _backgrounds(bgs)
    wj = jcomp.composite_over_backgrounds(j, bgs, per_subject=4, seed=7)
    wt = tcomp.composite_over_backgrounds(t, bgs, per_subject=4, seed=7)
    assert [os.path.relpath(p, j) for p in wj] == [
        os.path.relpath(p, t) for p in wt]
    assert len(wt) == 8
    for a, b in zip(wj, wt):
        assert np.array_equal(cv2.imread(a), cv2.imread(b)), b


def _opts(root):
    common = dict(dataroot=root, load_size=64, load_size_big=64,
                  load_size_local=32, num_sample_inout=200, sigma=3.0)
    return JOptions(**common), TOptions(**common)


def test_train_dataset_on_generated_trees(trees, tmp_path):
    j, t = (str(tmp_path / "jax"), str(tmp_path / "port"))
    shutil.copytree(trees[0], j)
    shutil.copytree(trees[1], t)
    jcomp.composite_over_backgrounds(j)
    tcomp.composite_over_backgrounds(t)
    jo, to = _opts(j)[0], _opts(t)[1]
    jd, td = jds.TrainDataset(jo, seed=3), tds.TrainDataset(to, seed=3)
    assert len(jd) == len(td) == 2
    for i in range(2):
        a, b = jd[i], td[i]
        assert set(a) == set(b) and a["name"] == b["name"]
        for k in a:
            if a[k] is None or isinstance(a[k], str):
                assert a[k] == b[k]
            else:
                assert np.asarray(a[k]).tobytes() == np.asarray(
                    b[k]).tobytes(), k
        assert 0 < b["labels"].sum() < len(b["labels"])


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_gen_data_cli_both_branches(objs, tmp_path):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--obj_dir", objs, "--size", "64", "--load_size", "64",
            "--yaw_step", "180"]
    lj = _run(jgen.main, ["--out", j] + args)
    lt = _run(tgen.main, ["--out", t] + args)
    assert lt[0] == lj[0].replace(j, t) and len(lj) == 1
    assert set(json.loads(lt[1])["seconds"]) == {
        "load", "raster", "encode", "composite", "total"}
    _assert_trees_equal(j, t)
    j2, t2 = str(tmp_path / "jax2"), str(tmp_path / "port2")
    args = ["--size", "64", "--load_size", "64", "--subjects", "bumpy"]
    assert _run(tgen.main, ["--out", t2] + args) == [
        f"wrote synthetic dataset to {t2}"]
    _run(jgen.main, ["--out", j2] + args)
    _assert_trees_equal(j2, t2)


def test_encode_objs_equal(tmp_path):
    for d in ("jax", "port"):
        root = tmp_path / d
        (root / "sub").mkdir(parents=True)
        (root / "a.obj").write_bytes("v 1 2 3\n# çğış\n".encode("ISO-8859-9"))
        (root / "sub" / "b.OBJ").write_bytes("# Ğ\n".encode("ISO-8859-9"))
        (root / "sub" / "c.obj").write_text("# already utf-8 é\n")
        (root / "d.txt").write_bytes("ş".encode("ISO-8859-9"))
    lj = _run(jenc.main, [str(tmp_path / "jax")])
    lt = _run(tenc.main, [str(tmp_path / "port")])
    assert lt == [ln.replace("/jax", "/port") for ln in lj]
    assert lt[-1] == "2 file(s) re-encoded"
    for rel in ("a.obj", "sub/b.OBJ", "sub/c.obj", "d.txt"):
        assert (tmp_path / "jax" / rel).read_bytes() == (
            tmp_path / "port" / rel).read_bytes()
    assert tenc.convert_file(str(tmp_path / "port" / "a.obj")) is False


def test_debug_vis_equal(trees, tmp_path):
    t = str(tmp_path / "tree")
    shutil.copytree(trees[1], t)
    tcomp.composite_over_backgrounds(t)
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    lj = _run(jdv.main, ["--dataroot", t, "--index", "1", "--ply", pj,
                         "--out", str(tmp_path / "j.png")])
    lt = _run(tdv.main, ["--dataroot", t, "--index", "1", "--ply", pt,
                         "--out", str(tmp_path / "t.png")])
    assert lt[0] == lj[0] and lt[0].startswith("subject=skin samples=300 ")
    assert lt[1] == f"wrote {pt}"
    assert open(pj, "rb").read() == open(pt, "rb").read()
