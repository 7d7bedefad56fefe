"""The port's serving path on the CPU (``device='cpu'``, res 32, the tiny
norm-free configs of ``tests/test_torch_models.py``): the resident server's
request loop, the batch CLI, the two-slot ``gen_mesh_many`` against the
port's own sequential calls, and the image-colour / cleanup / PLY outputs
against the JAX ``Reconstructor`` on the same weights and subject.

Tolerances: the two-slot pipeline must give the sequential meshes exactly
(same launches in the same order; only host work moves to the worker), as
sorted vertex and triangle sets: the native marcher's vertex order changes
from run to run.
Against the JAX package: the same vertex count, vertices within 1e-5,
colours within 2/255 (bilinear image samples quantised to uint8 on either
side, so one quantisation step each way).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.recon import mesh as jmesh
from rgbd_pifuhd_tpu.recon.pipeline import (Reconstructor as JReconstructor,
                                            estimate_back_colors as j_back)
from rgbd_pifuhd_tpu.utils import checkpoint as jck
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.cli import run_recon, serve
from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
from rgbd_pifuhd_tpu_torch.recon import mesh as tmesh
from rgbd_pifuhd_tpu_torch.recon.pipeline import (Reconstructor,
                                                  estimate_back_colors)
from rgbd_pifuhd_tpu_torch.utils import png
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import Options
from tests.test_torch_models import configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny model in both packages, three in-memory subjects, a checkpoint
    file and a request directory of two subjects."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    (jl, jg), (tl, tg) = configs("none")
    jm = JMultiResPIFu(cfg=jl, cfg_global=jg)
    calib = np.eye(4, dtype=np.float32)
    subjects = []
    for k in range(3):
        subjects.append({
            "name": f"s{k}",
            "img": rng.standard_normal((1, 32, 32, 6)).astype(np.float32),
            "img_512": rng.standard_normal((1, 64, 64, 6))
            .astype(np.float32),
            "calib": calib,
            "calib_world": np.array(
                [[1.25, 0, 0, 0.1], [0, 1.25, 0, -0.2], [0, 0, 1.25, 0],
                 [0, 0, 0, 1]], np.float32)})
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.asarray(subjects[0]["img"])[None],
                     jnp.asarray(subjects[0]["img_512"]),
                     jnp.zeros((1, 1, 8, 3)), jnp.asarray(calib)[None, None],
                     jnp.asarray(calib)[None], jnp.zeros((1, 1, 8, 1)))
    tm = MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))

    ckpt = str(tmp / "ckpt" / "srv_train_latest")
    jck.save_checkpoint(ckpt, params, JOptions(netG=jg, netMR=jl,
                                               resolution=RES, load_size=64))
    req = tmp / "imgs"
    os.makedirs(req / "depth")
    for stem in ("subject", "zwei"):
        base = (rng.random((64, 64, 6)) * 30).cumsum(0).cumsum(1)
        u8 = (base / base.max((0, 1)) * 255).astype(np.uint8)
        png.write_png(str(req / f"{stem}.png"), u8[:, :, :3])
        png.write_png(str(req / "depth" / f"depth_{stem}.png"), u8[:, :, 3:])
        np.savetxt(str(req / f"{stem}_rect.txt"), np.array([[0, 0, 64, 64]]),
                   fmt="%d")
    return dict(tmp=tmp, jm=jm, params=params, tm=tm, subjects=subjects,
                ckpt=ckpt, req=str(req))


def _canon(v, f, c=None):
    o = np.lexsort(v.T)
    t = v[f].reshape(-1, 9)
    return v[o], None if c is None else c[o], t[np.lexsort(t.T)]


# ------------------------------------------------------------- the server
def test_serve_requests_and_errors(world):
    """The whole CLI in a subprocess over the stdin/stdout protocol, with
    the request mix of ``tests/test_serve.py``: 2 errors, 3 meshes."""
    tmp = world["tmp"]
    requests = (
        f"{tmp}/nonexistent\n"             # error: keeps serving
        f"{world['req']}::wrongstem\n"     # error: keeps serving
        f"{world['req']}::subject\n"       # ok: single subject
        f"{world['req']}\n"                # ok: whole dir -> gen_mesh_many
        "quit\n")
    res = subprocess.run(
        [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.serve",
         "--load_netMR_checkpoint_path", world["ckpt"],
         "--results_path", str(tmp / "results"), "--resolution", str(RES),
         "--loadSize", "64", "--name", "srv", "--device", "cpu"],
        input=requests, capture_output=True, text=True, timeout=600,
        cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["ready"] is True and lines[0]["device"] == "cpu"
    errs = [m for m in lines if "error" in m]
    oks = [m for m in lines if "mesh" in m]
    assert len(errs) == 2 and len(oks) == 3
    assert "nonexistent" in errs[0]["request"]
    assert "wrongstem" in errs[1]["error"]
    assert oks[0]["name"] == "subject"
    assert [m["name"] for m in oks[1:]] == ["subject", "zwei"]
    for m in oks:
        assert m["mesh"].endswith(f"result_{m['name']}_{RES}.obj")
        v, f, c = tmesh.load_obj(m["mesh"])
        assert m["verts"] == len(v) > 0 and len(f) > 0 and c.shape == v.shape
        strip = png.read_png(m["mesh"][:-4] + ".png")      # the montage
        assert strip.shape == (512, 512, 3)     # no normal nets: one panel
    last = lines[-1]
    assert last["quit"] is True
    n = last["launches"]
    assert n["query_calls"] > 0
    # on the CPU the wrappers take their plain versions: nothing launched
    assert n["fused_gather_mlp"] == n["fused_point_mlp"] == 0


def test_serve_loop_in_process(world):
    """``_serve_loop`` itself, image colours + cleanup + PLY, and a
    truncated JPEG subject answered with an error line."""
    tmp = world["tmp"]
    opt = Options.from_dict(dict(
        JOptions(resolution=RES, load_size=64, use_color=2,
                 mesh_format="ply").to_dict()))
    recon = Reconstructor(world["tm"], opt, device="cpu")
    out_dir = str(tmp / "loop")
    os.makedirs(out_dir, exist_ok=True)
    jpg = tmp / "jpgs"
    os.makedirs(jpg, exist_ok=True)
    open(jpg / "a.jpg", "wb").write(b"\xff\xd8\xff")
    np.savetxt(str(jpg / "a_rect.txt"), np.array([[0, 0, 8, 8]]), fmt="%d")
    got = []
    serve._serve_loop(recon, opt, out_dir,
                      [f"{world['req']}::zwei\n", "\n", f"{jpg}\n",
                       "quit\n", f"{world['req']}::subject\n"], got.append)
    assert len(got) == 2                 # nothing after quit
    assert got[0]["name"] == "zwei" and got[0]["mesh"].endswith(".ply")
    v, f, c = tmesh.load_ply(got[0]["mesh"])
    assert len(v) == got[0]["verts"] > 0 and c is not None
    assert "JPEG" in got[1]["error"] and got[1]["request"] == str(jpg)


# ---------------------------------------------------------- gen_mesh_many
@pytest.mark.parametrize("use_color,ext", [(0, "obj"), (1, "obj"),
                                           (2, "ply")])
def test_gen_mesh_many_equals_sequential(world, use_color, ext):
    tmp = world["tmp"]
    opt = Options(resolution=RES)
    subjects = world["subjects"]
    seq_r = Reconstructor(world["tm"], opt, device="cpu")
    seq = []
    for d in subjects:
        p = str(tmp / f"seq_{use_color}_{d['name']}.{ext}")
        seq.append((p, seq_r.gen_mesh(d, p, RES) if use_color == 0 else
                    seq_r.gen_mesh_img_color(d, p, RES,
                                             cleanup=use_color == 2)))
    many_r = Reconstructor(world["tm"], opt, device="cpu")
    paths = [str(tmp / f"many_{use_color}_{d['name']}.{ext}")
             for d in subjects]
    many = many_r.gen_mesh_many(iter(subjects), paths, use_color=use_color,
                                resolution=RES, pipeline=True)
    assert len(many) == len(subjects)
    counts = set()
    load = tmesh.load_ply if ext == "ply" else tmesh.load_obj
    for (sp, s), mp, m in zip(seq, paths, many):
        # the native marcher's threads emit vertices in an order that
        # changes from run to run (two sequential calls differ the same
        # way), so meshes are compared as sorted vertex and triangle sets
        a, b = _canon(*load(sp)), _canon(*load(mp))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
        assert np.array_equal(np.sort(s["verts"], axis=0),
                              np.sort(m["verts"], axis=0))
        # colours: fd normals of a per-point field, or image samples
        np.testing.assert_allclose(a[1], b[1], atol=1.0 / 255.0 + 1e-6)
        assert np.array_equal(png.read_png(sp[:-4] + ".png"),
                              png.read_png(mp[:-4] + ".png"))
        assert m["secs"] > 0 and m["grid_diag"] == s["grid_diag"]
        assert m["query_calls"] == s["query_calls"] > 0
        counts.add(len(m["verts"]))
    assert len(counts) > 1               # three different subjects
    # a callable for the paths and the sequential fallback
    named = []

    def path_of(d):
        named.append(d["name"])
        return str(tmp / f"call_{use_color}_{d['name']}.{ext}")

    again = many_r.gen_mesh_many(subjects[:2], path_of, use_color=use_color,
                                 resolution=RES, pipeline=False)
    assert named == ["s0", "s1"]
    assert np.array_equal(np.sort(again[1]["verts"], axis=0),
                          np.sort(many[1]["verts"], axis=0))


# ------------------------------------------- image colours, cleanup, PLY
@pytest.mark.parametrize("cleanup", [False, True], ids=["plain", "cleanup"])
def test_img_color_and_ply_match_jax(world, cleanup):
    tmp = world["tmp"]
    d = world["subjects"][1]
    jr = JReconstructor(world["jm"], world["params"], JOptions(resolution=RES))
    jd = {k: (jnp.asarray(v) if k in ("img", "img_512") else v)
          for k, v in d.items()}
    jp = str(tmp / f"j_{cleanup}.ply")
    jout = jr.gen_mesh_img_color(jd, jp, RES, cleanup=cleanup)
    tr = Reconstructor(world["tm"], Options(resolution=RES), device="cpu")
    tp = str(tmp / f"t_{cleanup}.ply")
    tout = tr.gen_mesh_img_color(d, tp, RES, cleanup=cleanup)
    assert len(tout["verts"]) == len(jout["verts"]) > 100
    assert len(tout["faces"]) == len(jout["faces"])
    # the port's PLY read by the JAX package's reader and the reverse
    vj, fj, cj = tmesh.load_ply(jp)
    vt, ft, ct = jmesh.load_ply(tp)
    assert vt.shape == vj.shape and ft.shape == fj.shape
    a, b = _canon(vt, ft, ct), _canon(vj, fj, cj)
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    np.testing.assert_allclose(a[2], b[2], atol=1e-5)
    assert np.ptp(b[1], axis=0).min() > 0.2          # real colours
    np.testing.assert_allclose(a[1], b[1], atol=2.0 / 255.0 + 1e-6)
    # and as OBJ through the native writer
    to = str(tmp / f"t_{cleanup}.obj")
    tr.gen_mesh_img_color(d, to, RES, cleanup=cleanup)
    vo, fo, co = tmesh.load_obj(to)
    assert len(vo) == len(vt) and len(fo) == len(ft)
    np.testing.assert_allclose(_canon(vo, fo, co)[1], a[1],
                               atol=0.5 / 255.0 + 1e-4)


def test_mesh_utilities_match_jax(rng):
    """Components, largest component, back-colour inpainting and the PLY
    writer against the JAX package's on a mesh of three pieces."""
    def grid(n, off):
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        v = np.stack([ii.ravel() * 1.0, jj.ravel() * 1.0,
                      np.zeros(n * n)], 1) + off
        idx = np.arange(n * n).reshape(n, n)
        q = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1)
        r = np.stack([idx[1:, 1:], idx[:-1, 1:], idx[1:, :-1]], -1)
        return v, np.concatenate([q.reshape(-1, 3), r.reshape(-1, 3)])
    parts = [grid(4, [0, 0, 0]), grid(9, [20, 0, 1]), grid(6, [50, 3, 2])]
    verts, faces, base = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + base)
        base += len(v)
    verts = np.concatenate(verts).astype(np.float32)
    faces = np.concatenate(faces).astype(np.int32)
    perm = rng.permutation(len(verts))
    inv = np.argsort(perm)
    verts, faces = verts[perm], inv[faces].astype(np.int32)
    faces = faces[rng.permutation(len(faces))]
    mine = tmesh.connected_components(len(verts), faces)
    ref = jmesh.connected_components(len(verts), faces)
    assert len(np.unique(mine)) == len(np.unique(ref)) == 3
    # the same partition, whatever the labels
    assert len(set(zip(mine.tolist(), ref.tolist()))) == 3
    cols = rng.random((len(verts), 5)).astype(np.float32)
    a = tmesh.keep_largest_component(verts, faces, cols)
    b = jmesh.keep_largest_component(verts, faces, cols)
    assert len(a[0]) == 81
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    xyz = rng.uniform(-1, 1, (4000, 3))
    xyz[::3, 2] = rng.uniform(0, 1e-3, len(xyz[::3]))
    c = rng.random((4000, 3))
    np.testing.assert_array_equal(estimate_back_colors(c, xyz),
                                  j_back(c, xyz))


# ---------------------------------------------------------- the batch CLI
def test_run_recon_two_subject_directory(world, capsys):
    tmp = world["tmp"]
    run_recon.main(["--dataroot", world["req"],
                    "--load_netMR_checkpoint_path", world["ckpt"],
                    "--results_path", str(tmp / "batch"),
                    "--resolution", str(RES), "--loadSize", "64",
                    "--name", "b", "--device", "cpu", "--use_color", "1",
                    "--mesh_format", "ply"])
    out = capsys.readouterr().out
    for stem in ("subject", "zwei"):
        p = str(tmp / "batch" / "b" / "recon" / f"result_{stem}_{RES}.ply")
        v, f, c = tmesh.load_ply(p)
        assert len(v) > 0 and f"{p}: verts={len(v)}" in out
    counts = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
    assert counts["query_calls"] > 0 and counts["fused_point_mlp"] == 0
    # one subject of the range, fd colours, OBJ
    run_recon.main(["--dataroot", world["req"],
                    "--load_netMR_checkpoint_path", world["ckpt"],
                    "--results_path", str(tmp / "batch"),
                    "--resolution", str(RES), "--loadSize", "64",
                    "--name", "b", "--device", "cpu", "--start_id", "1",
                    "--end_id", "2"])
    v, f, c = tmesh.load_obj(str(tmp / "batch" / "b" / "recon"
                                 / f"result_zwei_{RES}.obj"))
    assert len(v) > 0 and c.shape == v.shape
    assert not os.path.exists(str(tmp / "batch" / "b" / "recon"
                                  / f"result_subject_{RES}.obj"))
    if not torch.cuda.is_available():       # the demo runs on cuda too
        with pytest.raises(RuntimeError, match="CUDA"):
            run_recon.main(["--demo-sphere", "--results_path",
                            str(tmp / "demo")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_recon.main(["--dataroot", world["req"],
                            "--load_netMR_checkpoint_path", world["ckpt"]])


def test_demo_trained_gives_the_capsule(tmp_path):
    """``--demo-trained`` on the CPU at 64^3: the committed trained model
    reconstructs its capsule (180 units tall at the subject's place)."""
    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject

    run_recon.main(["--demo-trained", "--resolution", "64", "--device",
                    "cpu", "--results_path", str(tmp_path)])
    v, f, c = tmesh.load_obj(str(tmp_path / "pifuhd" / "recon"
                                 / "result_capsule_64.obj"))
    _, _, cv, _ = capsule_subject(128)
    assert len(v) > 1000
    np.testing.assert_allclose(v.min(0), cv.min(0), atol=4.0)
    np.testing.assert_allclose(v.max(0), cv.max(0), atol=4.0)
