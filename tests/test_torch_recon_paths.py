"""The other inference paths of ``gen_mesh`` against the JAX package at res
32 on the ``tests/test_torch_recon.py`` setup (tiny untrained models,
random images, identity calib, f32, the same weights; norm-free and
GroupNorm MLPs): ``octree_levels=2``, the dense lattice
(``use_octree=False``) and ``CoarseReconstructor``, and the CLI flags that
select them.

Required: the same vertex count, the vertex set within 1e-5 and the same
triangles (sorted: the native marcher's vertex order changes from run to
run; the dense path, see the test), and the colours within 2/255 for all
but at most 1 in 1000 vertices (geometric normals on the two-level path;
``grad`` colours on the dense path and of the coarse model: a gradient
jumps where f32 rounding moves a unit across a leaky-relu kink,
``tests/test_torch_normal_modes.py``).  The grad colours use one chunk of
the whole mesh on both sides, so that GroupNorm pools over the same
vertices (fd colours of these untrained, flat fields would compare
rounding noise).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_pifuhd_tpu.models import CoarsePIFu as JCoarsePIFu
from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.recon.mesh import load_obj
from rgbd_pifuhd_tpu.recon.pipeline import (
    CoarseReconstructor as JCoarseReconstructor, Reconstructor as JRecon)
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
from rgbd_pifuhd_tpu_torch.recon import CoarseReconstructor, Reconstructor
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import Options
from tests.test_torch_models import configs

RES = 32


def _canon(path):
    v, f, c = load_obj(path)
    o = np.lexsort(v.T)
    t = v[f].reshape(-1, 9)
    return v[o], c[o], t[np.lexsort(t.T)]


def _u8(c):
    return np.round(np.clip(c, 0.0, 1.0) * 255.0).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _models(variant):
    rng = np.random.default_rng(0)
    (jl, jg), (tl, tg) = configs(variant)
    img_l = rng.standard_normal((1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    jm = JMultiResPIFu(cfg=jl, cfg_global=jg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img_l)[None],
                     jnp.asarray(img_g), jnp.zeros((1, 1, 8, 3)),
                     jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                     jnp.zeros((1, 1, 8, 1)))
    tm = MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    tc = CoarsePIFu(tg, device="cpu")
    load_params(tc, jax.tree.map(np.asarray, params["params"]["netG"]))
    return dict(jm=jm, params=params, tm=tm, jc=JCoarsePIFu(jg), tc=tc,
                data={"img": img_l, "img_512": img_g, "calib": calib})


@pytest.fixture
def models(request):
    """The tiny models of ``request.param`` (built once a module)."""
    return _models(request.param)


def _pair(models, path: str, **kw):
    """(JAX reconstructor, port reconstructor) for one path."""
    opt = dict(resolution=RES, **kw)
    if path == "coarse":
        return (JCoarseReconstructor(
            models["jc"], {"params": models["params"]["params"]["netG"]},
            JOptions(**opt)),
            CoarseReconstructor(models["tc"], Options(**opt), device="cpu"))
    return (JRecon(models["jm"], models["params"], JOptions(**opt)),
            Reconstructor(models["tm"], Options(**opt), device="cpu"))


@pytest.mark.parametrize("models,path,kw", [
    ("none", "two_level", dict(octree_levels=2, normal_mode="mesh")),
    ("none", "dense", dict(use_octree=False, normal_mode="grad")),
    ("group", "dense", dict(use_octree=False, normal_mode="grad")),
    ("group", "coarse", dict(normal_mode="grad"))],
    ids=["none-two_level", "none-dense", "group-dense", "group-coarse"],
    indirect=["models"])
def test_path_matches_jax(models, tmp_path, path, kw):
    """The two-level path with geometric colours (the device colour pass
    is ``tests/test_torch_normal_modes.py``'s), the dense path and the
    coarse model alone with grad colours (a point's gradient does not move
    with its neighbours, as a geometric normal does: the dense path's
    vertices move by f32 rounding, see below)."""
    data = models["data"]
    jr, tr = _pair(models, path, **kw)
    if kw["normal_mode"] == "grad":
        probe = dataclasses.replace(tr.opt, normal_mode="mesh")
        V = len(type(tr)(tr.model, probe, device="cpu").gen_mesh(
            data, str(tmp_path / "probe.obj"), resolution=RES)["verts"])
        jr._COLOR_CHUNK = tr._COLOR_CHUNK = V
    jr.gen_mesh({k: jnp.asarray(v) for k, v in data.items()},
                str(tmp_path / "jax.obj"), resolution=RES)
    out = tr.gen_mesh(data, str(tmp_path / "port.obj"), resolution=RES)
    vj, cj, tj = _canon(str(tmp_path / "jax.obj"))
    vt, ct, tt = _canon(str(tmp_path / "port.obj"))
    assert len(vt) == len(vj) == len(out["verts"]) > 100
    if path == "dense":
        # the dense path interpolates the raw f32 field along the lattice
        # edges (the octrees quantise it to 4 bits first): on these flat
        # fields an edge's two values can differ by little more than their
        # f32 rounding, which then moves the crossing.  Compared as nearest
        # neighbours (a moved vertex can change the sorted order): every
        # vertex and triangle within 1e-3 (1.6 % of a voxel), all but 1 %
        # of the vertices within 1e-5 (measured: at most 2e-4; 0.03 % of
        # the coordinates beyond 1e-5 norm-free, 0.6 % GroupNorm)
        from scipy.spatial import cKDTree

        for a, b, frac in ((vt, vj, 1e-2), (tt, tj, 1.0)):
            d = np.maximum(cKDTree(b).query(a)[0], cKDTree(a).query(b)[0])
            assert (d > 1e-5).mean() <= frac and d.max() <= 1e-3, (
                float((d > 1e-5).mean()), float(d.max()))
        cj = cj[cKDTree(vj).query(vt)[1]]
    else:
        np.testing.assert_allclose(vt, vj, atol=1e-5)
        np.testing.assert_allclose(tt, tj, atol=1e-5)
    d = np.abs(_u8(ct) - _u8(cj)).max(axis=1)
    assert (d > 2).mean() <= 1e-3, (int((d > 2).sum()), int(d.max()))
    pts = out["points_queried"]
    if path == "dense":
        assert pts["field"] == RES ** 3 and out["query_calls"] == RES + 1
        assert out["grid_diag"] is None
    elif path == "two_level":
        assert set(pts) == {"field"}
        assert out["grid_diag"]["budget_cells"] == (RES // 8) ** 3
    else:
        assert set(pts) == {"p1", "p2", "p3", "color"}


@pytest.mark.parametrize("models", ["none"], indirect=True)
def test_occupancy_volume_matches_jax(models):
    """The dense volume pulled to the host (two-level densified from the
    sparse pull, two-level dense on the device, every lattice point)."""
    import torch

    jr, tr = _pair(models, "multires")
    data = models["data"]
    jf = jr.encode(jnp.asarray(data["img"]), jnp.asarray(data["img_512"]))
    with torch.inference_mode():
        tf = tr.encode(torch.from_numpy(data["img"]),
                       torch.from_numpy(data["img_512"]))
        c = torch.from_numpy(data["calib"])
        for kw in (dict(), dict(sparse_transfer=False),
                   dict(use_octree=False)):
            tv, tcells = tr.occupancy_volume(*tf, c, RES, **kw)
            jv, jcells = jr.occupancy_volume(*jf, jnp.asarray(data["calib"]),
                                             RES, **kw)
            assert tv.shape == (RES,) * 3
            if tcells is None:
                assert jcells is None
                np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5)
            else:
                assert np.array_equal(tcells, jcells)
                # only the scan cells' neighbourhood is written
                assert np.array_equal(tv, np.asarray(jv))


@pytest.mark.parametrize("flags,calls", [
    (["--normal_mode", "mesh"], 3), (["--normal_mode", "grad"], 4),
    (["--octree_levels", "2"], 3), (["--no_octree"], RES + 1)],
    ids=["mesh", "grad", "two_level", "dense"])
def test_run_recon_flags_act(tmp_path, capsys, flags, calls):
    """``cli.run_recon --device cpu`` on the committed ``bench_tiny``
    checkpoint and JPEG subject: each flag reaches the reconstructor (the
    checkpoint's saved options do not override it) and a mesh is written.
    Field queries: three octree phases and no colour query (mesh), one
    colour query (grad, fewer than 65,536 vertices), the corners and one
    chunk of 512 cells then colours (two-level), one slab of res^2 points
    a call then colours (dense)."""
    import json

    from rgbd_pifuhd_tpu_torch.cli import run_recon
    from rgbd_pifuhd_tpu_torch.cli.common import load_reconstructor
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["--load_netMR_checkpoint_path",
            os.path.join(repo, "assets", "bench_tiny", "ckpt"),
            "--dataroot", os.path.join(repo, "tests", "data", "jpeg_subject"),
            "--results_path", str(tmp_path), "--resolution", str(RES),
            "--loadSize", "128", "--device", "cpu"] + flags
    opt, dev = parse_options(args, with_device=True)
    r = load_reconstructor(opt, dev)[0]
    assert (r.opt.normal_mode, r.opt.octree_levels, r.opt.use_octree) == (
        opt.normal_mode, opt.octree_levels, opt.use_octree)
    run_recon.main(args)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    n = json.loads(last.split(" ", 1)[1])
    v, f, _ = load_obj(str(tmp_path / opt.name / "recon" /
                           f"result_capsule_{RES}.obj"))
    assert len(v) > 0 and len(f) > 0
    assert n["query_calls"] == calls, n


@pytest.mark.parametrize("res,kw", [
    (64, {}), (64, dict(streamed_recon=False, normal_mode="mesh")),
    (256, dict(octree_levels=2, normal_mode="mesh"))],
    ids=["streamed", "oneshot", "two_level"])
def test_budget_loop_escalates(tmp_path, res, kw):
    """Budgets far below the active counts (``bench_tiny``'s trained
    capsule): each octree path runs the one budget loop.  It escalates
    through ``Reconstructor.escalate`` (cells only on the two-level
    octree), dispatches again and ends without overflow; the mesh is the
    one of the escalated budgets given as options, and the next mesh
    starts at them."""
    from rgbd_pifuhd_tpu_torch.cli.common import load_item, load_reconstructor
    from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.join(repo, "tests", "data", "jpeg_subject")
    opt, dev = parse_options(
        ["--load_netMR_checkpoint_path",
         os.path.join(repo, "assets", "bench_tiny", "ckpt"),
         "--dataroot", root, "--loadSize", "128", "--device", "cpu"],
        with_device=True)
    loaded, opt = load_reconstructor(opt, dev)[:2]

    def recon(cells, subcells):
        return Reconstructor(loaded.model, dataclasses.replace(
            opt, num_refine_cells=cells, num_refine_subcells=subcells, **kw),
            device="cpu")

    data = load_item(InferenceDataset(root, 128), 0)
    tight = recon(1, 8)
    grown = []
    escalate = tight.escalate

    def spy(*a):
        grown.append(escalate(*a))
        return grown[-1]

    tight.escalate = spy
    out = tight.gen_mesh(data, str(tmp_path / "tight.obj"), res)
    assert len(grown) >= 2 and grown[-1] is None
    assert all(g is not None for g in grown[:-1])
    d = out["grid_diag"]
    assert d["overflow_cells"] == d["overflow_subcells"] == 0
    esc = tight._esc_budgets[res]
    assert tight.budgets(res) == (esc["cells"], esc["subcells"])
    assert d["budget_cells"] == esc["cells"] > 1
    same = recon(esc["cells"], esc["subcells"]).gen_mesh(
        data, str(tmp_path / "same.obj"), res)
    assert same["grid_diag"] == d
    a = _canon(str(tmp_path / "tight.obj"))
    b = _canon(str(tmp_path / "same.obj"))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
    grown.clear()
    again = tight.gen_mesh(data, str(tmp_path / "again.obj"), res)
    assert grown == [None] and again["query_calls"] == same["query_calls"]
