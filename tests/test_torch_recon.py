"""``gen_mesh`` end to end: the port against the JAX package at res 32 on the
``tests/test_recon.py`` setup (tiny untrained two-level model, random
images, identity calib), norm-free and with GroupNorm MLPs, f32, same
weights.  Required: the same vertex count, the vertex set within 1e-5
after ``lexsort``, the same triangle geometry, colours within 6/255 (all
but at most 1 in 1000 vertices, see below) — and
the port's band-streamed path equal to its one-shot ``evaluate_field`` +
marching path.

The untrained field is flat to f32 rounding: its fd-normal taps differ by
a few ulps, so its normals are rounding noise in either package.  The
colours are therefore compared with the fine MLP's last layer scaled by
``SHARPEN`` (same 0.5 level set, fd differences of hundreds of ulps, no f32
saturation near the surface), on the same vertices (the JAX mesh's),
through each package's fd-normal colouring.  Both colour with a chunk that
divides the vertex count: a chunk that is mostly padding (thousands of
identical rows) leaves GroupNorm's ``E[x^2] - E[x]^2`` ill-conditioned in
either package, so it would compare rounding, not the port.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.recon.mesh import load_obj
from rgbd_pifuhd_tpu.recon.pipeline import Reconstructor as JReconstructor
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import Options
from tests.test_torch_models import configs

RES = 32
SHARPEN = 100.0


def _canon(path):
    v, f, c = load_obj(path)
    o = np.lexsort(v.T)
    t = v[f].reshape(-1, 9)
    return v[o], c[o], t[np.lexsort(t.T)]


@pytest.fixture(scope="module", params=["none", "group"])
def meshes(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"recon_{request.param}")
    rng = np.random.default_rng(0)
    (jl, jg), (tl, tg) = configs(request.param)
    img_l = rng.standard_normal((1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    jm = JMultiResPIFu(cfg=jl, cfg_global=jg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img_l)[None],
                     jnp.asarray(img_g), jnp.zeros((1, 1, 8, 3)),
                     jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                     jnp.zeros((1, 1, 8, 1)))
    data = {"img": img_l, "img_512": img_g, "calib": calib}
    out = {}
    jr = JReconstructor(jm, params, JOptions(resolution=RES))
    out["jax"] = jr.gen_mesh(
        {k: jnp.asarray(v) for k, v in data.items()},
        os.path.join(tmp, "jax.obj"), resolution=RES)
    tm = MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    tr = Reconstructor(tm, Options(resolution=RES), device="cpu")
    out["port"] = tr.gen_mesh(data, os.path.join(tmp, "port.obj"),
                              resolution=RES)
    one = Reconstructor(tm, dataclasses.replace(Options(resolution=RES),
                                                streamed_recon=False),
                        device="cpu")
    out["oneshot"] = one.gen_mesh(data, os.path.join(tmp, "oneshot.obj"),
                                  resolution=RES)

    # colours of the JAX mesh's vertices under the sharpened field
    sharp = jax.tree.map(np.array, params)
    last = sharp["params"]["mlp"][f"dense{len(jl.mlp_dim) - 2}"]
    last["kernel"] *= SHARPEN
    last["bias"] *= SHARPEN
    verts = np.asarray(out["jax"]["verts"], np.float32)
    V = len(verts)
    chunk = next(V // d for d in (4, 3, 2, 1) if V % d == 0)
    jrs = JReconstructor(jm, jax.tree.map(jnp.asarray, sharp),
                         JOptions(resolution=RES))
    jrs._COLOR_CHUNK = tr._COLOR_CHUNK = chunk
    jfeats = jrs.encode(jnp.asarray(img_l), jnp.asarray(img_g))
    out["jax_colors"] = jrs.color_by_normals(verts, jfeats,
                                             jnp.asarray(calib))
    load_params(tm, sharp)
    with torch.no_grad():
        tfeats = tr.encode(torch.from_numpy(img_l), torch.from_numpy(img_g))
        out["port_colors"] = tr.color_by_normals_start(
            verts, tfeats, torch.from_numpy(calib))()
    return tmp, out


def test_port_matches_jax(meshes):
    tmp, out = meshes
    assert len(out["port"]["verts"]) == len(out["jax"]["verts"]) > 100
    vj, cj, tj = _canon(os.path.join(tmp, "jax.obj"))
    vt, ct, tt = _canon(os.path.join(tmp, "port.obj"))
    assert vt.shape == vj.shape and tt.shape == tj.shape
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)


def test_colors_match_jax(meshes):
    _, out = meshes
    cj, ct = out["jax_colors"], out["port_colors"]
    assert ct.shape == cj.shape == (len(out["jax"]["verts"]), 3)
    assert (np.ptp(cj, axis=0) > 0.5).sum() >= 2   # real normals, not noise
    # a vertex whose fd stencil is nearly flat can turn further from f32
    # rounding alone (measured: 0 or 1 of 16,536 per run, at most 11/255)
    off = (np.abs(ct - cj) > 6.0 / 255.0).any(axis=1)
    assert off.mean() < 1e-3, (int(off.sum()), float(np.abs(ct - cj).max()))


def test_montage_matches_jax(meshes):
    """The PNG beside the mesh — the global image's RGB and, with the
    normal nets on, both predicted normal maps — against the file the JAX
    package wrote through OpenCV: the same strip within one grey level
    (each side quantises its own f32 normal maps)."""
    from rgbd_pifuhd_tpu_torch.utils.png import read_png

    tmp, out = meshes
    mine = read_png(os.path.join(tmp, "port.png"))
    ref = read_png(os.path.join(tmp, "jax.png"))
    assert mine.shape == ref.shape and mine.shape[0] == 64
    assert mine.shape[1] in (64, 192) and mine.dtype == np.uint8
    assert np.abs(mine.astype(int) - ref.astype(int)).max() <= 1
    assert np.array_equal(mine, read_png(os.path.join(tmp, "oneshot.png")))


def test_streamed_matches_one_shot(meshes):
    tmp, out = meshes
    assert len(out["port"]["verts"]) == len(out["oneshot"]["verts"])
    vs, cs, ts = _canon(os.path.join(tmp, "port.obj"))
    vo, co, to = _canon(os.path.join(tmp, "oneshot.obj"))
    np.testing.assert_allclose(vs, vo, atol=1e-5)
    np.testing.assert_allclose(ts, to, atol=1e-5)
    np.testing.assert_allclose(cs, co, atol=6.0 / 255.0)


def test_diagnostics_and_query_accounting(meshes):
    _, out = meshes
    port = out["port"]
    assert port["grid_diag"]["budget_cells"] == (RES // 8) ** 3
    pts = port["points_queried"]
    assert set(pts) == {"p1", "p2", "p3", "color"}
    assert pts["p1"] == 1024                       # 5^3 corners, padded
    assert pts["p3"] == port["grid_diag"]["budget_subcells"] * 64
    assert port["query_calls"] >= 4
