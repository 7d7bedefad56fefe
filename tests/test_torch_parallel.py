"""The port's device meshes and sharded evaluation against the JAX
package's, on an 8-shard ``cpu`` mesh (``make_device_mesh(devices=["cpu"]
* 8)``) and JAX's 8 virtual CPU devices (conftest).

The model is the GroupNorm tiny pair of ``tests/test_torch_models.py``
(``mlp_norm='group'``, f32): a sharded call takes GroupNorm's statistics
over each shard, in either package, so the port is held against JAX's
sharded result (and the test checks that this differs from the unsharded
one).  Tolerances: queries 1e-5; meshes as sorted vertex and triangle sets
within 1e-5, colours within one level (1/255) for all but at most 1 in
1000 vertices — the field's last layer is scaled by ``SHARPEN`` so the fd
normals are the field's and not f32 rounding (``tests/test_torch_recon.
py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models import CoarsePIFu as JCoarse
from rgbd_pifuhd_tpu.models import MultiResPIFu as JMulti
from rgbd_pifuhd_tpu.parallel import make_device_mesh as jmake_mesh
from rgbd_pifuhd_tpu.parallel import shard_arg_axis as jshard_arg_axis
from rgbd_pifuhd_tpu.recon.mesh import load_obj
from rgbd_pifuhd_tpu.recon.pipeline import CoarseReconstructor as JCoarseR
from rgbd_pifuhd_tpu.recon.pipeline import Reconstructor as JRecon
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
from rgbd_pifuhd_tpu_torch.models.mlp import PointMLP
from rgbd_pifuhd_tpu_torch.parallel import (
    make_device_mesh, replicate, shard_arg_axis, shard_batch,
    shard_points_query)
from rgbd_pifuhd_tpu_torch.recon.pipeline import (
    CoarseReconstructor, Reconstructor)
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import Options
from tests.test_torch_models import configs

RES = 32
SHARPEN = 100.0
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def world():
    """One JAX init of the GroupNorm tiny pair, its sharpened copy, the
    port's models on both, and the inputs."""
    rng = np.random.default_rng(0)
    (jl, jg), (tl, tg) = configs("group")
    img_l = rng.standard_normal((1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    jm = JMulti(cfg=jl, cfg_global=jg)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(img_l)[None], jnp.asarray(img_g),
        jnp.zeros((1, 1, 8, 3)), jnp.asarray(calib)[None, None],
        jnp.asarray(calib)[None], jnp.zeros((1, 1, 8, 1)))
    sharp = jax.tree.map(np.array, params)
    last = sharp["params"]["mlp"][f"dense{len(jl.mlp_dim) - 2}"]
    last["kernel"] *= SHARPEN
    last["bias"] *= SHARPEN
    tm, tm_sharp = (MultiResPIFu(tl, tg, device="cpu") for _ in range(2))
    load_params(tm, jax.tree.map(np.asarray, params))
    load_params(tm_sharp, sharp)
    return {"jm": jm, "params": params, "tm": tm,
            "sharp": jax.tree.map(jnp.asarray, sharp), "tm_sharp": tm_sharp,
            "cfg": (jl, jg, tl, tg),
            "data": {"img": img_l, "img_512": img_g, "calib": calib},
            "pts": rng.uniform(-0.9, 0.9, (4096, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def recons(world):
    """One JAX ``Reconstructor(mesh=...)`` per weight set (its jitted
    closures compile once for the module's tests), the port's beside each,
    and both packages' features of the plain weights."""
    d = world["data"]
    out = {}
    for key, jp, tm in (("plain", world["params"], world["tm"]),
                        ("sharp", world["sharp"], world["tm_sharp"])):
        out[key] = (JRecon(world["jm"], jp, JOptions(resolution=RES),
                           mesh=jmake_mesh()),
                    Reconstructor(tm, Options(resolution=RES), device="cpu",
                                  mesh=make_device_mesh(devices=CPU8)))
    jr, tr = out["plain"]
    out["jfeats"] = jr.encode(jnp.asarray(d["img"]),
                              jnp.asarray(d["img_512"]))
    with torch.no_grad():
        out["tfeats"] = tr.encode(torch.from_numpy(d["img"]),
                                  torch.from_numpy(d["img_512"]))
    return out


def test_sharded_query_matches_jax(world, recons):
    """``Reconstructor(mesh=...)._query`` (``shard_points_query``): one
    call a shard, 1e-5 of JAX's sharded query; it equals the port's plain
    query on each shard and differs from the unsharded call (GroupNorm per
    shard).  ``sharded_query=`` wraps the query the same way."""
    jr, tr = recons["plain"]
    (jl, jg), (tl, tg) = recons["jfeats"], recons["tfeats"]
    pts, calib = world["pts"], world["data"]["calib"]
    want = np.asarray(jax.jit(jr._query)(
        jnp.asarray(pts), world["params"], jl, jg, jnp.asarray(calib)))
    tr.query_calls = 0
    tp, tc = torch.from_numpy(pts), torch.from_numpy(calib)
    with torch.no_grad():
        got = tr._query(tp, tl, tg, tc).numpy()
        parts = [tr._query_one(p, tl, tg, tc) for p in tp.split(512)]
        whole = tr._query_one(tp, tl, tg, tc).numpy()
        other = Reconstructor(world["tm"], Options(), device="cpu",
                              sharded_query=lambda q: shard_points_query(
                                  q, tr.mesh))._query(tp, tl, tg, tc)
    assert tr.query_calls == 8 + 8 + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, torch.cat(parts).numpy())
    np.testing.assert_array_equal(got, other.numpy())
    assert np.abs(got - whole).max() > 1e-4       # statistics per shard


def test_shard_arg_axis_dim1_matches_jax(world, recons):
    """``shard_arg_axis(fn, mesh, 0, dim=1)`` over ``[K, M, 3]`` point
    groups (the layout of the JAX colouring passes): each shard maps its
    ``[K, M / 8, 3]`` slice group by group."""
    _, tr = recons["plain"]
    (jl, jg), (tl, tg) = recons["jfeats"], recons["tfeats"]
    jm, params = world["jm"], world["params"]
    calib = world["data"]["calib"]
    groups = world["pts"].reshape(2, 2048, 3)

    def jfn(pk, p, lf, gf, cal):
        return jax.lax.map(lambda q: jm.apply(
            p, lf, gf, q[None, None], cal[None, None], cal[None],
            method=JMulti.query).preds[0, :, 0], pk)

    def tfn(pk, lf, gf, cal):
        return torch.stack([tr._query_one(q, lf, gf, cal) for q in pk])

    want = np.asarray(jax.jit(jshard_arg_axis(jfn, jmake_mesh(), 0, dim=1))(
        jnp.asarray(groups), params, jl, jg, jnp.asarray(calib)))
    with torch.no_grad():
        got = shard_arg_axis(tfn, tr.mesh, 0, dim=1)(
            torch.from_numpy(groups), tl, tg, torch.from_numpy(calib))
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _canon(path):
    """Sorted vertices, their colours as levels 0..255, sorted triangles."""
    v, f, c = load_obj(path)
    o = np.lexsort(v.T)
    t = v[f].reshape(-1, 9)
    return v[o], np.rint(c[o] * 255.0), t[np.lexsort(t.T)]


@pytest.mark.parametrize("colour", ["normals", "image"])
def test_reconstructor_mesh_matches_jax(world, recons, tmp_path, colour):
    """``gen_mesh`` (fd colours, and image colours with ``use_color=1``)
    of ``Reconstructor(mesh=...)`` at 32^3 against JAX's: the meshes, and the
    colours.  Image colours are read from the files.  The fd colours of a
    GroupNorm field depend on which vertices share a chunk, which follows
    the marcher's run-to-run vertex order, so they are held on the JAX
    mesh's vertex array, in one chunk of ``V`` rounded up to the mesh
    (each shard's 4 taps its GroupNorm population in both packages)."""
    d = world["data"]
    jr, tr = recons["sharp"]
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    pj, pt = str(tmp_path / "jax.obj"), str(tmp_path / "port.obj")
    if colour == "normals":
        jout = jr.gen_mesh(jd, pj, resolution=RES)
        out = tr.gen_mesh(d, pt, resolution=RES)
    else:
        jr.gen_mesh_img_color(jd, pj, resolution=RES)
        out = tr.gen_mesh(d, pt, resolution=RES, use_color=1)
    vj, cj, tj = _canon(pj)
    vt, ct, tt = _canon(pt)
    assert vt.shape == vj.shape and len(vt) > 100
    assert tt.shape == tj.shape
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    assert out["query_calls"] % 8 == 0
    if colour == "normals":
        verts = np.asarray(jout["verts"], np.float32)
        calib = d["calib"]
        # one chunk of V rounded up to the mesh (instance attributes,
        # dropped after: the image colours keep 65,536)
        jr._COLOR_CHUNK = tr._COLOR_CHUNK = -(-len(verts) // 8) * 8
        try:
            cj = np.rint(255 * jr.color_by_normals(verts, jr.encode(
                jd["img"], jd["img_512"]), jnp.asarray(calib)))
            with torch.no_grad():
                feats = tr.encode(torch.from_numpy(d["img"]),
                                  torch.from_numpy(d["img_512"]))
                ct = np.rint(255 * tr.color_by_normals_start(
                    verts, feats, torch.from_numpy(calib))())
        finally:
            del jr._COLOR_CHUNK, tr._COLOR_CHUNK
    assert (np.ptp(cj, axis=0) > 80).sum() >= 2      # real colours
    off = (np.abs(ct - cj) > 1).any(axis=1)
    # a vertex whose fd stencil is nearly flat turns further from f32
    # rounding alone (tests/test_torch_recon.py; measured here: 0 image
    # colours, 4-9 of 18,399 fd-coloured vertices, at most 16 levels)
    assert off.mean() <= 1e-3, (off.sum(), np.abs(ct - cj).max())


def test_coarse_reconstructor_mesh_matches_jax(world, tmp_path):
    """``CoarseReconstructor(mesh=...)`` on the pair's netG."""
    jl, jg, tl, tg = world["cfg"]
    d = world["data"]
    jc = JCoarse(jg)
    jparams = {"params": world["sharp"]["params"]["netG"]}
    tc = CoarsePIFu(tg, device="cpu")
    load_params(tc, jax.tree.map(np.asarray, jparams))
    jr = JCoarseR(jc, jparams, JOptions(resolution=RES), mesh=jmake_mesh())
    tr = CoarseReconstructor(tc, Options(resolution=RES), device="cpu",
                             mesh=make_device_mesh(devices=CPU8))
    pj, pt = str(tmp_path / "jax.obj"), str(tmp_path / "port.obj")
    jr.gen_mesh({k: jnp.asarray(v) for k, v in d.items()}, pj,
                resolution=RES)
    tr.gen_mesh(d, pt, resolution=RES)
    vj, cj, tj = _canon(pj)
    vt, ct, tt = _canon(pt)
    assert vt.shape == vj.shape and len(vt) > 100
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(ct, cj, atol=1)


def test_indivisible_size_raises():
    mesh = make_device_mesh(devices=CPU8)
    q = shard_points_query(lambda p: p.sum(-1), mesh)
    assert q(torch.ones(16, 3)).shape == (16,)
    with pytest.raises(ValueError, match="not divisible"):
        q(torch.ones(1001, 3))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, torch.ones(7, 2))


def test_make_device_mesh_shapes():
    m = make_device_mesh(devices=CPU8)
    assert m.size == m.devices.size == 8 and m.shape == {"data": 8}
    assert m.world == 1 and m.group is None and len(m.local_devices) == 8
    m = make_device_mesh((2, -1), ("a", "b"), devices=CPU8)
    assert m.devices.shape == (2, 4) and m.shape == {"a": 2, "b": 4}
    assert len(m.axis_devices("a")) == 2 and len(m.axis_devices("b")) == 4
    assert make_device_mesh((4,), devices=CPU8).size == 4
    assert make_device_mesh(devices=["cpu"]).size == 1
    if not torch.cuda.is_available():
        assert make_device_mesh().local_devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="does not fit"):
        make_device_mesh((16,), devices=CPU8)
    with pytest.raises(ValueError, match="mixes device types"):
        make_device_mesh(devices=["cpu", "meta"])
    # a mesh of another device type than the reconstructor's
    with pytest.raises(ValueError, match="a mesh of meta devices"):
        Reconstructor(torch.nn.Linear(1, 1), Options(), device="cpu",
                      mesh=make_device_mesh(devices=["meta"]))
    # replicate: one object per device, shared where the device repeats;
    # a copy on another device drops the packed kernel layers of the
    # original's (they follow the weights)
    lin = torch.nn.Linear(2, 2)
    reps = replicate(m, lin)
    assert len(reps) == 8 and all(r is lin for r in reps)
    mlp = PointMLP((8, 16, 1), norm="group", device="cpu")
    mlp.packed()
    (other,) = replicate(make_device_mesh(devices=["meta"]), mlp)
    assert other is not mlp and not other._packed and mlp._packed
    assert next(other.parameters()).device.type == "meta"
    parts = shard_batch(make_device_mesh(devices=CPU8), torch.arange(16.0))
    assert [p.tolist() for p in parts[:2]] == [[0.0, 1.0], [2.0, 3.0]]
